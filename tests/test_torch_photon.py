"""The port's photon walk (generate_lights) against the JAX package at the
golden scene, one frame at a time and as one 8-frame batch (CPU)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from test_goldens import scene
from volumerenderer_tpu.render import photon as jphoton
from volumerenderer_tpu.render.color import required_march_steps
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.engine.params import StaticConfig
from volumerenderer_tpu_torch.render import photon as tphoton
from volumerenderer_tpu_torch.utils import profiling


def port_config(config):
    """The port's StaticConfig with the JAX config's values for its fields."""
    names = {f.name for f in dataclasses.fields(StaticConfig)}
    return StaticConfig(**{f.name: getattr(config, f.name)
                           for f in dataclasses.fields(config)
                           if f.name in names})


@pytest.fixture(scope="module")
def golden():
    g, p, c = scene()
    ms = required_march_steps(g, 1.0, c.max_march_steps)
    return (g, p, c, ms, convert.grid_from_numpy(g),
            convert.params_from_numpy(p), port_config(c))


def _check(la, lt, i, fc):
    """Frame ``i`` of the port's batch against the JAX lights of frame fc.

    count/valid/truncated equal.  Photon directions come from acos/sin/cos,
    which differ by ~1-2 ulp between XLA:CPU and PyTorch; along a walk of
    tens of voxels that moves scatter points by <= 1e-4 world units (the
    volume spans 70) and intensities by <= 2e-6 relative."""
    n = int(la.count)
    assert int(lt.count[i]) == n > 0, fc
    np.testing.assert_array_equal(lt.valid[i].numpy(), np.asarray(la.valid))
    assert bool(lt.truncated[i]) == bool(la.truncated)
    for name in ("pos_from", "pos_to"):
        np.testing.assert_allclose(getattr(lt, name)[i].numpy()[:n],
                                   np.asarray(getattr(la, name))[:n],
                                   rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(lt.intensity[i].numpy()[:n],
                               np.asarray(la.intensity)[:n], rtol=2e-6)


@pytest.mark.parametrize("fc", [1, 2, 3])
def test_generate_lights_single_frame(golden, fc):
    g, p, c, ms, tg, tp, tc = golden
    la = jax.jit(lambda f: jphoton.generate_lights(g, p, f, c, max_steps=ms))(
        jnp.int32(fc))
    lt = tphoton.generate_lights(tg, tp, [fc], tc, max_steps=ms)
    _check(la, lt, 0, fc)


def test_generate_lights_frame_batch(golden):
    """8 frames walk as one batch of 8 x 16 photons, equal to the JAX
    package's vmap over frames."""
    g, p, c, ms, tg, tp, tc = golden
    fcs = np.arange(5, 13, dtype=np.int32)
    lab = jax.jit(jax.vmap(
        lambda f: jphoton.generate_lights(g, p, f, c, max_steps=ms)))(fcs)
    walk = ("sync", "photon.walk")
    before = profiling.totals().get(walk, 0)
    lt = tphoton.generate_lights(tg, tp, fcs.tolist(), tc, max_steps=ms)
    assert profiling.totals()[walk] > before
    for i, fc in enumerate(fcs):
        _check(jax.tree.map(lambda x: x[i], lab), lt, i, fc)
