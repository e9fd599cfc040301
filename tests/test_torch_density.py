"""The port's density harness (the reference's CPU_test) against the JAX
package's render.density and the loop oracle (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import reference_impl as ref
from test_goldens import _check as check_golden
from test_goldens import scene
from volumerenderer_tpu.grid import from_dense
from volumerenderer_tpu.render import density as jdensity
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import density


def oracle_scene():
    """tests/test_density.py's scene: a 10^3 random volume straight ahead
    of the camera, at z ~ 25."""
    rs = np.random.RandomState(15)
    vals = rs.rand(10, 10, 10).astype(np.float32)
    return from_dense(vals, bbox_min=(-5, -3, 20))


KW = dict(width=12, height=12, camera_pos=(0.0, 0.0, -10.0), fov=45.0,
          t_max=50.0, dt=0.9)


@pytest.mark.parametrize("apply_transform", [False, True],
                         ids=["world_as_index", "transform"])
def test_render_density_matches_jax(apply_transform):
    """The reference's world-as-index quirk and the corrected transform
    (a voxel size of 1.5 and a translation make the two differ)."""
    g = oracle_scene()
    if apply_transform:
        g = from_dense(np.asarray(g.voxels)[:10, :10, :10],
                       bbox_min=(-5, -3, 20), voxel_size=1.5,
                       translation=(1.0, -2.0, -8.0))
    want = np.asarray(jdensity.render_density(
        g, apply_transform=apply_transform, **KW))
    got = density.render_density(convert.grid_from_numpy(g),
                                 apply_transform=apply_transform, **KW)
    assert got.dtype == torch.float32 and got.shape == (12, 12)
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_render_density_matches_oracle():
    """Against the loop oracle (t += dt in f32, where the harness takes
    t = k * dt): rtol 1e-5 as the oracle's own step order allows."""
    g = oracle_scene()
    want = ref.render_density(g, W=12, H=12, cam_pos=(0.0, 0.0, -10.0),
                              fov=45.0, t_max=50.0, dt=0.9)
    got = density.render_density(convert.grid_from_numpy(g), **KW).numpy()
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_to_grayscale_u8_matches_jax():
    rs = np.random.RandomState(5)
    d = np.concatenate([rs.uniform(0, 60, 500),
                        [0.0, 10.0, 50.0, 50.9, 51.0, 60.0, 1e6]]).astype(
        np.float32)
    want = np.asarray(jdensity.to_grayscale_u8(jnp.asarray(d)))
    got = density.to_grayscale_u8(torch.as_tensor(d))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        density.to_grayscale_u8(torch.tensor([[10.0, 60.0], [0.0, 100.0]])),
        [[50, 255], [0, 255]])


def test_density_golden():
    """The golden scene's density image against tests/goldens/density.npy
    (windowed SSIM >= 0.995, max abs < 5e-3), and against the JAX
    harness on the same grid."""
    g, _params, _config = scene()
    kw = dict(width=64, height=64, camera_pos=(0.0, 20.0, -75.0),
              t_max=200.0, dt=1.0, apply_transform=True)
    got = density.render_density(convert.grid_from_numpy(g), **kw).numpy()
    assert got.max() > 0
    check_golden("density", got)
    want = np.asarray(jdensity.render_density(g, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
