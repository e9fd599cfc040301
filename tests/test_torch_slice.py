"""The whole ported slice: the port's Renderer against the JAX package's
Renderer and the committed goldens, the UI semantics, and what is not
ported yet (CPU).  PATH's sessions against the JAX package's are in
test_torch_slice_path.py."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_goldens import _check as check_golden
from test_goldens import scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert


def port_renderer(g, p, c, algorithm, **kw):
    return vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                       convert.params_from_numpy(p),
                       algorithm=vt.Algorithm[algorithm.name], **kw)


@pytest.mark.parametrize("steps", [(2,), (8, 3)], ids=["single", "batch"])
@pytest.mark.parametrize("tier", ["exact", "paired"])
@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.SPHERE],
                         ids=["point", "sphere"])
def test_renderer_matches_jax_renderer(algorithm, tier, steps):
    """step(2) runs render_step_cached twice; step(8) then step(3) runs
    one compact-space batch then three single frames.  Images agree to
    5e-5 absolute (image max ~1): light positions differ by ~1e-5 world
    units (photon directions' acos/sin/cos ulps) and XLA:CPU contracts
    some multiply-adds that the port rounds separately."""
    g, p, c = scene()
    c = dataclasses.replace(c, gather_eval=tier)
    rj = JRenderer(g, dataclasses.replace(c, gather_impl="vpu_interpret"), p,
                   algorithm=algorithm)
    rt = port_renderer(g, p, c, algorithm)
    for n in steps:
        rj.step(n)
        rt.step(n)
    assert rt.state.frame_count == int(rj.state.frame_count) == sum(steps)
    got, want = rt.image(), np.asarray(rj.image())
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(rt.image_u8().shape, rj.image_u8().shape)


@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.SPHERE,
                                       JAlgorithm.RAY, JAlgorithm.BEAM],
                         ids=["point", "sphere", "ray", "beam"])
def test_renderer_passes_goldens(algorithm):
    """The port's frames pass the committed goldens: windowed SSIM >= 0.995
    and max abs error < 5e-3, scored by volumerenderer_tpu.utils.ssim.
    PATH's are in test_torch_slice_path.py."""
    g, p, c = scene()
    r = port_renderer(g, p, c, algorithm)
    r.step(2)
    img = r.state.accum.numpy()
    assert img.max() > 0
    check_golden(algorithm.name.lower(), img)


def test_port_ssim_copy_matches_reference_scorer():
    from volumerenderer_tpu.utils.ssim import ssim as ref_ssim
    from volumerenderer_tpu_torch.utils.ssim import ssim

    rs = np.random.RandomState(0)
    a = rs.rand(40, 30)
    b = np.clip(a + rs.randn(40, 30) * 0.05, 0, 1)
    assert ssim(a, b) == ref_ssim(a, b)


@pytest.fixture()
def small():
    """A small port renderer (the JAX suite's small_renderer scene)."""
    from volumerenderer_tpu_torch.grid import procedural

    g = procedural.fog_sphere(n=24, center_world=(0.0, 0.0, 10.0),
                              world_extent=20.0, device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -15.0), light_source_world_pos=(0.0, 0.0, 10.0),
        scattering_probability=0.4, ray_max_distance=60.0, max_lights=64)
    config = vt.StaticConfig(width=16, height=12, light_capacity=64,
                             max_events_per_photon=8, probe_tile=64,
                             build_tile=64)
    return vt.Renderer(g, config, params, algorithm=vt.Algorithm.POINT)


def test_set_algorithm_resets_and_set_does_not(small):
    r = small
    r.step(3)
    assert r.state.frame_count == 3
    r.set(absorption_coefficient=0.1)  # slider: no reset
    assert r.state.frame_count == 3
    r.step(1)
    assert r.state.frame_count == 4
    r.set_algorithm(vt.Algorithm.POINT)  # same algorithm: no reset
    assert r.state.frame_count == 4
    r.set_algorithm(vt.Algorithm.SPHERE)
    assert r.state.frame_count == 0
    r.step(1)
    assert r.state.frame_count == 1
    assert r.image().max() > 0


def test_refresh_and_resize_reset(small):
    r = small
    r.step(2)
    first = r.image().copy()
    r.step(2)
    r.refresh()
    assert r.state.frame_count == 0
    r.step(2)
    # Frame 1 of a fresh accumulation clears: the image restarts.
    np.testing.assert_array_equal(r.image(), first)
    r.resize(20, 10)
    assert r.state.frame_count == 0 and r.state.accum.shape == (10, 20)
    r.step(1)
    assert r.image().shape == (10, 20, 3) and r.image().max() > 0
    assert r.image_u8().dtype == np.uint8


def test_camera_edit_rebuilds_view_light_edit_does_not(small):
    r = small
    r.step(1)
    view = r._view
    r.set(photon_initial_intensity=50.0)
    r.step(1)
    assert r._view is view
    r.set(camera_pos=(0.0, 1.0, -15.0))
    r.step(1)
    assert r._view is not view and r.view_exact


@pytest.mark.parametrize("name", ["PATH"])
def test_unported_algorithms_raise(small, name):
    """Algorithms not ported yet raise naming their ROADMAP item.  PATH
    raised until it was ported: it now constructs, switches in and
    renders, and no algorithm is left unported."""
    from volumerenderer_tpu_torch.engine.params import UNPORTED_ALGORITHMS

    assert UNPORTED_ALGORITHMS == {}
    algo = vt.Algorithm[name]
    small.step(1)
    small.set_algorithm(algo)
    assert small.state.frame_count == 0
    small.step(2)
    img = small.image()
    assert np.isfinite(img).all() and img.max() > 0
    assert small.lights.count.tolist() == [0]
    r = vt.Renderer(small.grid, small.config, algorithm=algo)
    r.step(1)
    assert r.state.frame_count == 1 and np.isfinite(r.image()).all()


@pytest.mark.parametrize("field,value", [
    ("compact_build", "host"), ("interpolation", "trilinear"),
    ("accum_dtype", "uint8"), ("gather_samples", 16),
    ("segment_mode", "discrete_expanded"),
])
def test_unported_config_values_raise(small, field, value):
    """Values not ported yet raise naming their ROADMAP item.
    segment_mode="discrete_expanded" at the default 16,384 slots raised
    until the many-light gather was ported: it now constructs and renders."""
    if (field, value) == ("segment_mode", "discrete_expanded"):
        config = dataclasses.replace(small.config, segment_mode=value)
        assert config.expanded_light_capacity == 16384
        r = vt.Renderer(small.grid, config, small.params,
                        algorithm=vt.Algorithm.RAY)
        r.step(2)
        img = r.image()
        assert np.isfinite(img).all() and img.max() > 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.StaticConfig(**{field: value})


def test_default_renderer_renders_ray(small):
    """Renderer(grid) takes the package defaults: Algorithm.RAY, discrete
    segments; at a small size it renders a nonzero finite image."""
    r = vt.Renderer(small.grid)
    assert r.algorithm is vt.Algorithm.RAY
    assert r.config.segment_mode == "discrete"
    r.resize(16, 12)
    r.set(**{f: getattr(small.params, f) for f in (
        "camera_pos", "light_source_world_pos", "scattering_probability",
        "ray_max_distance")})
    r.step(2)
    img = r.image()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert img.max() > 0


def test_view_over_budget_raises(small):
    small.device_view_budget_bytes = 1024
    with pytest.raises(NotImplementedError, match="host-banded"):
        small.step(1)


def test_cuda_device_requires_cuda(small):
    """An explicit CUDA device either runs on the card or raises; it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        r = vt.Renderer(small.grid, small.config, small.params,
                        algorithm=vt.Algorithm.POINT, device="cuda")
        assert r.grid.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            vt.Renderer(small.grid, small.config, small.params,
                        algorithm=vt.Algorithm.POINT, device="cuda")


@pytest.mark.parametrize("build", ["cloud", "fog_sphere", "from_dense"])
def test_default_device_is_the_card(build):
    """The grid constructors, and through them Renderer(grid), default to
    the GPU: without CUDA they raise naming the device argument instead of
    building on the CPU; device="cpu" opts out."""
    from volumerenderer_tpu_torch.grid import dense, procedural

    fn = {"cloud": lambda **kw: procedural.cloud(n=16, **kw),
          "fog_sphere": lambda **kw: procedural.fog_sphere(n=16, **kw),
          "from_dense": lambda **kw: dense.from_dense(
              np.ones((8, 8, 8), np.float32), **kw)}[build]
    if torch.cuda.is_available():
        g = fn()
        assert g.device.type == "cuda"
        assert vt.Renderer(g).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            fn()
    g = fn(device="cpu")
    assert g.device.type == "cpu" and vt.Renderer(g).device.type == "cpu"


def test_import_port_leaves_jax_out():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, volumerenderer_tpu_torch, "
            "volumerenderer_tpu_torch.convert, "
            "volumerenderer_tpu_torch.utils.ssim; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'volumerenderer_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
