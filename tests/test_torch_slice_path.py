"""PATH end to end against the JAX package (CPU): render_frame cached and
uncached in both fidelities over a band of rows with the compacted walk,
and the port's Renderer against the JAX package's Renderer at the golden
scene (batched frames, the path_stride tier, the uncached session and a
coarse drag), and the golden.

Frames agree to RTOL_FRAME: on these scenes no walk forks (every ray takes
the same roll sites and draws in both packages), and what remains is the
light term's exp (1.2e-7) and the prefix sums' order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_goldens import _check as check_golden
from test_goldens import scene as golden_scene
from test_path import _bigger_scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.engine.params import Fidelity as JFidelity
from volumerenderer_tpu.render import color as jcolor
from volumerenderer_tpu.render import path as jpath
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import path

RTOL_FRAME = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread in this module: under pytest-xdist every
    worker would otherwise start a thread per core, and PATH's many small
    parallel ops then wait on descheduled threads (a golden-scene session
    took 330 s with six such processes on 8 cores, 2 s with one thread
    each).  The results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cached", [False, True], ids=["inline", "cached"])
@pytest.mark.parametrize("fidelity", [JFidelity.REFERENCE,
                                      JFidelity.CORRECTED],
                         ids=["reference", "corrected"])
def test_render_frame_matches_jax(fidelity, cached):
    """Rows 8-19 of the 32x24 scene (row_start != 0), path_compact_min 64
    so the compacted walk re-derives seeds from the global row, march cell
    4 and the shadow LUT, frames 1 and 3."""
    g, p, c = _bigger_scene(path_compact_min=64, fidelity=fidelity)
    S = jcolor.required_march_steps(g, float(p.ray_marching_step_size),
                                    c.max_march_steps)
    tg, tp, tc = (convert.grid_from_numpy(g), convert.params_from_numpy(p),
                  port_config(c))
    kw = dict(row_start=8, num_rows=12, shadow_lut_radius=1, march_cell=4)
    jview = jpath.bake_path_view(g, p, c, S, row_start=8, num_rows=12,
                                 shadow_lut_radius=1) if cached else None
    tview = path.bake_path_view(tg, tp, tc, S, row_start=8, num_rows=12,
                                shadow_lut_radius=1) if cached else None
    for fc in (1, 3):
        want = np.asarray(jpath.render_frame(g, p, fc, c, S, cache=jview,
                                             **kw))
        got = path.render_frame(tg, tp, fc, tc, S, cache=tview, **kw).numpy()
        assert want.shape == got.shape == (12, 32) and want.max() > 0
        np.testing.assert_allclose(got, want, rtol=RTOL_FRAME, atol=0)


def _sessions(**cfg):
    g, p, c = golden_scene()
    c = dataclasses.replace(c, **cfg)
    rj = JRenderer(g, c, p, algorithm=JAlgorithm.PATH)
    rt = vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                     convert.params_from_numpy(p), algorithm=vt.Algorithm.PATH)
    return rj, rt


def _same_image(rj, rt):
    assert rt.state.frame_count == int(rj.state.frame_count)
    want = np.asarray(rj.state.accum)
    got = rt.state.accum.numpy()
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL_FRAME, atol=0)
    assert int(np.asarray(rt.lights.count).sum()) == int(rj.lights.count) == 0


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
def test_renderer_passes_golden(cached):
    """tests/goldens/path.npy through the port's Renderer, over the baked
    PathView and through the uncached step: windowed SSIM >= 0.995 and max
    abs error < 5e-3 (volumerenderer_tpu.utils.ssim)."""
    g, p, c = golden_scene()
    r = vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                    convert.params_from_numpy(p), algorithm=vt.Algorithm.PATH)
    r.use_view_cache = cached
    r.step(2)
    assert (r._path_view is not None) == cached
    img = r.state.accum.numpy()
    assert img.max() > 0
    check_golden("path", img)


@pytest.mark.parametrize("case", ["step2", "batch2", "stride2", "uncached"])
def test_renderer_matches_jax_renderer(case):
    """The golden scene: step(2); path_frame_batch 2 over step(3) (one
    batch, one single frame); path_stride 2 (the roll probability and step
    derived in f32 as the JAX package does); use_view_cache False."""
    cfg = dict(path_stride=2) if case == "stride2" else {}
    rj, rt = _sessions(**cfg)
    n = 2
    if case == "batch2":
        rj.path_frame_batch = rt.path_frame_batch = 2
        n = 3
    if case == "uncached":
        rj.use_view_cache = rt.use_view_cache = False
    rj.step(n)
    rt.step(n)
    _same_image(rj, rt)
    if case == "stride2":
        pj, _, sj = rj._path_effective(rj._max_steps)
        pt, _, st = rt._path_effective(rt._max_steps)
        assert st == sj
        assert pt.scattering_probability == float(pj.scattering_probability)
        assert pt.ray_marching_step_size == float(pj.ray_marching_step_size)
    assert (rt._path_view is None) == (case == "uncached")


def test_renderer_coarse_drag_matches_jax():
    """motion_mode "coarse": the first frame bakes; a camera edit renders
    one coarse drag frame (the uncached step at motion_stride x the step,
    LUT off, march cell re-derived) without re-baking; the next frame
    re-bakes at the settled camera."""
    rj, rt = _sessions(motion_mode="coarse")
    rj.step(1)
    rt.step(1)
    baked = rt._path_view
    for r in (rj, rt):
        r.set(camera_pos=(1.0, 20.0, -75.0) if r is rt
              else jnp.float32([1.0, 20.0, -75.0]))
    rj.step(1)
    rt.step(1)
    assert rt._path_view is baked and not rt.view_exact
    _same_image(rj, rt)
    rj.step(1)
    rt.step(1)
    assert rt._path_view is not baked and rt.view_exact
    _same_image(rj, rt)
