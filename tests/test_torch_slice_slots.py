"""The uncached slots path through the port (CPU): build_view, shade_view
and render_frame against the JAX package on carried-across inputs, the
Renderer with compact_view=False, use_view_cache=False and
first_frame_uncached against the JAX Renderer, uncached against cached in
the port alone, and the goldens through the slots view."""

import dataclasses

import numpy as np
import pytest

from test_goldens import _check as check_golden
from test_goldens import scene
from test_torch_gather_segments import MARGIN, far_weights, segment_distance
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.engine.step import build_view_step as jbuild_view
from volumerenderer_tpu.render import color as jcolor
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.engine.step import build_view_step
from volumerenderer_tpu_torch.render import color as tcolor

# (algorithm, segment_mode, segment_eval, beam quadrature rule)
RUNS = [
    (JAlgorithm.POINT, "discrete", "exact", "midpoint"),
    (JAlgorithm.SPHERE, "discrete", "exact", "midpoint"),
    (JAlgorithm.RAY, "discrete", "exact", "midpoint"),
    (JAlgorithm.RAY, "analytic", "paired", "midpoint"),
    (JAlgorithm.BEAM, "discrete", "exact", "midpoint"),
    (JAlgorithm.BEAM, "analytic", "paired", "closed"),
]
IDS = ["point", "sphere", "ray", "ray-analytic", "beam", "beam-closed"]
# Whole frames against the JAX Renderer, absolute (image max 1): the photon
# walk's light positions differ by up to ~1e-4 world units between the
# packages (test_torch_slice_segments.py); Beam's 1/(d-r)^2 amplifies that
# near a beam's surface.
FRAME_ATOL = {JAlgorithm.BEAM: 7e-4}


def small(algorithm, mode="discrete", tier="exact", rule="midpoint",
          size=32, **cfg):
    g, p, c = scene()
    c = dataclasses.replace(c, width=size, height=size, segment_mode=mode,
                            segment_eval=tier, beam_quadrature_rule=rule,
                            **cfg)
    return g, p, c


def jax_renderer(g, p, c, algorithm):
    return JRenderer(g, dataclasses.replace(c, gather_impl="vpu_interpret"),
                     p, algorithm=algorithm)


def port_renderer(g, p, c, algorithm):
    return vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                       convert.params_from_numpy(p),
                       algorithm=vt.Algorithm[algorithm.name])


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "full"])
def test_build_view_matches_jax(clip):
    """Slots planes (R, C): weights rtol 1e-6 (the transmittance cumprod
    associates differently), positions within 4e-5 world units where
    either weight is nonzero: XLA:CPU contracts o + d*t into an FMA where
    the port rounds d*t first, and the sum cancels (the camera sits ~40
    voxels outside the volume, d*t reaches ~100 voxels of 1.46 world
    units), so a position moves by a few ulps of d*t (measured 3.05e-5).
    The JAX build pads rows to its ray tile with zero weight."""
    rj = jax_renderer(*small(JAlgorithm.POINT), JAlgorithm.POINT)
    box, view_steps = rj._occupied_clip() if clip else (None, 10**9)
    steps = min(rj._max_steps, view_steps)
    vj = jbuild_view(rj.grid, rj.params, box, config=rj.config,
                     max_steps=steps)
    vt_ = build_view_step(convert.grid_from_numpy(rj.grid),
                          convert.params_from_numpy(rj.params), box,
                          config=port_config(rj.config), max_steps=steps)
    assert isinstance(vt_, tcolor.ViewCache)
    assert (vt_.n_rays, vt_.rows) == (vj.n_rays, vj.rows) == (32 * 32, 32)
    n = vt_.n_rays
    assert vt_.wx.shape == (n, np.asarray(vj.wx).shape[1])
    assert not np.asarray(vj.weight)[n:].any()
    wj = np.asarray(vj.weight)[:n]
    np.testing.assert_allclose(vt_.weight.numpy(), wj, rtol=1e-6, atol=0)
    live = (wj != 0) | (vt_.weight.numpy() != 0)
    assert live.sum() > 1000
    for name in ("wx", "wy", "wz"):
        np.testing.assert_allclose(getattr(vt_, name).numpy()[live],
                                   np.asarray(getattr(vj, name))[:n][live],
                                   rtol=0, atol=4e-5)


def _far_view(vj, lights, algorithm, radius):
    """The JAX ViewCache with the weights of samples within MARGIN of a
    guard surface of this frame's segments zeroed (as
    test_torch_shading_segments.py does: there XLA:CPU's contracted sub-light positions move a 1/(d-r)^2
    term by more than the kernels' bound), for JAX and for the port."""
    planes = [np.asarray(getattr(vj, n)) for n in ("wx", "wy", "wz")]
    w = np.asarray(vj.weight)
    if algorithm in (JAlgorithm.RAY, JAlgorithm.BEAM):
        valid = np.asarray(lights.valid)
        dist = segment_distance(*planes, np.asarray(lights.pos_from),
                                np.asarray(lights.pos_to), valid)
        w = far_weights(w, dist, radius if algorithm is JAlgorithm.BEAM
                        else None, MARGIN)
    fields = dict(wx=planes[0], wy=planes[1], wz=planes[2], weight=w,
                  n_rays=vj.n_rays, rows=vj.rows)
    return jcolor.ViewCache(**fields), convert.view_cache_from_numpy(fields)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_shade_view_and_render_frame_match_jax(run):
    """The JAX package's own ViewCache and lights, carried across: the
    port's shade_view within 2e-5 relative per pixel of the JAX shade_view
    away from guard surfaces (the same terms; only XLA:CPU's contracted
    multiply-adds and the order of the sums differ); render_frame (the
    port's own march) within 2e-5 absolute of the JAX frame, Beam 1e-4
    (near-surface samples, measured 4.6e-5)."""
    algorithm, mode, tier, rule = run
    g, p, c = small(algorithm, mode, tier, rule)
    rj = jax_renderer(g, p, c, algorithm)
    rj.step(1)
    cj = rj.config
    steps = rj._max_steps
    vj = jbuild_view(rj.grid, rj.params, None, config=cj, max_steps=steps)
    gt, pt, ct = (convert.grid_from_numpy(g), convert.params_from_numpy(p),
                  port_config(c))
    lights = convert.lights_from_numpy(rj.lights)
    ta = vt.Algorithm[algorithm.name]
    far_j, far_t = _far_view(vj, rj.lights, algorithm, float(p.beam_radius))
    want = np.asarray(jcolor.shade_view(rj.grid, far_j, rj.params,
                                        rj.lights, algorithm, cj))
    got = tcolor.shade_view(gt, far_t, pt, lights, ta, ct).numpy()
    assert got.shape == (32, 32) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    frame = tcolor.render_frame(gt, pt, lights, ta, ct, steps).numpy()
    want = np.asarray(jcolor.shade_view(rj.grid, vj, rj.params, rj.lights,
                                        algorithm, cj))
    np.testing.assert_allclose(
        frame, want, rtol=0,
        atol=1e-4 if algorithm is JAlgorithm.BEAM else 2e-5)


@pytest.mark.parametrize("run", RUNS, ids=IDS)
def test_renderer_slots_view_matches_jax(run):
    """compact_view=False: the slots ViewCache baked once and shaded every
    frame; step(2) then, with a frame batch of 3, step(3) (one batched
    walk).  Within 1e-5 absolute of the JAX Renderer (Beam 7e-4)."""
    algorithm, mode, tier, rule = run
    g, p, c = small(algorithm, mode, tier, rule, compact_view=False)
    rj = jax_renderer(g, p, c, algorithm)
    rt = port_renderer(g, p, c, algorithm)
    rj.frame_batch = rt.frame_batch = 3
    for n in (2, 3):
        rj.step(n)
        rt.step(n)
    assert isinstance(rt._view, tcolor.ViewCache) and rt.view_exact
    assert rt.state.frame_count == int(rj.state.frame_count) == 5
    got, want = rt.image(), np.asarray(rj.image())
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FRAME_ATOL.get(algorithm, 1e-5))


@pytest.mark.parametrize("mode", ["no_view_cache", "first_frame"])
@pytest.mark.parametrize("run", [RUNS[0], RUNS[2], RUNS[5]],
                         ids=["point", "ray", "beam-closed"])
def test_renderer_uncached_steps_match_jax(run, mode):
    """use_view_cache=False marches every frame (the uncached step);
    first_frame_uncached presents frame 1 through it, then builds the
    compact view.  Against the JAX Renderer frame by frame."""
    algorithm, smode, tier, rule = run
    g, p, c = small(algorithm, smode, tier, rule)
    rj = jax_renderer(g, p, c, algorithm)
    rt = port_renderer(g, p, c, algorithm)
    for r in (rj, rt):
        if mode == "no_view_cache":
            r.use_view_cache = False
        else:
            r.first_frame_uncached = True
    atol = FRAME_ATOL.get(algorithm, 1e-5)
    for i in range(2):
        rj.step(1)
        rt.step(1)
        if mode == "first_frame":
            assert rt._ttff_done and (rt._view is None) == (i == 0)
        np.testing.assert_allclose(rt.image(), np.asarray(rj.image()),
                                   rtol=0, atol=atol)
    if mode == "no_view_cache":
        assert rt._view is None


@pytest.mark.parametrize("run", [RUNS[0], RUNS[3], RUNS[4]],
                         ids=["point", "ray-analytic", "beam"])
def test_port_uncached_matches_cached(run):
    """In the port alone, the slots view and the compact view give the same
    frames to rtol 1e-5, atol 1e-7: the same march and lights; the slots
    path sums each ray's samples in PyTorch, the lane path in the kernel."""
    algorithm, mode, tier, rule = run
    g, p, c = small(algorithm, mode, tier, rule)
    cached = port_renderer(g, p, c, algorithm)
    slots = port_renderer(g, p, dataclasses.replace(c, compact_view=False),
                          algorithm)
    for r in (cached, slots):
        r.step(2)
    np.testing.assert_allclose(slots.state.accum.numpy(),
                               cached.state.accum.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.SPHERE,
                                       JAlgorithm.RAY, JAlgorithm.BEAM],
                         ids=["point", "sphere", "ray", "beam"])
def test_slots_view_passes_goldens(algorithm):
    """compact_view=False frames pass the committed goldens (windowed SSIM
    >= 0.995, max abs error < 5e-3)."""
    g, p, c = scene()
    r = port_renderer(g, p, dataclasses.replace(c, compact_view=False),
                      algorithm)
    r.step(2)
    assert isinstance(r._view, tcolor.ViewCache)
    check_golden(algorithm.name.lower(), r.state.accum.numpy())


def test_compact_view_from_numpy_round_trip():
    """A JAX CompactView carried across shades like the port's own build
    of the same view (identical bands, index maps and need)."""
    g, p, c = small(JAlgorithm.POINT)
    rj = jax_renderer(g, p, c, JAlgorithm.POINT)
    rj.step(1)
    cv = convert.compact_view_from_numpy(rj._view)
    assert (cv.n_rays, cv.rows) == (rj._view.n_rays, rj._view.rows)
    for bt, bj in zip(cv.bands, rj._view.bands):
        np.testing.assert_array_equal(bt.weight.numpy(),
                                      np.asarray(bj.weight))
        np.testing.assert_array_equal(bt.lane_need.numpy(),
                                      np.asarray(bj.lane_need))
    lights = convert.lights_from_numpy(rj.lights)
    got = tcolor.shade_view(convert.grid_from_numpy(g), cv,
                            convert.params_from_numpy(p), lights,
                            vt.Algorithm.POINT, port_config(c)).numpy()
    np.testing.assert_allclose(got, np.asarray(rj.state.accum), rtol=2e-5,
                               atol=1e-7)
