"""The host-banded compact build and top-k compaction (``gather_samples``)
of the port against the JAX package's (CPU).

Layouts are held equal: band count, each band's cap (its plane width),
``lane_need``, ``inv_map`` and ``src``.  Planes are held at the port's
view-build tolerances (tests/test_torch_view.py): weights rtol 1e-6 (the
transmittance cumprod associates differently), world positions 1e-5
(XLA:CPU contracts o + d*t into a multiply-add; the port rounds d*t
first).  Whole frames against the JAX Renderer are held at the port's
frame tolerances (tests/test_torch_slice.py, test_torch_slice_segments.py:
the photon walk's light positions differ by ulps of acos/sin/cos, and
Beam's 1/(d-r)^2 amplifies them near a beam's surface).  Within the port,
the host build against the device build and the slots view is held at the
JAX package's own bound, rtol 1e-5 and atol 1e-7
(tests/test_engine.py:204-228)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import small_renderer
from test_goldens import scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.engine.step import band_from_planes_step
from volumerenderer_tpu.engine.step import build_view_step as jbuild_view
from volumerenderer_tpu.render import color as jcolor
from volumerenderer_tpu.render import photon as jphoton
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.ops.kernels import march_planes as tmarch
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.utils import profiling

ALGOS = [JAlgorithm.POINT, JAlgorithm.SPHERE, JAlgorithm.RAY, JAlgorithm.BEAM]
FRAME_ATOL = {JAlgorithm.POINT: 5e-5, JAlgorithm.SPHERE: 5e-5,
              JAlgorithm.RAY: 2e-5, JAlgorithm.BEAM: 1e-3}
GS = 24  # below the golden scene's widest caps (64), above many rays' need


def syncs_since(before: dict, site: str) -> int:
    """The port's "sync" counts at ``site`` since ``profiling.totals()``
    read ``before``."""
    key = ("sync", site)
    return profiling.totals().get(key, 0) - before.get(key, 0)


def golden_pair(algorithm, mode="host", gather_samples=0, **config):
    """The golden scene (64x64) in both packages with one-lane-tile bands:
    the host-banded build makes 4 bands there (3 of hit rays)."""
    g, p, c = scene()
    c = dataclasses.replace(c, gather_impl="vpu_interpret",
                            compact_build=mode,
                            gather_samples=gather_samples, **config)
    rj = JRenderer(g, c, p, algorithm=algorithm)
    rt = vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                     convert.params_from_numpy(p),
                     algorithm=vt.Algorithm[algorithm.name])
    for r in (rj, rt):
        r.view_build_budget_bytes = 1
        if mode == "auto":
            r.device_view_budget_bytes = 1
    return rj, rt


def assert_views_match(vt_, vj):
    assert (vt_.n_rays, vt_.rows) == (vj.n_rays, vj.rows)
    np.testing.assert_array_equal(vt_.inv_map.numpy(), np.asarray(vj.inv_map))
    np.testing.assert_array_equal(vt_.src.numpy(), np.asarray(vj.src))
    assert len(vt_.bands) == len(vj.bands) == len(vt_.caps)
    for bt, bj, cap in zip(vt_.bands, vj.bands, vt_.caps):
        assert tuple(bt.wx.shape) == tuple(bj.wx.shape)
        assert bt.wx.shape[0] >= min(cap, 8)
        need = bt.lane_need.numpy()
        np.testing.assert_array_equal(need, np.asarray(bj.lane_need))
        use = np.arange(bt.wx.shape[0])[:, None] < need[None, :]
        for name in ("wx", "wy", "wz", "weight"):
            got = np.where(use, getattr(bt, name).numpy(), 0.0)
            want = np.where(use, np.asarray(getattr(bj, name)), 0.0)
            if name == "weight":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=name)


@pytest.mark.parametrize("gather_samples", [0, GS], ids=["all", "topk"])
@pytest.mark.parametrize("mode", ["host", "auto"],
                         ids=["host", "auto_over_budget"])
def test_host_view_matches_jax(mode, gather_samples):
    """compact_build="host", and "auto" over a lowered device budget: the
    same bands, caps, lane needs, lane order and inverse map as the JAX
    host build, planes within the view-build tolerances; with top-k the
    view is inexact in both."""
    rj, rt = golden_pair(JAlgorithm.POINT, mode, gather_samples)
    steps = rj._max_steps
    assert not tcolor.device_build_ok(
        rt.config, min(steps, rt._occupied_clip()[1]), rt._march_cell(),
        rt.device_view_budget_bytes)
    vj = rj._current_view(steps)
    before = profiling.totals()
    vt_ = rt._current_view(rt._max_steps)
    assert isinstance(vj, jcolor.CompactView)
    assert len(vt_.bands) >= 3
    assert rt.view_exact == bool(rj.view_exact) == (gather_samples == 0)
    assert syncs_since(before, "color.build") == 1
    assert_views_match(vt_, vj)
    if gather_samples:
        assert all(b.wx.shape[0] <= GS for b in vt_.bands)


@pytest.mark.parametrize("gather_samples", [0, GS], ids=["all", "topk"])
@pytest.mark.parametrize("algorithm", ALGOS,
                         ids=[a.name.lower() for a in ALGOS])
def test_host_build_frames_match_jax(algorithm, gather_samples):
    """step(3) through the host-banded build in both packages."""
    rj, rt = golden_pair(algorithm, "host", gather_samples)
    rj.step(3)
    rt.step(3)
    assert len(rt._view.bands) >= 3
    assert rt.state.frame_count == int(rj.state.frame_count) == 3
    got, want = rt.image(), np.asarray(rj.image())
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FRAME_ATOL[algorithm])


@pytest.mark.parametrize("algorithm", ALGOS,
                         ids=[a.name.lower() for a in ALGOS])
def test_host_build_matches_device_build(algorithm):
    """Within the port: the host-banded build, the device build and the
    slots view render the same frames (the JAX package's own bound)."""
    g, p, c = (lambda r: (r.grid, r.params, r.config))(
        small_renderer(algorithm=algorithm))
    grid, params = convert.grid_from_numpy(g), convert.params_from_numpy(p)
    images = {}
    for name, fields in (("device", dict(compact_build="device")),
                         ("host", dict(compact_build="host")),
                         ("slots", dict(compact_view=False))):
        r = vt.Renderer(grid, port_config(dataclasses.replace(c, **fields)),
                        params, algorithm=vt.Algorithm[algorithm.name])
        before = profiling.totals()
        r.step(3)
        assert r.view_exact
        if name == "host":
            assert r._view.caps and syncs_since(before, "color.build") == 1
        images[name] = r.image()
    assert images["device"].max() > 0
    for name in ("host", "slots"):
        np.testing.assert_allclose(images[name], images["device"],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    r = vt.Renderer(grid, port_config(c), params)
    assert r.config.compact_build == "auto"
    assert tcolor.device_build_ok(r.config, r._max_steps, r._march_cell(),
                                  r.device_view_budget_bytes)


@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.RAY],
                         ids=["point", "ray"])
def test_slots_view_top_k_matches_jax(algorithm):
    """compact_view=False with the config's gather_samples: the top-k
    ViewCache, inexact in both packages; frames after step(3), at
    32x32 as the slots tests take them (at 64x64 one ray's camera ray
    differs by an ulp between the packages and fetches the next voxel at
    a boundary, which top-k turns into another kept sample)."""
    g, p, c = scene()
    c = dataclasses.replace(c, width=32, height=32,
                            gather_impl="vpu_interpret", compact_view=False,
                            gather_samples=GS)
    rj = JRenderer(g, c, p, algorithm=algorithm)
    grid, params = convert.grid_from_numpy(g), convert.params_from_numpy(p)
    rt = vt.Renderer(grid, port_config(c), params,
                     algorithm=vt.Algorithm[algorithm.name])
    rj.step(3)
    rt.step(3)
    assert not rt.view_exact and not rj.view_exact
    assert rt._view.weight.shape[1] == GS
    got, want = rt.image(), np.asarray(rj.image())
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FRAME_ATOL[algorithm])
    # The view key holds gather_samples: without it the view is exact.
    key = rt._view_key
    rt = vt.Renderer(grid, port_config(dataclasses.replace(
        c, gather_samples=0)), params, algorithm=vt.Algorithm[algorithm.name])
    rt.step(1)
    assert rt._view_key != key and rt.view_exact
    assert rt._view.weight.shape[1] > GS


def test_top_k_order_matches_jax():
    """Equal weights keep ascending sample order, as jax.lax.top_k gives
    them: rows of many zeros and repeated values pick the same samples in
    the same order."""
    rs = np.random.RandomState(3)
    w = rs.choice([0.0, 0.0, 0.0, 0.25, 0.5, 1.0], size=(64, 40))
    w[:8] = 0.0  # all-zero rays
    w[8:16, :37] = 0.0  # rays shorter than k
    w = w.astype(np.float32)
    t = np.cumsum(rs.rand(64, 40), axis=1).astype(np.float32)
    for k in (1, 5, 12, 40):
        wj, idx = jax.lax.top_k(jnp.asarray(w), k)
        tj = np.take_along_axis(t, np.asarray(idx), axis=1)
        wt, tt = tmarch.top_k_samples(torch.as_tensor(w), torch.as_tensor(t),
                                      k)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(tt.numpy(), tj)


@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.RAY,
                                       JAlgorithm.BEAM],
                         ids=["point", "ray", "beam"])
def test_render_frame_top_k_matches_jax(algorithm):
    """render_frame(gather_samples=...) on the JAX package's lights: the
    top-k ViewCache planes in every column (the zero weights of rays
    shorter than k included, which sit at their lowest march indices), at
    the slots planes' tolerances of tests/test_torch_slice_slots.py
    (positions 4e-5: a few ulps of d*t), and the frame at its
    uncached-frame tolerances."""
    g, p, c = scene()
    c = dataclasses.replace(c, width=32, height=32,
                            gather_impl="vpu_interpret")
    rj = JRenderer(g, c, p, algorithm=algorithm)
    steps = rj._max_steps
    lights = jphoton.generate_lights(rj.grid, rj.params, jnp.asarray(1), c,
                                     max_steps=steps)
    vj = jbuild_view(rj.grid, rj.params, None, config=c, max_steps=steps,
                     gather_samples=GS)
    gt, pt, ct = (convert.grid_from_numpy(g), convert.params_from_numpy(p),
                  port_config(c))
    vt_ = tcolor.build_view(gt, pt, ct, steps, gather_samples=GS)
    n = vt_.n_rays
    wj = np.asarray(vj.weight)[:n]
    assert vt_.weight.shape == (n, GS)
    short = ((wj != 0).sum(axis=1) < GS) & ((wj != 0).sum(axis=1) > 0)
    assert short.sum() > 10  # rays whose top-k holds tied zeros
    np.testing.assert_allclose(vt_.weight.numpy(), wj, rtol=1e-6, atol=0)
    for name in ("wx", "wy", "wz"):
        np.testing.assert_allclose(getattr(vt_, name).numpy(),
                                   np.asarray(getattr(vj, name))[:n],
                                   rtol=0, atol=4e-5, err_msg=name)
    ta = vt.Algorithm[algorithm.name]
    frame = tcolor.render_frame(gt, pt, convert.lights_from_numpy(lights),
                                ta, ct, steps, gather_samples=GS).numpy()
    want = np.asarray(jcolor.render_frame(rj.grid, rj.params, lights,
                                          algorithm, c, steps,
                                          gather_samples=GS))
    assert frame.max() > 0
    np.testing.assert_allclose(
        frame, want, rtol=0,
        atol=1e-4 if algorithm is JAlgorithm.BEAM else 2e-5)


@pytest.mark.parametrize("C", [13, 24, 40])
def test_band_from_planes_matches_jax(C):
    """(N, C) planes to a lane band: padded to a multiple of 8, lane_need
    from the weights (the port takes the planes lane-major)."""
    rs = np.random.RandomState(C)
    N = 96
    planes = [rs.randn(N, C).astype(np.float32) for _ in range(3)]
    w = (rs.rand(N, C) * (rs.rand(N, C) < 0.4)).astype(np.float32)
    w[:10] = 0.0
    bj = band_from_planes_step(*[jnp.asarray(a) for a in (*planes, w)])
    bt = tcolor.band_from_planes(*[torch.as_tensor(a.T.copy())
                                   for a in (*planes, w)])
    assert bt.wx.shape[0] % 8 == 0
    for name in ("wx", "wy", "wz", "weight", "lane_need"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)),
                                      err_msg=name)


@pytest.mark.parametrize("path", ["host", "device", "truncated", "settle"])
def test_builds_take_the_cached_clip_tensors(monkeypatch, path):
    """Every march and occupancy pass of a view build gets the clip box as
    the tensors the session copied to its device once per grid: no build
    and no band copies it again (on the card each such copy waits for the
    stream).  The host-banded and device builds, the truncated drag's
    identity-order build and the settle's row chunks."""
    from volumerenderer_tpu_torch.ops import march as march_ops

    seen = []
    for name in ("march", "occupancy_counts"):
        fn = getattr(march_ops, name)

        def spy(*a, _fn=fn, **kw):
            seen.append(kw.get("clip_box"))
            return _fn(*a, **kw)

        monkeypatch.setattr(march_ops, name, spy)
    g = vt.grid.procedural.cloud(n=32, device="cpu")
    fields = {"host": dict(compact_build="host"), "device": {},
              "truncated": dict(motion_mode="truncated"),
              "settle": dict(motion_mode="coarse", settle_chunks=2)}[path]
    r = vt.Renderer(g, vt.StaticConfig(width=32, height=32, **fields))
    r.step(1)
    if path in ("truncated", "settle"):
        r.set(camera_pos=(1.0, 20.0, -75.0))
        r.step(1)  # a drag frame
        if path == "settle":
            r.step(1)  # the two row chunks, one a tick
            r.step(1)
    clip = r._occupied_clip()[0]
    assert clip is r._occ_clip and clip[0].dtype == torch.float32
    used = [c for c in seen if c is not None]
    assert used and all(c[0] is clip[0] and c[1] is clip[1] for c in used)
    assert r.host_syncs >= 1
    if path == "host":
        assert r._view.caps
    if path == "settle":
        assert r.view_exact and len(r._view.bands) >= 2
