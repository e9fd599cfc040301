"""The slice options of the port against the JAX package (CPU):
``StaticConfig(interpolation="trilinear")`` (8-tap fetches; every build
marches every ray at the full step budget, with no occupancy count or cap)
and ``StaticConfig(accum_dtype="uint8")`` (each frame's average quantized
to the reference's rgba8 image).

Tolerances: the trilinear fetch itself at rtol 1e-6, atol 1e-7 (it reads
the same voxels with the same weight products in the same order); the
march's ``t``, ``trans`` and ``weight`` at rtol 2e-5 (the transmittance
cumprod associates differently); view weights at rtol 2e-5, atol 1e-6
(assert_bands_match says why), world positions within 1e-5 as
tests/test_torch_view.py holds them;
frames at the tolerances tests/test_torch_slice.py and
tests/test_torch_host_build.py hold each algorithm to under nearest
fetches (the photon walk's light positions differ by ulps of
acos/sin/cos)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_goldens import scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.engine.state import accumulate as jaccumulate
from volumerenderer_tpu.engine.step import build_compact_view_device_step
from volumerenderer_tpu.grid import from_dense
from volumerenderer_tpu.ops import march as jmarch
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.engine.state import accumulate
from volumerenderer_tpu_torch.ops import march as tmarch
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.utils import profiling

ALGOS = [JAlgorithm.POINT, JAlgorithm.SPHERE, JAlgorithm.RAY, JAlgorithm.BEAM]
# Frame tolerances (absolute, image max ~1), as the nearest-fetch frames are
# held: Point/Sphere 5e-5 (tests/test_torch_slice.py), Ray 2e-5 and Beam
# 1e-3 (tests/test_torch_slice_segments.py, test_torch_host_build.py: the
# photon walk's light positions differ by ulps, and Beam's 1/(d-r)^2
# amplifies that near a beam's surface).
FRAME_ATOL = {JAlgorithm.POINT: 5e-5, JAlgorithm.SPHERE: 5e-5,
              JAlgorithm.RAY: 2e-5, JAlgorithm.BEAM: 1e-3}
TRILINEAR = dict(interpolation="trilinear")
FRAME_SIZE = 32  # session frames: the golden scene at 32x32 (one lane tile)


def random_grid():
    """A 13x11x9 volume, ~60% of its voxels nonzero, at bbox (-5, -3, 2)."""
    rs = np.random.RandomState(0)
    vals = (rs.rand(13, 11, 9) * (rs.rand(13, 11, 9) < 0.6)).astype(
        np.float32)
    g = from_dense(vals, bbox_min=(-5, -3, 2))
    return g, convert.grid_from_numpy(g)


def test_sample_trilinear_matches_jax():
    """Random positions in and around the volume, positions on voxel
    centres and faces (integer and half-integer coordinates), and points
    far outside (0)."""
    g, gt = random_grid()
    rs = np.random.RandomState(1)
    pos = rs.uniform(-8.0, 12.0, size=(6000, 3)).astype(np.float32)
    pos[:400] = np.round(pos[:400] * 2.0) / 2.0
    pos[400:500] = rs.uniform(-1e3, 1e3, size=(100, 3))
    want = np.asarray(g.sample_trilinear(jnp.asarray(pos)))
    got = gt.sample_trilinear(torch.as_tensor(pos)).numpy()
    assert (want != 0).sum() > 1000 and (want == 0).sum() > 100
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [False, True], ids=["bbox", "occupied_box"])
def test_trilinear_march_matches_jax(clip):
    """The full trilinear march; with the occupied-box clip and an
    occupied_cap, which trilinear ignores (no brick skipping)."""
    g, gt = random_grid()
    rs = np.random.RandomState(2)
    o = rs.uniform(-20, 20, size=(384, 3)).astype(np.float32)
    o[:, 2] = -20.0
    d = rs.randn(384, 3).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 2.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kw = dict(ray_max_distance=100.0, step_size=0.7, absorption=0.5,
              max_steps=80, interpolation="trilinear", cell=8)
    box = (np.float32([-4, -3, 2]), np.float32([7, 8, 11])) if clip else None
    mj = jmarch.march(g, jnp.asarray(o), jnp.asarray(d), clip_box=box,
                      occupied_cap=16 if clip else None, **kw)
    boxt = (None if box is None
            else tuple(torch.as_tensor(c) for c in box))
    mt = tmarch.march(gt, torch.as_tensor(o), torch.as_tensor(d),
                      clip_box=boxt, occupied_cap=16 if clip else None, **kw)
    assert mt.t.shape == (384, 80)
    assert int((np.asarray(mj.weight) > 0).sum()) > 200
    for name in ("t", "trans", "weight"):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)),
                                   rtol=2e-5, atol=0, err_msg=name)


def golden_pair(algorithm, size=64, **config):
    """The golden scene (at ``size`` x ``size``) in both packages."""
    g, p, c = scene()
    c = dataclasses.replace(c, gather_impl="vpu_interpret", width=size,
                            height=size, **config)
    rj = JRenderer(g, c, p, algorithm=algorithm)
    rt = vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                     convert.params_from_numpy(p),
                     algorithm=vt.Algorithm[algorithm.name])
    return rj, rt


def assert_bands_match(vt_, vj):
    """Layout equal (index maps, band shapes, lane needs); within each
    lane's need, weights at rtol 2e-5, atol 1e-6, and world positions
    within 1e-5 (tests/test_torch_view.py: XLA:CPU contracts o + d*t into
    a multiply-add where the port rounds d*t first, an ulp of the index
    position; near a world coordinate of 0 that exceeds rtol 2e-5).

    The weights' atol: the port's trilinear march equals the JAX march
    run op by op bit for bit in ``val`` (test_trilinear_march_matches_jax
    holds it), but the JAX build runs it jitted, where XLA:CPU fuses the
    8-tap sum into multiply-adds: its densities move by up to ~3e-7, and
    its weights by up to 4.5e-7 absolute on the golden scene (8e-3
    relative on the smallest)."""
    assert (vt_.n_rays, vt_.rows) == (vj.n_rays, vj.rows)
    np.testing.assert_array_equal(vt_.inv_map.numpy(), np.asarray(vj.inv_map))
    np.testing.assert_array_equal(vt_.src.numpy(), np.asarray(vj.src))
    assert len(vt_.bands) == len(vj.bands)
    live = 0
    for bt, bj in zip(vt_.bands, vj.bands):
        assert tuple(bt.wx.shape) == tuple(bj.wx.shape)
        need = bt.lane_need.numpy()
        np.testing.assert_array_equal(need, np.asarray(bj.lane_need))
        use = np.arange(bt.wx.shape[0])[:, None] < need[None, :]
        for name in ("wx", "wy", "wz", "weight"):
            got = np.where(use, getattr(bt, name).numpy(), 0.0)
            want = np.where(use, np.asarray(getattr(bj, name)), 0.0)
            if name == "weight":
                np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=name)
        live += int((bt.weight.numpy() != 0).sum())
    assert live > 0


@pytest.mark.parametrize("build", ["device", "host"])
def test_trilinear_compact_view_matches_jax(build):
    """The device build (identity order: every count is the step budget,
    no host read) and the host-banded build (every band at the full
    budget, 4 bands of one lane tile) against the JAX package's."""
    rj, rt = golden_pair(JAlgorithm.POINT, compact_build=build, **TRILINEAR)
    if build == "device":
        box, view_steps = rj._occupied_clip()
        steps = min(rj._max_steps, view_steps)
        vj = build_compact_view_device_step(
            rj.grid, rj.params, box, config=rj.config, steps=steps,
            march_cell=8, band_lanes=1024)
        before = profiling.totals().get(("sync", "color.build"), 0)
        vt_ = tcolor.build_compact_view_device(
            rt.grid, rt.params, rt.config, steps, clip_box=box,
            march_cell=8, band_lanes=1024)
        assert profiling.totals().get(("sync", "color.build"), 0) == before
        np.testing.assert_array_equal(vt_.src.numpy(), np.arange(64 * 64))
        assert all(b.wx.shape[0] >= steps for b in vt_.bands)
    else:
        for r in (rj, rt):
            r.view_build_budget_bytes = 1
        vj = rj._current_view(rj._max_steps)
        vt_ = rt._current_view(rt._max_steps)
        steps = min(rt._max_steps, rt._occupied_clip()[1])
        assert vt_.caps == (steps,) * len(vt_.bands) and len(vt_.bands) == 4
    assert_bands_match(vt_, vj)


def shared_pairs(**config):
    """A module fixture's getter: one renderer pair per key, built on first
    use.  The cases of a key switch the algorithm and refresh, so each view
    is built once (the view key holds no algorithm) and every case starts
    a fresh accumulation."""
    cache = {}

    def get(key, size, **key_config):
        if key not in cache:
            cache[key] = golden_pair(JAlgorithm.POINT, size, **config,
                                     **key_config)
        rj, rt = cache[key]
        return rj, rt

    return get


def switch(pair, algorithm):
    rj, rt = pair
    for r, a in ((rj, algorithm), (rt, vt.Algorithm[algorithm.name])):
        r.set_algorithm(a)
        r.refresh()


@pytest.fixture(scope="module")
def trilinear_pairs():
    return shared_pairs(**TRILINEAR)


@pytest.mark.parametrize("view", ["device", "host", "slots"])
@pytest.mark.parametrize("algorithm", ALGOS,
                         ids=[a.name.lower() for a in ALGOS])
def test_trilinear_frames_match_jax(trilinear_pairs, algorithm, view):
    """step(2) under trilinear through the compact view (device build and
    host-banded build) and the slots view, against the JAX Renderer, at
    32x32 (the host build's bands are held at 64x64 above)."""
    config = (dict(compact_view=False) if view == "slots"
              else dict(compact_build=view))
    rj, rt = trilinear_pairs(view, FRAME_SIZE, **config)
    if view == "host":
        for r in (rj, rt):
            r.view_build_budget_bytes = 1
    switch((rj, rt), algorithm)
    rj.step(2)
    rt.step(2)
    assert rt.state.frame_count == int(rj.state.frame_count) == 2
    assert bool(getattr(rt._view, "caps", ())) == (view == "host")
    got, want = rt.image(), np.asarray(rj.image())
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL[algorithm])


def test_path_ignores_interpolation():
    """PATH and its photon-free walk do not read ``interpolation`` (nor
    does the reference package's render.path): the same frames bit for
    bit."""
    g, p, c = scene()
    c = dataclasses.replace(c, width=32, height=32)
    images = []
    for interp in ("nearest", "trilinear"):
        r = vt.Renderer(convert.grid_from_numpy(g),
                        port_config(dataclasses.replace(
                            c, interpolation=interp)),
                        convert.params_from_numpy(p),
                        algorithm=vt.Algorithm.PATH)
        r.step(2)
        images.append(r.image())
    assert images[0].max() > 0
    np.testing.assert_array_equal(images[0], images[1])


def test_accumulate_quantize_u8_matches_jax():
    """Bit equal to the JAX accumulate(quantize_u8=True), values on and
    around the half levels (round half to even in both), out of [0, 1]
    and the first frame included."""
    rs = np.random.RandomState(4)
    acc = rs.uniform(-0.2, 1.2, size=(40, 50)).astype(np.float32)
    frame = rs.uniform(-0.1, 1.3, size=(40, 50)).astype(np.float32)
    half = ((np.arange(50) + 0.5) / 255.0).astype(np.float32)
    acc[0] = half
    frame[0] = half
    for fc in (1, 2, 3, 7, 64):
        want = np.asarray(jaccumulate(jnp.asarray(acc), jnp.asarray(frame),
                                      jnp.asarray(fc, jnp.int32),
                                      quantize_u8=True))
        got = accumulate(torch.as_tensor(acc), torch.as_tensor(frame), fc,
                         quantize_u8=True).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.round(got * 255.0) / 255.0)


@pytest.fixture(scope="module")
def uint8_pair():
    return shared_pairs(accum_dtype="uint8")


@pytest.mark.parametrize("algorithm", list(JAlgorithm),
                         ids=[a.name.lower() for a in JAlgorithm])
def test_uint8_renderer_matches_jax(uint8_pair, algorithm):
    """accum_dtype="uint8" at the golden scene (32x32, as the trilinear
    frames: at 64x64 the Ray/Beam cases cost minutes under the 6-worker
    suite) after step(3) (a compact batch is not taken: every frame is
    quantized in image space).  Every
    value lies on the k/255 grid; at most 1% of the pixels differ from
    the JAX Renderer's, each by exactly one level: where the two frames
    differ by rounding, a value near a level boundary may round either
    way."""
    rj, rt = uint8_pair("golden", FRAME_SIZE)
    rt.frame_batch = 3  # the batched step, as step(8) would take it
    switch((rj, rt), algorithm)
    rj.step(3)
    rt.step(3)
    got, want = rt.state.accum.numpy(), np.asarray(rj.state.accum)
    assert got.max() > 0
    np.testing.assert_array_equal(got, np.round(got * 255.0) / 255.0)
    levels = np.round((got - want) * 255.0)
    np.testing.assert_allclose((got - want) * 255.0, levels, atol=1e-3)
    flipped = int((levels != 0).sum())
    print(f"{algorithm.name}: {flipped} of {got.size} pixels one level off")
    assert np.abs(levels).max(initial=0) <= 1
    assert flipped <= 0.01 * got.size
