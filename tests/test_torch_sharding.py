"""The port's multi-device rendering (volumerenderer_tpu_torch.parallel)
against the JAX package, case for case of tests/test_sharding.py: the
JAX suite's 8 virtual CPU devices stand against 8 gloo ranks.

One 8-rank world per module runs every port case (tests/
test_torch_sharding_ranks.py ``run_cases``) and hands the whole frames
back through an .npz; each test then holds one case.  Where the JAX test
is slow-marked, the port is held against the JAX single-device result
(render_step, or the JAX package's Renderer on the same scene and steps)
and the port's single-device Renderer.

Tolerances: row-sharded frames do no cross-rank arithmetic, so they equal
the port's single-device frames (bit for bit, checked below) and the JAX
frames (render_step's, or the JAX Renderer's) to the port's frame
tolerances (FRAME_ATOL, PATH RTOL_PATH, as in test_torch_motion.py and
test_torch_slice_path.py).  Light-sharded frames
sum the ranks' partials in another order: they are held to JAX's own
sharded bound, rtol 1e-4 and atol 1e-6, against the port's single-device
frame, and to the port's frame tolerances against JAX's sharded frame.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_sharding as jcase
import test_torch_sharding_ranks as cases
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.engine.state import RenderState as JRenderState
from volumerenderer_tpu.parallel import sharding as jsharding
from volumerenderer_tpu.render import color as jcolor
from volumerenderer_tpu.render import photon as jphoton
from volumerenderer_tpu.render.color import required_march_steps
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.engine.state import RenderState
from volumerenderer_tpu_torch.engine.step import render_step
from volumerenderer_tpu_torch.parallel import launch
from volumerenderer_tpu_torch.render import color as tcolor

FRAME_ATOL = {"POINT": 5e-5, "SPHERE": 5e-5, "RAY": 5e-5, "BEAM": 1e-3}
RTOL_PATH = 1e-6
SHARDED = dict(rtol=1e-4, atol=1e-6)  # JAX's sharded bound
LIGHT_ALGORITHMS = cases.ALGORITHMS[:4]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every port case, rendered once in one world of 8 gloo ranks."""
    path = str(tmp_path_factory.mktemp("sharding") / "cases.npz")
    launch.launch(cases.run_cases, 8, path, device="cpu")
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module")
def jscene():
    return jcase.scene()


def test_port_scene_is_the_jax_scene(jscene):
    g, p, c = jscene
    tg, tp, tc = cases.scene()
    jg = convert.grid_from_numpy(g)
    assert torch.equal(tg.voxels, jg.voxels)
    want_p = convert.params_from_numpy(p)
    for f in dataclasses.fields(tp):
        assert np.array_equal(getattr(tp, f.name), getattr(want_p, f.name))
    want = port_config(c)
    for f in ("width", "height", "light_capacity", "max_events_per_photon",
              "probe_tile", "build_tile", "max_points_per_segment",
              "max_path_segments"):
        assert getattr(tc, f) == getattr(want, f), f


def port_frames(algorithm: str, n_frames: int = 2) -> np.ndarray:
    """The port's single-device uncached frames of the scene."""
    g, p, c = cases.scene()
    steps = required_march_steps(g, 1.0, c.max_march_steps)
    state = RenderState.create(c.height, c.width)
    for _ in range(n_frames):
        out = render_step(g, p, state, algorithm=vt.Algorithm[algorithm],
                          config=c, max_steps=steps)
        state = out[0]
    return state.accum.numpy()


def port_renderer(algorithm: str, config=None, n: int = 2):
    g, p, c = cases.scene()
    r = vt.Renderer(g, config or c, p, algorithm=vt.Algorithm[algorithm])
    r.step(n)
    return r


@pytest.fixture(scope="module")
def jax_image(jscene):
    """image(algorithm, **config fields): channel 0 of the JAX package's
    single-device Renderer on the scene after step(2), made once per
    case."""
    made = {}

    def image(algorithm: str, **fields):
        key = (algorithm, tuple(sorted(fields.items())))
        if key not in made:
            g, p, c = jscene
            r = JRenderer(g, dataclasses.replace(c, **fields), p,
                          algorithm=JAlgorithm[algorithm])
            r.step(2)
            made[key] = np.asarray(r.image())[..., 0]
        return made[key]

    return image


def hold_jax(got, want, algorithm: str):
    if algorithm == "PATH":
        np.testing.assert_allclose(got, want, rtol=RTOL_PATH, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FRAME_ATOL[algorithm])


@pytest.mark.parametrize("algorithm", cases.ALGORITHMS)
def test_row_sharded_matches_single_device(world, jscene, algorithm):
    """(8, 1) mesh, two frames of sharded_render_step: equal to the port's
    single-device render_step bit for bit, and to the JAX package's
    render_step on one device to the port's frame tolerance."""
    got = world[f"row_{algorithm}"]
    assert got.shape == (16, 16) and np.isfinite(got).all() and got.max() > 0
    np.testing.assert_array_equal(got, port_frames(algorithm))
    want, _ = jcase._single_device_frames(*jscene, JAlgorithm[algorithm])
    hold_jax(got, want, algorithm)


@pytest.fixture(scope="module")
def jax_light_frames(jscene):
    """JAX's light_sharded_radiance on its (2, 4) mesh, per algorithm."""
    g, p, c = jscene
    steps = required_march_steps(g, 1.0, c.max_march_steps)
    mesh = jsharding.make_mesh(jax.devices()[:8], lights_axis=4)
    return {name: np.asarray(jsharding.light_sharded_radiance(
        g, p, JRenderState.create(c.height, c.width),
        algorithm=JAlgorithm[name], config=c, max_steps=steps, mesh=mesh))
        for name in LIGHT_ALGORITHMS}


@pytest.mark.parametrize("algorithm", LIGHT_ALGORITHMS)
def test_light_sharded_matches_single_device(world, jax_light_frames,
                                             algorithm):
    """(2, 4) mesh: each rank gathers a quarter of the 64 light slots and
    the partials meet in one all_reduce.  Within JAX's sharded bound of the
    port's single-device frame 1, and within the port's frame tolerance of
    JAX's light-sharded frame on JAX's (2, 4) mesh."""
    got = world[f"light_{algorithm}"]
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, port_frames(algorithm, 1), **SHARDED)
    hold_jax(got, jax_light_frames[algorithm], algorithm)


def test_mesh_validation(world):
    """make_mesh(3) in a world of 8 raises ValueError on every rank."""
    assert world["mesh_validation"]


@pytest.mark.parametrize("lights_axis", [1, 4])
def test_mesh_renderer_cached_matches_single_device(world, jax_image,
                                                    lights_axis):
    """MeshRenderer POINT step(2) through each band's compact view, against
    the port's Renderer: (8, 1) bit for bit, (2, 4), which sums the light
    partials across ranks, within JAX's sharded bound.  (8, 1) also
    against the JAX package's Renderer, to the port's frame tolerance."""
    assert world[f"cached_{lights_axis}_compact"]
    want = port_renderer("POINT").image()[..., 0]
    got = world[f"cached_{lights_axis}"]
    if lights_axis == 1:
        np.testing.assert_array_equal(got, want)
        hold_jax(got, jax_image("POINT"), "POINT")
    else:
        np.testing.assert_allclose(got, want, **SHARDED)


@pytest.mark.parametrize("lights_axis", [1, 4])
def test_mesh_renderer_slots_view_matches_single_device(world, jax_image,
                                                        lights_axis):
    """compact_view=False: each band's slots ViewCache, shaded in image
    space (sharded_shade_step), RAY step(2) against the port's Renderer on
    the slots view: (8, 1) bit for bit, (2, 4) within JAX's sharded
    bound.  (8, 1) also against the JAX package's Renderer on the slots
    view, to the port's frame tolerance."""
    assert world[f"slots_{lights_axis}_view"]
    g, p, c = cases.scene()
    want = port_renderer("RAY", dataclasses.replace(c, compact_view=False))
    got, want = world[f"slots_{lights_axis}"], want.image()[..., 0]
    if lights_axis == 1:
        np.testing.assert_array_equal(got, want)
        hold_jax(got, jax_image("RAY", compact_view=False), "RAY")
    else:
        np.testing.assert_allclose(got, want, **SHARDED)


@pytest.mark.parametrize("cached", [True, False],
                         ids=["cached", "uncached"])
def test_mesh_renderer_path_cached(world, jax_image, cached):
    """PATH through each band's PathView, and uncached when the band's
    PathView exceeds Renderer.path_cache_budget_bytes (lowered to 0 on the
    ranks), equals the port's single-device Renderer's frames bit for bit
    and the JAX package's Renderer's to RTOL_PATH."""
    if cached:
        assert world["path_cached_baked"]
        got = world["path_cached"]
    else:
        assert world["path_uncached_unbaked"]
        got = world["path_uncached"]
    np.testing.assert_array_equal(got, port_renderer("PATH").image()[..., 0])
    hold_jax(got, jax_image("PATH"), "PATH")


def test_mesh_renderer_batched_dispatch_matches_per_frame(world):
    """step(8) as one batch (one photon walk, compact-space accumulation)
    against eight single-frame batches, at JAX's bound for the same test."""
    assert int(world["batched_frames"]) == 8
    np.testing.assert_allclose(world["batched"], world["per_frame"],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("algorithm", cases.ALGORITHMS)
def test_mesh_renderer_motion_coarse_matches_single_device(world, jscene,
                                                           algorithm):
    """motion_mode="coarse": the first frame, a drag frame (the camera moved
    since the bake and since the last step: the strided uncached sharded
    step) and the settled frame (blocking re-bake) each equal the port's
    Renderer with settle_chunks=0 at that stage, bit for bit (the same
    arithmetic per band), and the JAX package's Renderer driven alike to
    the port's frame tolerance."""
    g, p, c = cases.scene()
    r = vt.Renderer(g, cases.coarse_config(c), p,
                    algorithm=vt.Algorithm[algorithm])
    jg, jp, jc = jscene
    rj = JRenderer(jg, cases.coarse_config(jc), jp,
                   algorithm=JAlgorithm[algorithm])
    for i in range(3):
        if i == 1:
            r.set(camera_pos=cases.MOVED)
            rj.set(camera_pos=np.float32(cases.MOVED))
        r.step(1)
        rj.step(1)
        assert r.view_exact == (i != 1)
        got = world[f"coarse_{algorithm}_{i}"]
        np.testing.assert_array_equal(got, r.image()[..., 0])
        hold_jax(got, np.asarray(rj.image())[..., 0], algorithm)
    assert world[f"coarse_{algorithm}_settled"]


def test_mesh_renderer_rejects_truncated_motion(world):
    assert world["truncated_refused"]


def test_mesh_renderer_rebakes_view_on_param_edit(world):
    """A camera edit after the first step re-bakes each band's view: the
    refreshed session equals a new session at that camera bit for bit."""
    np.testing.assert_array_equal(world["rebake"], world["rebake_fresh"])
    assert not np.array_equal(world["rebake"], world["cached_1"])


def test_mesh_renderer_gather_stride_matches_single_device(world,
                                                            jax_image):
    """gather_stride=2 with the paired tier: each band's compact build
    decimates as the single-device build does (bit for bit against the
    port's Renderer; to the port's frame tolerance against the JAX
    package's)."""
    g, p, c = cases.scene()
    want = port_renderer("POINT", cases.stride_config(c)).image()[..., 0]
    np.testing.assert_array_equal(world["stride"], want)
    hold_jax(world["stride"],
             jax_image("POINT", gather_stride=2, gather_eval="paired"),
             "POINT")


# Raw sums against JAX's, relative: the kernels' own bound, 2e-5 (as
# test_torch_shading_segments.py), and for BEAM its frame tolerance as a
# fraction of the value (a sample near a beam's surface moves the sum by
# 8.9e-5 of 2,190 at this scene).
RAW_RTOL = {"POINT": 2e-5, "SPHERE": 2e-5, "RAY": 2e-5, "BEAM": 1e-3}


@pytest.mark.parametrize("algorithm", LIGHT_ALGORITHMS)
def test_normalize_false_gives_jax_raw_sums(jscene, algorithm):
    """render_frame and shade_view with normalize=False: the raw radiance
    sums, unclipped, against JAX's on the same lights; normalized, the
    port's default divides them by lightCount and clamps."""
    g, p, c = jscene
    steps = required_march_steps(g, 1.0, c.max_march_steps)
    ja = JAlgorithm[algorithm]
    jl = jphoton.generate_lights(g, p, 1, c, max_steps=steps)
    want = np.asarray(jcolor.render_frame(g, p, jl, ja, c, steps,
                                          normalize=False))
    tg, tp, tc = cases.scene()
    tl = convert.lights_from_numpy(jl)
    ta = vt.Algorithm[algorithm]
    raw = tcolor.render_frame(tg, tp, tl, ta, tc, steps, normalize=False)
    count = int(jl.count)
    assert count > 0 and float(raw.max()) > 1.0  # unclipped
    np.testing.assert_allclose(raw.numpy(), want, rtol=RAW_RTOL[algorithm],
                               atol=0)
    view = tcolor.build_view(tg, tp, tc, steps)
    shaded = tcolor.shade_view(tg, view, tp, tl, ta, tc, normalize=False)
    np.testing.assert_array_equal(shaded.numpy(), raw.numpy())
    norm = tcolor.render_frame(tg, tp, tl, ta, tc, steps)
    np.testing.assert_array_equal(
        norm.numpy(), torch.clamp(raw / count, 0.0, 1.0).numpy())
