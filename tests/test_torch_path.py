"""PATH's pieces (render.path) against the JAX package's on equal inputs
(CPU): the light terms, the camera-segment planes, the bake, the replay
and one scatter walk.  Where the inputs are equal, integer and position
results must agree exactly; float sums and transcendentals agree within
the stated tolerances (XLA:CPU's exp and its cumsum order against
PyTorch's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_path import _bigger_scene, make_scene
from test_torch_photon import port_config
from volumerenderer_tpu.engine.params import Fidelity as JFidelity
from volumerenderer_tpu.render import color as jcolor
from volumerenderer_tpu.render import path as jpath
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import path
from volumerenderer_tpu_torch.render.color import camera_rays_index

# exp differs by an ulp between XLA:CPU and PyTorch (measured 1.2e-7).
RTOL_TERM = 1e-6
# Prefix sums: XLA's cumsum tree against PyTorch's sequential sum.
RTOL_PREFIX = 1e-6
# random_dir: XLA:CPU's and PyTorch's acos/sin/cos (tests/test_torch_ops).
ATOL_DIR = 4e-7


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

SCENES = {"bigger": lambda: _bigger_scene(path_compact_min=64),
          "small": make_scene}


def t(a, dtype=None):
    return torch.as_tensor(np.array(a, dtype))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    g, p, c = SCENES[request.param]()
    S = jcolor.required_march_steps(g, float(p.ray_marching_step_size),
                                    c.max_march_steps)
    return dict(g=g, p=p, c=c, S=S, tg=convert.grid_from_numpy(g),
                tp=convert.params_from_numpy(p), tc=port_config(c))


@pytest.fixture(scope="module")
def jax_view(scene):
    """The JAX package's PathView of the scene (LUT radius 1)."""
    return jpath.bake_path_view(scene["g"], scene["p"], scene["c"],
                                scene["S"], shadow_lut_radius=1)


@pytest.fixture(scope="module")
def light_case():
    """2,048 random positions in the bigger scene's box and a light inside
    an occupied voxel, so the LUT neighbourhood is not empty."""
    g, p, _ = _bigger_scene()
    occ = np.argwhere(np.asarray(g.voxels) > 0.05)
    lw = np.asarray(g.index_to_world(
        jnp.asarray(occ[len(occ) // 2][None, :], jnp.float32) + 0.5))[0]
    p = p.replace(light_source_world_pos=jnp.asarray(lw, jnp.float32),
                  ray_marching_step_size=jnp.float32(0.77),
                  absorption_coefficient=jnp.float32(0.13))
    rs = np.random.RandomState(7)
    lo = np.asarray(g.bbox_min, np.float32)
    ext = np.asarray(g.bbox_max, np.float32) + 1.0 - lo
    pos = (rs.rand(2048, 3) * ext + lo).astype(np.float32)
    return g, p, pos


@pytest.mark.parametrize("case", ["reference", "reference-lut",
                                  "reference-light_step", "corrected"])
def test_light_terms_match_jax(light_case, case):
    g, p, pos = light_case
    tg, tp = convert.grid_from_numpy(g), convert.params_from_numpy(p)
    light = g.world_to_index(p.light_source_world_pos)
    tlight = path._light_local(tg, tp)
    np.testing.assert_array_equal(tlight.numpy(), np.asarray(light))
    if case == "corrected":
        want = jpath._light_term_corrected(g, jnp.asarray(pos), light, p, 60)
        got = path._light_term_corrected(tg, t(pos), tlight, tp, 60)
    else:
        lut = tlut = None
        kw, tkw = {}, {}
        if case == "reference-lut":
            base, vals = jpath._shadow_lut(g, light, 1)
            tbase, tvals = path._shadow_lut(tg, tlight, 1)
            np.testing.assert_array_equal(tvals.numpy(), np.asarray(vals))
            lut, tlut = (base, vals, 1), (tbase, tvals, 1)
        if case == "reference-light_step":
            step = p.ray_marching_step_size
            p = p.replace(ray_marching_step_size=step * 3.0)
            tp = convert.params_from_numpy(p)
            kw, tkw = dict(light_step=step), dict(light_step=float(step))
        want = jpath._light_term_reference(g, jnp.asarray(pos), light, p, lut,
                                           **kw)
        got = path._light_term_reference(tg, t(pos), tlight, tp, tlut, **tkw)
    want = np.asarray(want)
    assert (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_TERM, atol=0)


def test_seg1_planes_match_jax(scene):
    """The camera segment's planes on the JAX package's rays: the march,
    the roll sites and their ranks equal; the prefix within RTOL_PREFIX."""
    g, p, c, S = scene["g"], scene["p"], scene["c"], scene["S"]
    o, d, _ = jpath._camera_setup(g, p, c, 0, None)
    want = jpath._seg1_planes(g, p, c, None, S, o, d)
    got = path._seg1_planes(scene["tg"], scene["tp"], scene["tc"], None, S,
                            t(o), t(d), torch.ones(o.shape[0], dtype=bool))
    for name, w, x in zip(("tmin", "tmax", "live", "site_rank", "n_occ"),
                          want, got):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w).astype(
            x.numpy().dtype), err_msg=name)
    assert int(np.asarray(want[4]).max()) > 0
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=RTOL_PREFIX, atol=0)


def test_camera_rays_match_jax(scene):
    """Origins equal; directions within 2 ulp of 1.0 (PR 1's deviation)."""
    o, d, _ = jpath._camera_setup(scene["g"], scene["p"], scene["c"], 0, None)
    to, td = camera_rays_index(scene["tg"], scene["tp"], scene["tc"])
    np.testing.assert_array_equal(to.numpy(), np.asarray(o))
    np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=0,
                               atol=2.5e-7)


def _check_view(view, jv, S, exact_t=True):
    """Rank planes of ``view`` against ``jv`` (numpy, same rows): n_occ and
    live equal, tmin/tmax equal (or within 2 ulp), rank_k equal and
    rank_prefix within RTOL_PREFIX below each ray's n_occ."""
    for name in ("n_occ", "live"):
        np.testing.assert_array_equal(
            view[name], jv[name].astype(view[name].dtype), err_msg=name)
    for name in ("tmin", "tmax"):
        np.testing.assert_allclose(view[name], jv[name], err_msg=name,
                                   rtol=0 if exact_t else 2.5e-7, atol=0)
    used = np.arange(S)[None, :] < jv["n_occ"][:, None].astype(int)
    assert used.any()
    np.testing.assert_array_equal(view["rank_k"][used],
                                  jv["rank_k"][used].astype(np.int16))
    np.testing.assert_allclose(view["rank_prefix"][used],
                               jv["rank_prefix"][used], rtol=RTOL_PREFIX)
    np.testing.assert_allclose(view["prefix_total"], jv["prefix_total"],
                               rtol=RTOL_PREFIX)


def test_bake_matches_jax(scene, jax_view):
    """The bake's tile body on the JAX package's rays equals the JAX
    package's PathView (_check_view); the port's bake_path_view, on its
    own rays (directions within 2 ulp), agrees on the image rows (the two
    pad differently)."""
    S, n = scene["S"], scene["c"].width * scene["c"].height
    jv = {k: np.asarray(v) for k, v in jax_view._asdict().items()}
    n_pad = jv["o_i"].shape[0]
    got = path._seg1_planes_ranked(
        scene["tg"], scene["tp"], scene["tc"],
        path._make_lut(scene["tg"], scene["tp"], scene["tc"], 1), S,
        t(jv["o_i"]), t(jv["d_i"]), torch.ones(n_pad, dtype=torch.bool))
    names = ("tmin", "tmax", "live", "rank_k", "n_occ", "rank_prefix",
             "prefix_total")
    _check_view({k: x.numpy() for k, x in zip(names, got)}, jv, S)
    view = path.bake_path_view(scene["tg"], scene["tp"], scene["tc"], S,
                               shadow_lut_radius=1)
    _check_view({k: v[:n].numpy() for k, v in view._asdict().items()},
                {k: v[:n] for k, v in jv.items()}, S, exact_t=False)


def _jax_replay(scene, jax_view, fc):
    """JAX's camera-segment replay over its own view for frame fc, and the
    seeds it drew from."""
    c, S = scene["c"], scene["S"]
    n_pad = jax_view.o_i.shape[0]
    seeds = jpath._seeds(c.width, c.height, 0, fc, n_pad)
    jv = jax_view
    out = jpath._seg1_frame_rank(scene["p"], S, jv.o_i, jv.d_i, jv.tmin,
                                 jv.n_occ, jv.rank_k, jv.rank_prefix,
                                 jv.prefix_total, seeds)
    return [np.asarray(a) for a in out], np.asarray(seeds)


@pytest.mark.parametrize("fc", [1, 3])
def test_seg1_frame_rank_matches_jax(scene, jax_view, fc):
    """The replay fed the JAX package's planes: alive rays, draws and
    re-origin positions equal; directions within ATOL_DIR; color within
    RTOL_PREFIX."""
    want, seeds = _jax_replay(scene, jax_view, fc)
    v = convert.path_view_from_numpy(jax_view)
    got = path._seg1_frame_rank(scene["tp"], scene["S"], v.o_i, v.d_i,
                                v.tmin, v.n_occ, v.rank_k, v.rank_prefix,
                                v.prefix_total, t(seeds, np.int64))
    color, o2, d2, sd2, alive = (x.numpy() for x in got)
    assert want[4].any()
    np.testing.assert_array_equal(alive, want[4])
    np.testing.assert_array_equal(sd2, want[3].astype(np.int64))
    np.testing.assert_array_equal(o2, want[1])
    np.testing.assert_allclose(d2, want[2], rtol=0, atol=ATOL_DIR)
    np.testing.assert_allclose(color, want[0], rtol=RTOL_PREFIX)
    # The port's own seeds for the view's rows are the JAX package's.
    spec = path._SeedSpec(scene["c"].width, scene["c"].height, 0,
                          torch.tensor([fc]), seeds.shape[0])
    np.testing.assert_array_equal(
        path._chunk_seeds(torch.arange(seeds.shape[0]), spec).numpy(),
        seeds.astype(np.int64))


@pytest.mark.parametrize("cell", [1, 4])
def test_walk_chunk_matches_jax(scene, jax_view, cell):
    """One scatter segment from the JAX package's state after the camera
    segment: alive, draws and scatter positions equal; directions within
    ATOL_DIR; colors within RTOL_TERM."""
    g, p, c, S = scene["g"], scene["p"], scene["c"], scene["S"]
    if cell > 1 and float(p.ray_marching_step_size) * cell > 8:
        pytest.skip("cell * step must stay within one brick")
    (_, o2, d2, sd2, alive), seeds = _jax_replay(scene, jax_view, 2)
    tmax = np.asarray(jax_view.tmax)
    light = g.world_to_index(p.light_source_world_pos)
    base, vals = jpath._shadow_lut(g, light, 1)
    cfg = dataclasses.replace(c, path_subblock=16)
    want = [np.asarray(a) for a in jpath._walk_chunk(
        g, p, cfg, (base, vals, 1), S, light, jnp.asarray(o2),
        jnp.asarray(d2), jnp.asarray(seeds), jnp.asarray(sd2),
        jnp.asarray(tmax), jnp.asarray(alive), march_cell=cell)]
    tg, tp, tc = scene["tg"], scene["tp"], scene["tc"]
    tlight = path._light_local(tg, tp)
    tbase, tvals = path._shadow_lut(tg, tlight, 1)
    got = [x.numpy() for x in path._walk_chunk(
        tg, tp, tc, (tbase, tvals, 1), S, tlight, t(o2), t(d2),
        t(seeds, np.int64), t(sd2, np.int64), t(tmax), t(alive),
        march_cell=cell, subblock=16)]
    assert want[4].any() and (want[4] != alive).any()
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[3], want[3].astype(np.int64))
    scattered = want[4]
    np.testing.assert_array_equal(got[1][scattered], want[1][scattered])
    np.testing.assert_array_equal(got[1][~scattered], o2[~scattered])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ATOL_DIR)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL_TERM, atol=1e-9)


def test_fidelity_maps_from_jax():
    """port_config carries the JAX package's Fidelity into the port's."""
    from volumerenderer_tpu_torch.engine.params import Fidelity

    _, _, c = make_scene(JFidelity.CORRECTED)
    assert port_config(c).fidelity is Fidelity.CORRECTED
