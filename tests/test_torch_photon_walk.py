"""The photon walk's window loop (ops.kernels.photon_walk) on the CPU: a
numpy replay of the CUDA kernel's walk (csrc/photon_walk.cu: one photon at
a time, step after step, the window's transmittance a running product)
against the plain loop and against the JAX package's walk
(volumerenderer_tpu.render.photon), the rule that routes a walk, the
route counter, and the wrapper's checks.

The kernel itself runs only on a card (tests/test_torch_gpu_walk.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_goldens import scene
from test_torch_photon import _check, port_config
from volumerenderer_tpu.render import photon as jphoton
from volumerenderer_tpu.render.color import required_march_steps
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.ops.kernels import photon_walk as pw
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.render import photon as tphoton
from volumerenderer_tpu_torch.utils import profiling

f32 = np.float32


def golden_scene(**config):
    """The golden scene of tests/test_goldens.py, built by the port."""
    grid = vt.grid.procedural.cloud(n=48, seed=7, center_world=(0.0, 20.0, 20.0),
                                    world_extent=70.0, device="cpu")
    params = vt.RenderParams.default().replace(
        light_source_world_pos=(0.0, 20.0, 20.0), scattering_probability=0.15)
    config = vt.StaticConfig(**{**dict(width=64, height=64,
                                       max_events_per_photon=32,
                                       light_capacity=512), **config})
    return grid, params, config


def _random_dir(r1, r2):
    c = min(max(f32(1.0) - f32(2.0) * r1, f32(-1.0)), f32(1.0))
    theta = np.arccos(c)
    phi = f32(2.0 * np.pi) * r2
    st = np.sin(theta)
    d = [st * np.cos(phi), st * np.sin(phi), np.cos(theta)]
    n = np.sqrt((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1])
    return [x / n for x in d]


def _randf(seed, k):
    m = 0xFFFFFFFF
    x, y, z = ((int(s) + k) & m for s in seed)
    h = ((x * 73856093) & m) ^ ((y * 19349663) & m) ^ ((z * 83492791) & m)
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & m
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & m
    return f32(h ^ (h >> 16)) * f32(f32(1.0) / f32(4294967295.0))


def kernel_replay(grid, seed0, origin, direction, t0, tmax, alive,
                  origin_world, *, step, absorption, scattering_probability,
                  intensity, max_events, max_steps, max_photon_steps):
    """csrc/photon_walk.cu's walk in numpy float32, one photon at a time:
    (scat (P, K, 3) index space, inten (P, K), n_events (P,), dropped
    (P,)).  Along each window it checks what the kernel's early window end
    rests on: once a step is not entered, no later step of the window is."""
    vox = grid.voxels.numpy()
    bmin = grid.bbox_min.numpy()
    step, absorption = f32(step), f32(absorption)
    p_s, K, S = f32(scattering_probability), max_events, max_steps
    Wn, max_iters = pw.windows(S, K, max_photon_steps)
    win_dt = f32(float(Wn) * float(step))
    P = origin.shape[0]
    scat = np.zeros((P, K, 3), f32)
    inten_out = np.zeros((P, K), f32)
    n_ev = np.zeros(P, np.int64)
    dropped = np.zeros(P, bool)

    def fetch(x):
        fl = np.floor(np.asarray(x, f32)).astype(np.int64) - bmin
        if (fl < 0).any() or (fl >= vox.shape).any():
            return f32(0.0)
        return vox[fl[0], fl[1], fl[2]]

    for p in range(P):
        o = [f32(v) for v in origin[p].numpy()]
        d = [f32(v) for v in direction[p].numpy()]
        seed = seed0[p].numpy()
        tm = f32(tmax[p].item())
        t0p = f32(t0[p].item())
        live = bool(alive[p])
        trans, inten = f32(1.0), f32(intensity)
        n_draws, seg, n = 2, 0, 0
        for _ in range(max_iters):
            if not live:
                break
            cum, rank = f32(1.0), 0
            star = None
            entered_k, was_out = False, False
            for k in range(Wn):
                t = t0p + f32(k) * step
                pos = [o[c] + d[c] * t for c in range(3)]
                val = fetch(pos)
                occ = val > f32(0.0)
                a = np.exp(-val * absorption * step) if occ else f32(1.0)
                entered_k = (t < tm and cum * trans > f32(0.001)
                             and cum * inten > f32(0.01))
                assert not (entered_k and was_out)
                was_out = was_out or not entered_k
                if occ and entered_k:
                    rank += 1
                    if _randf(seed, n_draws + rank) < p_s:
                        star = (pos, cum * a, rank)
                        break
                cum = cum * a
            seg += Wn
            if star is not None:
                pos, att, r = star
                trans, inten = trans * att, inten * att
                nd = _random_dir(_randf(seed, n_draws + r + 1),
                                 _randf(seed, n_draws + r + 2))
                if n < K:
                    scat[p, n], inten_out[p, n] = pos, inten
                    n += 1
                else:
                    dropped[p] = True
                o, d, t0p = pos, nd, step
                n_draws += r + 2
                seg = 0
            elif entered_k and seg < S:
                trans, inten = trans * cum, inten * cum
                n_draws += rank
                t0p = t0p + win_dt
            else:
                live = False
        n_ev[p] = n
    return (torch.as_tensor(scat), torch.as_tensor(inten_out),
            torch.as_tensor(n_ev), torch.as_tensor(dropped))


def check_events(got, want):
    """(events, n_events, dropped) of two walks: counts and drops equal;
    positions within atol 1e-4 and intensities within rtol 2e-6 on the
    stored events (tests/test_torch_photon.py's tolerances: acos, sin and
    cos differ by an ulp or two between libraries)."""
    (ev, n, dr), (ev_w, n_w, dr_w) = got, want
    assert torch.equal(n, n_w) and torch.equal(dr, dr_w)
    valid = torch.arange(ev.shape[1])[None, :] < n[:, None]
    np.testing.assert_allclose(ev[valid][:, :6].numpy(),
                               ev_w[valid][:, :6].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ev[valid][:, 6].numpy(),
                               ev_w[valid][:, 6].numpy(), rtol=2e-6)
    return int(n.sum())


CASES = {  # name: (frame counts, light, StaticConfig fields, coarse step)
    "golden": ([1], None, {}, None),
    "frames": ([5, 6, 7], None, {}, None),
    "truncated": ([3], None, {"max_events_per_photon": 4}, None),
    "light_outside": ([2, 3, 4, 5], (-40.0, 20.0, 20.0), {}, None),
    "coarse_step": ([4], None, {}, 12.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_walk_replay_matches_plain_loop(case):
    """The kernel's walk, replayed in numpy on the start state that
    generate_lights hands the walk, against the plain loop's events."""
    fcs, light, fields, coarse = CASES[case]
    grid, params, config = golden_scene(**fields)
    if light is not None:
        params = params.replace(light_source_world_pos=light)
    step = 1.0
    if coarse is not None:
        step = coarse
        params = params.replace(ray_marching_step_size=coarse)
    S = tcolor.required_march_steps(grid, step, config.max_photon_steps)
    args, kw = tphoton.walk_start(grid, params, fcs, config, S)
    want = pw.photon_walk(*args, **kw)  # a CPU grid: the plain loop
    scat, inten, n, dropped = kernel_replay(*args, **kw)
    got = (pw.events_from(grid, args[7], scat, inten), n, dropped)
    stored = check_events(got, want)
    assert stored > 0
    alive = args[6]
    if case == "truncated":
        assert bool(dropped.any())
    if case == "light_outside":
        assert not bool(alive.all()) and bool(alive.any())


@pytest.mark.parametrize("case", ["golden", "truncated", "light_outside",
                                  "coarse_step"])
def test_kernel_walk_replay_matches_jax(case):
    """The kernel's walk, replayed in numpy from the port's start state and
    clamped as generate_lights clamps it, against the JAX package's
    generate_lights (vmapped over the frames) at the golden scene: count,
    valid and truncated equal, positions within atol 1e-4 and intensities
    within rtol 2e-6 (tests/test_torch_photon.py's check) in each frame
    with lights; a frame without lights in both (a light outside the box
    can leave one dark)."""
    fcs, light, fields, coarse = CASES[case]
    g, p, c = scene()
    c = dataclasses.replace(c, **fields)
    if light is not None:
        p = p.replace(light_source_world_pos=jnp.float32(light))
    step = 1.0
    if coarse is not None:
        step = coarse
        p = p.replace(ray_marching_step_size=jnp.float32(coarse))
    ms = required_march_steps(g, step, c.max_photon_steps)
    lab = jax.jit(jax.vmap(
        lambda f: jphoton.generate_lights(g, p, f, c, max_steps=ms)))(
        np.asarray(fcs, np.int32))
    tg, tp, tc = (convert.grid_from_numpy(g), convert.params_from_numpy(p),
                  port_config(c))
    args, kw = tphoton.walk_start(tg, tp, fcs, tc, ms)
    scat, inten, n, dropped = kernel_replay(*args, **kw)
    lt = tphoton.clamp_lights(pw.events_from(tg, args[7], scat, inten), n,
                              dropped, tp, tc)
    for i, fc in enumerate(fcs):
        la = jax.tree.map(lambda x: x[i], lab)
        if int(la.count) > 0:
            _check(la, lt, i, fc)
        else:  # every photon of the frame missed or left unscattered
            assert int(lt.count[i]) == 0 and not bool(lt.valid[i].any())
            assert bool(lt.truncated[i]) == bool(la.truncated)
    assert int(lt.count.sum()) > 0
    if case == "truncated":
        assert bool(lt.truncated.any())
    if case == "light_outside":
        assert not bool(args[6].all())


def test_cpu_walk_takes_the_plain_route(monkeypatch):
    """On a CPU grid the walk never reaches the kernel's library: one
    "walk" at "photon.walk.plain", none at "photon.walk.kernel", and the
    plain loop's host reads at "photon.walk"."""
    def no_kernel():
        raise AssertionError("the kernel's library was loaded")

    monkeypatch.setattr(pw, "_lib", no_kernel)
    grid, params, config = golden_scene()
    S = tcolor.required_march_steps(grid, 1.0, config.max_photon_steps)
    plain, kern = ("walk", "photon.walk.plain"), ("walk", "photon.walk.kernel")
    sync = ("sync", "photon.walk")
    before = profiling.totals()
    n0 = pw.launches["walk"]
    lights = tphoton.generate_lights(grid, params, [1, 2], config,
                                     max_steps=S)
    after = profiling.totals()
    assert after.get(plain, 0) - before.get(plain, 0) == 1
    assert after.get(kern, 0) == before.get(kern, 0)
    assert after.get(sync, 0) > before.get(sync, 0)
    assert pw.launches["walk"] == n0
    assert after.get(("sync", "rng.upload"), 0) == before.get(
        ("sync", "rng.upload"), 0)  # the first draws copy nothing up
    assert int(lights.count.sum()) > 0


def test_wrapper_checks_its_inputs():
    """A wrong dtype, shape or device, a negative absorption or a step
    not above 0 raises before any walk."""
    grid, params, config = golden_scene()
    S = tcolor.required_march_steps(grid, 1.0, config.max_photon_steps)
    args, kw = tphoton.walk_start(grid, params, [1], config, S)
    args = list(args)

    def call(i, value):
        bad = list(args)
        bad[i] = value
        pw.photon_walk(*bad, **kw)

    with pytest.raises(TypeError):
        call(2, args[2].double())  # origin
    with pytest.raises(TypeError):
        call(1, args[1].to(torch.int32))  # seeds
    with pytest.raises(TypeError):
        call(6, args[6].to(torch.uint8))  # alive
    with pytest.raises(ValueError):
        call(3, args[3][:, :2].contiguous())  # direction
    with pytest.raises(ValueError):
        call(4, args[4][:-1])  # t0
    with pytest.raises(ValueError):
        call(3, args[3].t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        call(5, args[5].to("meta"))  # tmax on another device
    with pytest.raises(ValueError):
        pw.photon_walk(grid, *(a.to("meta") for a in args[1:]), **kw)
    for bad in (dict(absorption=-0.05), dict(step=0.0), dict(step=-1.0)):
        with pytest.raises(ValueError):
            pw.photon_walk(*args, **{**kw, **bad})
