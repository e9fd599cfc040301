"""The baked march planes (ops.kernels.march_planes) on the CPU: a numpy
replay of the CUDA kernel's loop (csrc/march_planes.cu: the clip, then a
running transmittance product, sample after sample) against the JAX
package's march and planes and against the port's plain version, the rule
that sends a march to the kernel, and the route counter.

The kernel itself runs only on a card (tests/test_torch_gpu_march.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumerenderer_tpu.grid import procedural as jprocedural
from volumerenderer_tpu.ops import march as jmarch
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.grid.dense import occupied_bbox
from volumerenderer_tpu_torch.ops import march as march_ops
from volumerenderer_tpu_torch.ops.kernels import march_planes as tmarch
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.utils import profiling

W, H = 24, 16
ABSORPTION = 1.0  # dense enough that long rays pass the 0.001 cutoff


def scene(step, grid=None):
    if grid is None:
        grid = vt.grid.procedural.cloud(n=24, device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 20.0, -75.0), ray_marching_step_size=step,
        absorption_coefficient=ABSORPTION)
    config = vt.StaticConfig(width=W, height=H, build_tile=100)
    o_i, d_i = tcolor.camera_rays_index(grid, params, config)
    return grid, params, config, o_i, d_i


def clip_of(grid):
    return tuple(torch.as_tensor(c) for c in occupied_bbox(grid))


def kernel_replay(grid, o, d, *, far, step, absorption, S, clip_box):
    """csrc/march_planes.cu's loop in numpy float32, every ray at once:
    (x, y, z, w, T, t) each (N, S), T the transmittance before each sample
    and t the march distance."""
    f = np.float32
    o, d = o.numpy(), d.numpy()
    step, absorption = f(step), f(absorption)
    with np.errstate(all="ignore"):
        inv = f(1.0) / d

        def slab(lo, hi):
            t0, t1 = (lo - o) * inv, (hi - o) * inv
            swap = inv < 0
            lo_t = np.where(swap, t1, t0).max(axis=1)
            hi_t = np.where(swap, t0, t1).min(axis=1)
            return np.maximum(f(0.0), lo_t), np.minimum(f(far), hi_t)

        bmin = grid.bbox_min.numpy()
        bmax = grid.bbox_max.numpy() + 1
        tmin, tmax = slab(bmin.astype(f), bmax.astype(f))
        live = (tmax >= tmin) & (tmax > 0)
        tmin = np.where(tmin < 0, f(0.0), tmin) + f(march_ops.f32mul(
            march_ops.ENTRY_EPS, step))
        if clip_box is not None:
            u_lo, u_hi = slab(*(c.numpy() for c in clip_box))
            live &= (u_hi >= u_lo) & (u_hi > 0)
            gap = np.where(u_lo - tmin < 0, f(0.0), u_lo - tmin)
            tmin = tmin + np.floor(gap / step) * step
            tmax = np.minimum(tmax, u_hi + step)
        vox = grid.voxels.numpy()
        mm, mv = grid.map_mat.numpy(), grid.map_vec.numpy()
        T = np.ones(o.shape[0], f)
        out = np.empty((6, o.shape[0], S), f)
        for k in range(S):
            t = tmin + f(k) * step
            p = o + d * t[:, None]
            fl = np.floor(p)
            ok = np.all((fl >= -4e18) & (fl < 4e18), axis=1)
            rel = np.where(ok[:, None], fl, 0).astype(np.int64) - bmin
            ok &= np.all((rel >= 0) & (rel < vox.shape), axis=1)
            relc = np.where(ok[:, None], rel, 0)
            val = np.where(ok, vox[relc[:, 0], relc[:, 1], relc[:, 2]], f(0))
            on = live & (t < tmax) & (T > f(0.001))
            out[3, :, k] = np.where(on, T * val * step, f(0.0))
            out[4, :, k] = T
            out[5, :, k] = t
            T = np.where(live, T * np.exp(-val * absorption * step), T)
            for i in range(3):
                out[i, :, k] = (mm[i, 0] * p[:, 0] + mm[i, 1] * p[:, 1]
                                + mm[i, 2] * p[:, 2] + mv[i])
    return out


def weights_agree(w, wr, T):
    """Weights within rtol 1e-6 (a running product against a cumprod, and
    numpy's exp against another library's), any sample that one side
    weights and the other not sitting at T within 4 ulp of the 0.001
    cutoff."""
    np.testing.assert_allclose(w, wr, rtol=1e-6, atol=0)
    flip = (w != 0) != (wr != 0)
    cutoff = np.float32(0.001)
    assert (np.abs(T[flip] - cutoff) <= 4 * np.spacing(cutoff)).all()
    assert (w > 0).sum() > 50


@pytest.mark.parametrize("step", [1.0, 12.0], ids=["step1", "step12"])
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("lanes", [False, True], ids=["slots", "lanes"])
def test_plain_version_matches_march_and_kernel_loop(lanes, clip, step):
    """The plain version (``march_planes`` on CPU tensors, in tiles of 100
    rays) against the kernel's loop replayed in numpy: positions bit-equal
    everywhere, weights as ``weights_agree``; both layouts hold the same
    planes."""
    grid, params, config, o_i, d_i = scene(step)
    S = tcolor.required_march_steps(grid, step, config.max_march_steps)
    box = clip_of(grid) if clip else None
    march = dict(ray_max_distance=params.ray_max_distance, step_size=step,
                 absorption=ABSORPTION, max_steps=S, clip_box=box)
    got = tmarch.march_planes(grid, o_i, d_i, lanes=lanes, tile=100, **march)
    assert got.shape == ((4, S, W * H) if lanes else (4, W * H, S))
    other = tmarch.march_planes(grid, o_i, d_i, lanes=not lanes, **march)
    assert torch.equal(got.transpose(1, 2), other)

    slots = got.transpose(1, 2) if lanes else got
    rep = kernel_replay(grid, o_i, d_i, far=params.ray_max_distance,
                        step=step, absorption=ABSORPTION, S=S, clip_box=box)
    np.testing.assert_array_equal(slots[:3].numpy(), rep[:3])
    weights_agree(slots[3].numpy(), rep[3], rep[4])
    if step == 1.0:
        # The cutoff and the ray ends both bind somewhere in this scene.
        assert ((rep[4] <= np.float32(0.001)) & (rep[3] == 0)).any()


@pytest.mark.parametrize("step", [1.0, 12.0], ids=["step1", "step12"])
@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
def test_kernel_loop_matches_jax_march(clip, step):
    """The kernel's loop, replayed in numpy, against the JAX package's
    march (volumerenderer_tpu.ops.march) on the same rays and grid, and
    against its planes as the JAX build bakes them (index positions
    o + d*t, then the grid's map to world space): march distances and
    positions bit-equal, the transmittance and the weights within rtol
    1e-6 (the JAX march takes an exclusive cumprod)."""
    jgrid = jprocedural.cloud(n=24)
    grid, params, _, o_i, d_i = scene(step, convert.grid_from_numpy(jgrid))
    S = tcolor.required_march_steps(grid, step, 10**6)
    box = clip_of(grid) if clip else None
    rep = kernel_replay(grid, o_i, d_i, far=params.ray_max_distance,
                        step=step, absorption=ABSORPTION, S=S, clip_box=box)
    o, d = jnp.asarray(o_i.numpy()), jnp.asarray(d_i.numpy())
    m = jmarch.march(
        jgrid, o, d, ray_max_distance=params.ray_max_distance,
        step_size=step, absorption=ABSORPTION, max_steps=S,
        clip_box=None if box is None else tuple(c.numpy() for c in box))
    np.testing.assert_array_equal(np.asarray(m.t), rep[5])
    ix = o[:, 0:1] + d[:, 0:1] * m.t
    iy = o[:, 1:2] + d[:, 1:2] * m.t
    iz = o[:, 2:3] + d[:, 2:3] * m.t
    mm, mv = jgrid.map_mat, jgrid.map_vec
    for i in range(3):
        want = mm[i, 0] * ix + mm[i, 1] * iy + mm[i, 2] * iz + mv[i]
        np.testing.assert_array_equal(np.asarray(want), rep[i])
    active = np.asarray(m.active)
    np.testing.assert_allclose(rep[4][active], np.asarray(m.trans)[active],
                               rtol=1e-6, atol=0)
    weights_agree(rep[3], np.asarray(m.weight), rep[4])


def test_kernel_route():
    """The rule that sends a march to the kernel (``plan``), read without
    a card: nearest, not brick-gated (cell 1 or no cap), every sample
    kept; ``render.color.occupancy_gated`` reads the same gate."""
    route = lambda interp="nearest", cell=8, cap=None, gs=0: tmarch.plan(
        interp, cell, cap, gs, 40)
    assert route() == (False, 40, 40, True)  # uncached frame, slots view
    assert route(cell=1, cap=40).kernel  # a cell-1 build: no brick gate
    assert route(gs=40).kernel and route(gs=64).kernel  # top-k keeps all
    assert route(cap=16) == (True, 16, 16, False)  # brick-skipping march
    assert route(cap=13, gs=12) == (True, 16, 12, False)
    assert not route("trilinear").kernel
    assert route("trilinear", cap=16) == (False, 40, 40, False)
    assert route(gs=12) == (False, 40, 12, False)  # top-k compaction
    for interp in ("nearest", "trilinear"):
        for cell in (1, 2, 8):
            config = vt.StaticConfig(interpolation=interp)
            assert tcolor.occupancy_gated(config, cell) == route(
                interp, cell, cap=8).gated


@pytest.mark.parametrize("case", ["ungated", "gated", "trilinear", "topk"])
def test_cpu_marches_take_the_plain_route(monkeypatch, case):
    """On CPU tensors no march reaches the kernel's library, whatever its
    kind; each ``_march_planes`` call counts once under
    "color.march.ops"."""
    def no_kernel():
        raise AssertionError("the kernel's library was loaded")

    monkeypatch.setattr(tmarch, "_lib", no_kernel)
    grid, params, config, o_i, d_i = scene(1.0)
    if case == "trilinear":
        config = vt.StaticConfig(width=W, height=H, build_tile=100,
                                 interpolation="trilinear")
    S = tcolor.required_march_steps(grid, 1.0, config.max_march_steps)
    ops, kern = ("march", "color.march.ops"), ("march", "color.march.kernel")
    before = profiling.totals()
    planes = tcolor._march_planes(
        grid, params, config, S, o_i, d_i, clip_box=None,
        occupied_cap=16 if case == "gated" else None, march_cell=8,
        lanes=True, gather_samples=12 if case == "topk" else 0)
    after = profiling.totals()
    assert after.get(ops, 0) - before.get(ops, 0) == 1
    assert after.get(kern, 0) == before.get(kern, 0)
    assert planes.shape[0] == 4 and torch.isfinite(planes).all()


def test_counter_counts_one_per_call():
    """``build_view`` and ``build_view_rays`` each count one march, by
    route (kind "march"); a march makes no host read."""
    grid, params, config, o_i, d_i = scene(12.0)
    S = tcolor.required_march_steps(grid, 12.0, config.max_march_steps)
    key = ("march", "color.march.ops")
    before = profiling.totals()
    tcolor.build_view(grid, params, config, S)
    syncs = profiling.total("sync")
    tcolor.build_view_rays(grid, params, config, S, o_i, d_i)
    tcolor.build_view_rays(grid, params, config, S, o_i, d_i,
                           occupied_cap=8, march_cell=2)
    assert profiling.total("sync") == syncs  # the march reads nothing back
    assert profiling.totals()[key] - before.get(key, 0) == 3
    assert profiling.total("march") - sum(
        n for (k, _), n in before.items() if k == "march") == 3


def test_wrapper_checks_its_inputs():
    """A wrong dtype, shape or device raises before any march."""
    grid, params, config, o_i, d_i = scene(12.0)
    kw = dict(ray_max_distance=2500.0, step_size=12.0, absorption=1.0,
              max_steps=8, lanes=False)
    with pytest.raises(TypeError):
        tmarch.march_planes(grid, o_i.double(), d_i, **kw)
    with pytest.raises(ValueError):
        tmarch.march_planes(grid, o_i[:, :2].contiguous(), d_i, **kw)
    with pytest.raises(ValueError):
        tmarch.march_planes(grid, o_i, d_i, **kw, clip_box=(
            torch.zeros(3), torch.zeros(3, device="meta")))
    with pytest.raises(ValueError):
        tmarch.march_planes(grid, o_i.to("meta"), d_i.to("meta"), **kw)
