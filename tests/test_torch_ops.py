"""The PyTorch port's RNG, grid, geometry and march against the JAX package,
on the same numpy inputs (CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from volumerenderer_tpu.grid import procedural as jproc
from volumerenderer_tpu.ops import camera as jcam
from volumerenderer_tpu.ops import intersect as jint
from volumerenderer_tpu.ops import march as jmarch
from volumerenderer_tpu.ops import rng as jrng
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.grid import procedural as tproc
from volumerenderer_tpu_torch.ops import camera as tcam
from volumerenderer_tpu_torch.ops import intersect as tint
from volumerenderer_tpu_torch.ops import march as tmarch
from volumerenderer_tpu_torch.ops import rng as trng

T = torch.as_tensor


def _u32(rs, shape):
    return rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_hash_randf_make_seed_bit_exact():
    rs = np.random.RandomState(0)
    x, y, z = (_u32(rs, 50000) for _ in range(3))
    want = np.asarray(jrng.hash_uvec3(x, y, z))
    got = trng.hash_uvec3(*(T(a.astype(np.int64)) for a in (x, y, z)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)

    seed = _u32(rs, (50000, 3))
    k = rs.randint(0, 5000, size=50000).astype(np.uint32)
    want = np.asarray(jrng.randf_at(seed, k))
    got = trng.randf_at(T(seed.astype(np.int64)), T(k.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))

    gx, gy = rs.randint(0, 4, 64), rs.randint(0, 4, 64)
    fc = rs.randint(1, 2**31, 64)
    want = np.asarray(jrng.make_seed(gx, gy, np.zeros(64, np.int64),
                                     fc.astype(np.uint32)))
    got = trng.make_seed(T(gx), T(gy), T(np.zeros(64, np.int64)), T(fc))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_random_dir_within_ulps():
    """acos/sin/cos of XLA:CPU and of PyTorch differ by up to ~2 ulp, so
    the unit vectors agree to 4e-7 absolute (components <= 1)."""
    rs = np.random.RandomState(1)
    r1, r2 = (rs.rand(50000).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(jrng.random_dir)(r1, r2))
    got = trng.random_dir(T(r1), T(r2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


@pytest.mark.parametrize("builder,kw", [
    ("cloud", dict(n=48, seed=7)),
    ("cloud", dict(n=40, seed=3, world_extent=50.0)),
    ("fog_sphere", dict(n=24, center_world=(0.0, 0.0, 10.0), world_extent=20.0)),
])
def test_procedural_voxels_and_brick_tables_bit_identical(builder, kw):
    gj = getattr(jproc, builder)(**kw)
    gt = getattr(tproc, builder)(**kw, device="cpu")
    for name in ("voxels", "brick_occ", "brick_max", "brick_occ_dil",
                 "map_mat", "map_inv", "map_vec", "bbox_min", "bbox_max"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)), name)


@pytest.fixture(scope="module")
def grids():
    gj = jproc.cloud(n=40, seed=3)
    return gj, convert.grid_from_numpy(gj)


def test_sample_nearest_and_dilated_occupancy_equal(grids):
    gj, gt = grids
    rs = np.random.RandomState(2)
    pos = (rs.rand(20000, 3) * 64 - 12).astype(np.float32)  # in and around
    np.testing.assert_array_equal(
        gt.sample_nearest(T(pos)).numpy(),
        np.asarray(jax.jit(gj.sample_nearest)(pos)))
    np.testing.assert_array_equal(
        gt.brick_occupancy_dilated_at(T(pos)).numpy(),
        np.asarray(jax.jit(gj.brick_occupancy_dilated_at)(pos)))


def _rays(rs, n):
    o = (rs.randn(n, 3) * 30 + 20).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def test_intersect_aabb_within_one_ulp():
    """hit equal; the clipped interval within 1 ulp."""
    rs = np.random.RandomState(3)
    o, d = _rays(rs, 20000)
    lo, hi = np.float32([0, 0, 0]), np.float32([40, 32, 48])
    t0, t1 = np.zeros(20000, np.float32), np.full(20000, 500.0, np.float32)
    hj, aj, bj = jax.jit(jint.intersect_aabb)(o, d, lo, hi, t0, t1)
    ht, at, bt = tint.intersect_aabb(*(T(a) for a in (o, d, lo, hi, t0, t1)))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_max_ulp(at.numpy(), np.asarray(aj), maxulp=1)
    np.testing.assert_array_max_ulp(bt.numpy(), np.asarray(bj), maxulp=1)


@pytest.mark.parametrize("w,h,fov,pos", [
    (64, 64, 45.0, (0.0, 20.0, -75.0)),
    (48, 36, 45.0, (0.0, 20.0, -75.0)),
    (100, 37, 30.0, (3.0, -2.0, 11.0)),
])
def test_camera_rays_within_two_ulp_of_unit(w, h, fov, pos):
    """Unit directions agree within 2 ulp of 1.0 (2.4e-7 absolute): XLA
    rewrites ``2 (p + 0.5) / size`` into a multiply by the constant 2/size
    (the port writes that form) and, depending on the fusion, contracts
    ``1 - a c`` into an FMA, which the port does not.  Power-of-two sizes
    are bit-identical."""
    fn = jax.jit(jcam.camera_rays, static_argnums=(0, 1))
    oj, dj = fn(w, h, jnp.float32(fov), jnp.float32(pos))
    ot, dt = tcam.camera_rays(w, h, fov, pos)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    ulp1 = np.spacing(np.float32(1.0))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=2 * ulp1)
    if w == h == 64:
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _camera_march_inputs(gj, gt, n=48):
    """Index-space camera rays toward the volume, from the JAX package."""
    from volumerenderer_tpu.grid.dense import occupied_bbox

    oj, dj = jcam.camera_rays(n, n, 45.0, jnp.float32([0.0, 20.0, -75.0]))
    o = np.asarray(gj.world_to_index(oj.reshape(-1, 3)))
    d = np.asarray(gj.world_to_index_dir(dj.reshape(-1, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, occupied_bbox(gj)


@pytest.mark.parametrize("mode", ["full", "clip", "clip_cap"])
def test_march_weights_and_occupancy_counts(grids, mode):
    """Weights at rtol 1e-6 (the transmittance cumprod associates
    differently in XLA and PyTorch); occupancy counts exactly equal."""
    gj, gt = grids
    o, d, box = _camera_march_inputs(gj, gt)
    clip = box if mode != "full" else None
    kw = dict(ray_max_distance=2500.0, step_size=1.0, max_steps=90)
    cap = 48 if mode == "clip_cap" else None
    mj = jax.jit(lambda o, d: jmarch.march(
        gj, o, d, absorption=0.05, clip_box=clip, occupied_cap=cap, cell=8,
        **kw))(o, d)
    tclip = None if clip is None else tuple(T(c) for c in clip)
    o, d = o.copy(), d.copy()
    mt = tmarch.march(gt, T(o), T(d), absorption=0.05, clip_box=tclip,
                      occupied_cap=cap, cell=8, **kw)
    np.testing.assert_array_equal(mt.t.numpy(), np.asarray(mj.t))
    np.testing.assert_array_equal(mt.val.numpy(), np.asarray(mj.val))
    np.testing.assert_allclose(mt.weight.numpy(), np.asarray(mj.weight),
                               rtol=1e-6, atol=0)
    cj = jax.jit(lambda o, d: jmarch.occupancy_counts(
        gj, o, d, clip_box=clip, cell=8, **kw))(o, d)
    ct = tmarch.occupancy_counts(gt, T(o), T(d), clip_box=tclip, cell=8, **kw)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_sqrt_is_correctly_rounded():
    """march.sqrt, which every square root of the plain gathers goes
    through, equals the IEEE f32 square root (numpy's, and XLA's) bit for
    bit; PyTorch's own f32 torch.sqrt on the CPU is off by an ulp on ~0.7%
    of such inputs."""
    x = np.random.RandomState(9).rand(1 << 20).astype(np.float32) * 400.0
    x = x.reshape(1024, 1024)
    np.testing.assert_array_equal(tmarch.sqrt(T(x)).numpy(), np.sqrt(x))
    np.testing.assert_array_equal(tmarch.sqrt(T(x)).numpy(),
                                  np.asarray(jnp.sqrt(x)))


def test_first_transcendental_call_of_a_process_is_accurate():
    """In fresh processes that import the port, the first (multi-threaded)
    torch.sqrt and torch.atan calls agree with numpy to an ulp.  Without the
    package's one-element warm-up, ~20% of such processes got ~12-bit
    results from the first call (up to 3e-4 relative), which failed the
    Beam plain versions' and the oracles' 2e-5 bounds now and then."""
    code = (
        "import numpy as np, torch, volumerenderer_tpu_torch\n"
        "x = np.random.RandomState(0).rand(1024, 1024).astype(np.float32)"
        " * 100 + 0.1\n"
        "for f, g in ((torch.sqrt, np.sqrt), (torch.atan, np.arctan)):\n"
        "    got = f(torch.as_tensor(x)).numpy().astype(np.float64)\n"
        "    want = g(x.astype(np.float64))\n"
        "    print(float(np.max(np.abs(got - want) / want)))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for _ in range(3):
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, check=True)
        errs = [float(v) for v in out.stdout.split()]
        assert len(errs) == 2 and max(errs) < 2e-7, errs
