"""The many-light gather's plain PyTorch version against the JAX package's
XLA oracle (``gather_xla``) and its Pallas kernel ``gather_mxu`` (interpret
mode on the CPU), the ``gather_planes`` route above SMEM_LIGHT_LIMIT slots
in both layouts, and the wrapper's dispatch rules.  The CUDA kernel itself
runs only on a GPU (test_torch_gpu_many.py).

Two bounds, one per reference.  Against the oracle, rtol 2e-5 per sample:
both take d^2 by direct differences, only the summation order and XLA:CPU's
contracted multiply-adds differ, and the latter moves a term by more than
that near a guard surface, so samples within MARGIN of one are left out
(as in test_torch_gather_segments.py).  Against the Pallas kernel, the JAX
suite's own rtol 2e-3 / atol 1e-5 (tests/test_gather.py): its d^2 comes off
a matmul expansion, |p|^2 + |l|^2 - 2 p.l, which costs up to ~1e-4 in d^2
(PARITY #8), which a sphere's 1/(d - r)^2 amplifies near its surface, so
the same samples are left out; the port does not have that error."""

import numpy as np
import pytest
import torch

from test_torch_gather_segments import far_weights
from volumerenderer_tpu.ops import gather as jgather
from volumerenderer_tpu_torch.ops import gather as tgather
from volumerenderer_tpu_torch.ops.kernels import gather_many as tmany

T = torch.as_tensor
N = 1536  # samples of the (N, 3) comparisons
CP, RC = 12, 256  # planes of the gather_planes comparisons
RADIUS = 0.3
MARGIN = 0.3
CENTER = np.float32([15.0, 15.0, 15.0])  # the volume centre of the scene
# (L, validity pattern): random 80% validity (not a contiguous range), a
# range inside the last 256-slot tile only, 50 scattered valid slots of
# 8,192, and no valid slot.
CASES = [(2049, "random"), (4096, "random"), (4096, "last_tile"),
         (8192, "sparse"), (3000, "none")]
IDS = [f"{L}-{kind}" for L, kind in CASES]


def lights(L, kind, seed=21):
    """Light slots from a seed: positions around the samples, invalid slots
    holding NaN (position and intensity) and a sample's own position."""
    rs = np.random.RandomState(seed + L)
    lpos = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(L) * 20).astype(np.float32)
    if kind == "random":
        valid = rs.rand(L) < 0.8
    elif kind == "last_tile":
        valid = np.zeros(L, bool)
        valid[L - 200:L - 40] = True
    elif kind == "sparse":
        valid = np.zeros(L, bool)
        valid[rs.choice(L, 50, replace=False)] = True
    else:
        valid = np.zeros(L, bool)
    bad = np.nonzero(~valid)[0]
    lpos[bad[0]] = np.nan
    lint[bad[0]] = np.nan
    lpos[bad[1]] = samples()[0]
    return lpos, lint, valid


def samples(seed=5):
    rs = np.random.RandomState(seed)
    return (rs.randn(N, 3) * 8 + 15).astype(np.float32)


def gap(points, lpos, valid, sphere):
    """Each point's distance to the nearest guard surface of the valid
    lights (f64): the light itself, or its sphere's surface."""
    if not valid.any():
        return np.full(points.shape[:-1], np.inf)
    p = points.reshape(-1, 3).astype(np.float64)
    d = np.linalg.norm(p[:, None, :] - lpos[valid][None].astype(np.float64),
                       axis=-1)
    g = np.abs(d - RADIUS) if sphere else d
    return g.min(-1).reshape(points.shape[:-1])


def port_gather(s, lpos, lint, valid, sphere):
    return tgather.gather(T(s), T(lpos), T(lint), T(valid), sphere=sphere,
                          radius=RADIUS).numpy()


@pytest.mark.parametrize("L,kind", CASES, ids=IDS)
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_plain_matches_xla_oracle_and_pallas_interpret(sphere, L, kind):
    s = samples()
    lpos, lint, valid = lights(L, kind)
    got = port_gather(s, lpos, lint, valid, sphere)
    assert got.shape == (N,) and np.isfinite(got).all()
    if kind == "none":
        assert not got.any()
    else:
        assert np.count_nonzero(got) > N // 2
    far = gap(s, lpos, valid, sphere) > MARGIN
    oracle = np.asarray(jgather.gather_xla(s, lpos, lint, valid,
                                           sphere=sphere, radius=RADIUS))
    np.testing.assert_allclose(got[far], oracle[far], rtol=2e-5, atol=0)
    pallas = np.asarray(jgather.gather(s, lpos, lint, valid, sphere=sphere,
                                       radius=RADIUS, impl="mxu_interpret",
                                       center=CENTER))
    np.testing.assert_allclose(got[far], pallas[far], rtol=2e-3, atol=1e-5)
    assert tmany.launches["many"] == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_guard_samples(sphere):
    """Sample 0 on an invalid slot (it adds nothing), sample 1 on a valid
    light (a sphere's centre), sample 2 at 0.005 from one and sample 3 on a
    sphere's surface: every guarded term is exactly 0, so the sums are
    finite and match the oracle, which guards the same terms."""
    s = samples()
    lpos, lint, valid = lights(2049, "random")
    k = np.nonzero(valid)[0][:3]
    s[1] = lpos[k[0]]
    s[2] = lpos[k[1]] + np.float32([0.005, 0.0, 0.0])
    s[3] = lpos[k[2]] + np.float32([RADIUS, 0.0, 0.0])
    got = port_gather(s, lpos, lint, valid, sphere)
    assert np.isfinite(got).all() and (got[:4] > 0).all()
    oracle = np.asarray(jgather.gather_xla(s, lpos, lint, valid,
                                           sphere=sphere, radius=RADIUS))
    np.testing.assert_allclose(got[:4], oracle[:4], rtol=2e-5, atol=0)


def plane_case(L, kind):
    rs = np.random.RandomState(8)
    planes = [(rs.randn(CP, RC) * 8 + 15).astype(np.float32)
              for _ in range(3)]
    w = (rs.rand(CP, RC) * 0.01).astype(np.float32)
    w[rs.rand(CP, RC) < 0.3] = 0.0
    w[:, -16:] = 0.0  # dead lanes
    return planes, w, lights(L, kind)


@pytest.mark.parametrize("layout", ["slots", "lanes"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_gather_planes_above_limit_matches_jax(sphere, layout):
    """gather_planes over more than SMEM_LIGHT_LIMIT slots: (R, C) weighted
    sums (slots) or (Rc,) per-lane sums (lanes), against the JAX route to
    gather_mxu (interpret) and the XLA oracle; weights near a guard surface
    zeroed for the oracle comparison."""
    L = tgather.SMEM_LIGHT_LIMIT + 952
    planes, w, (lpos, lint, valid) = plane_case(L, "random")
    w = far_weights(w, gap(np.stack(planes, -1), lpos, valid, sphere), None)
    kw = dict(sphere=sphere, radius=RADIUS, layout=layout)
    got = tgather.gather_planes(*map(T, planes), T(w), T(lpos), T(lint),
                                T(valid), **kw).numpy()
    want_shape = (CP, RC) if layout == "slots" else (RC,)
    assert got.shape == want_shape and np.count_nonzero(got) > RC // 2
    oracle = np.asarray(jgather.gather_planes(*planes, w, lpos, lint, valid,
                                              impl="xla", **kw))
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=0)
    pallas = np.asarray(jgather.gather_planes(
        *planes, w, lpos, lint, valid, impl="mxu_interpret", center=CENTER,
        **kw))
    np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=1e-5)
    assert not got[..., -16:].any()


@pytest.mark.parametrize("layout", ["slots", "lanes"])
def test_paired_is_ignored_above_limit(layout):
    """The reference package's many-light route has no paired tier: the
    flag changes nothing, bit for bit."""
    planes, w, (lpos, lint, valid) = plane_case(4096, "random")
    args = (*map(T, planes), T(w), T(lpos), T(lint), T(valid))
    a = tgather.gather_planes(*args, sphere=True, radius=RADIUS,
                              layout=layout, paired=False)
    b = tgather.gather_planes(*args, sphere=True, radius=RADIUS,
                              layout=layout, paired=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_dispatch_and_validation():
    """CPU tensors run the plain version (no launch); the wrapper takes
    same-shaped C-contiguous f32 planes of any rank, (L, 3) f32 positions,
    (L,) f32 intensities and (L,) bool validity, and raises on anything
    else; the tile flags mark each 256-slot tile holding a valid slot."""
    planes, w, (lpos, lint, valid) = plane_case(4096, "last_tile")
    args = [T(a) for a in (*planes, w, lpos, lint)]
    v = T(valid)
    n0 = tmany.launches["many"]
    a = tmany.gather_many(*args, v, sphere=False)
    b = tmany.gather_many_reference(*args, v, sphere=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    flat = tmany.gather_many(*(t.reshape(-1) for t in args[:4]), *args[4:],
                             v, sphere=False)
    np.testing.assert_array_equal(flat.numpy(), a.numpy().reshape(-1))
    assert tmany.launches["many"] == n0 == 0
    flags = tmany.tile_flags(v).numpy()
    assert flags.dtype == np.int32 and flags.tolist() == [0] * 15 + [1]
    assert tmany.tile_flags(T(valid[:2049])).shape == (9,)
    with pytest.raises(TypeError):
        tmany.gather_many(*args[:3], args[3].double(), *args[4:], v,
                          sphere=False)
    with pytest.raises(TypeError):
        tmany.gather_many(*args, v.to(torch.int32), sphere=False)
    with pytest.raises(ValueError):
        tmany.gather_many(args[0][:, :-1], *args[1:], v, sphere=False)
    with pytest.raises(ValueError):
        tmany.gather_many(*args[:4], args[4].T.contiguous().T, args[5], v,
                          sphere=False)
    with pytest.raises(ValueError):
        tmany.gather_many(*args[:4], args[4], args[5][:-1], v, sphere=False)
    with pytest.raises(ValueError):
        tmany.gather_many(*(t.to("meta") for t in args), v.to("meta"),
                          sphere=False)
