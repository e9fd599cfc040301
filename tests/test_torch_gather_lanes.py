"""The lane gather's plain PyTorch version against the JAX package's Pallas
kernel (interpret mode on the CPU) and XLA oracle, its summation order, and
the wrapper's dispatch rules.  The CUDA kernel itself runs only on a GPU
(the ``gpu`` tests, which need neither JAX nor tests/conftest.py:

    python -m pytest tests/test_torch_gather_lanes.py -m gpu --noconftest -q
)."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from volumerenderer_tpu.ops import gather as jgather
    from volumerenderer_tpu.ops.pallas import gather_lanes as jlanes
except ImportError:  # a machine with only PyTorch runs the gpu tests alone
    jnp = jgather = jlanes = None
from volumerenderer_tpu_torch.ops import gather as tgather
from volumerenderer_tpu_torch.ops.kernels import gather_lanes as tlanes

T = torch.as_tensor
CP, RC = 24, 2048
# L -> (start, count): start > 0 and count % 4 != 0 where L allows it.
RANGES = {0: (0, 0), 1: (0, 1), 5: (1, 3), 37: (4, 30)}


def case(L, seed=11):
    """Planes with weights zero past each lane's need (sorted descending,
    zeros at the tail) and a light table, from a seed."""
    rs = np.random.RandomState(seed + L)
    need = np.sort(rs.randint(0, CP + 1, RC))[::-1].astype(np.int32)
    need[-RC // 8:] = 0
    px, py, pz = ((rs.randn(CP, RC) * 8 + 15).astype(np.float32)
                  for _ in range(3))
    w = (rs.rand(CP, RC) * 0.01).astype(np.float32)
    w[np.arange(CP)[:, None] >= need[None, :]] = 0.0
    lpos = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(L) * 20).astype(np.float32)
    start, count = RANGES[L]
    return px, py, pz, w, lpos, lint, need, start, count


def port(px, py, pz, w, lpos, lint, need, start, count, *, sphere, paired):
    return tlanes.gather_lanes(
        T(px), T(py), T(pz), T(w), T(lpos), T(lint), start, count,
        sphere=sphere, radius=0.3, lane_need=T(need), paired=paired,
    ).numpy()


@pytest.mark.parametrize("L", sorted(RANGES))
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_plain_version_matches_pallas_interpret_and_xla(sphere, paired, L):
    """Exact tier within rtol 2e-5 of the Pallas kernel (FMA contraction
    and summation order, PARITY #12); paired tier within rtol 2e-5 of the
    Pallas paired tier and 3e-5 of the exact oracle (PARITY #15)."""
    px, py, pz, w, lpos, lint, need, start, count = c = case(L)
    got = port(*c, sphere=sphere, paired=paired)
    lpos_j = lpos if L else np.zeros((1, 3), np.float32)  # Pallas needs L >= 1
    lint_j = lint if L else np.zeros(1, np.float32)
    want = np.asarray(jlanes.gather_lanes(
        px, py, pz, w, lpos_j, lint_j, start, count, sphere=sphere,
        radius=0.3, lane_need=jnp.asarray(need), paired=paired,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    valid = (np.arange(L) >= start) & (np.arange(L) < start + count)
    oracle = np.asarray(jgather.gather_planes(
        px, py, pz, w, lpos_j, lint_j, valid if L else np.zeros(1, bool),
        sphere=sphere, radius=0.3, impl="xla", layout="lanes"))
    np.testing.assert_allclose(got, oracle, rtol=3e-5 if paired else 2e-5,
                               atol=0)
    assert tlanes.launches == 0  # CPU tensors never reach the kernel


def test_gather_xla_plain_matches_jax():
    rs = np.random.RandomState(5)
    samples = (rs.randn(700, 3) * 8 + 15).astype(np.float32)
    lpos = (rs.randn(900, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(900) * 20).astype(np.float32)
    valid = rs.rand(900) < 0.8
    for sphere in (False, True):
        want = np.asarray(jgather.gather_xla(samples, lpos, lint, valid,
                                             sphere=sphere, radius=0.3))
        got = tgather.gather_xla(T(samples), T(lpos), T(lint), T(valid),
                                 sphere=sphere, radius=0.3).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5)


def test_wrapper_dispatch_and_validation():
    px, py, pz, w, lpos, lint, need, start, count = case(37)
    args = [T(a) for a in (px, py, pz, w, lpos, lint)]
    n0 = tlanes.launches
    a = tlanes.gather_lanes(*args, start, count, sphere=False,
                            lane_need=T(need))
    b = tlanes.gather_lanes_reference(*args, start, count, sphere=False,
                                      lane_need=T(need))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tlanes.launches == n0 == 0
    # lane_need derived from the weights when not given.
    np.testing.assert_array_equal(tlanes.lane_need_of(T(w)).numpy(), need)
    with pytest.raises(TypeError):
        tlanes.gather_lanes(*args[:3], args[3].double(), *args[4:], start,
                            count, sphere=False)
    with pytest.raises(TypeError):
        tlanes.gather_lanes(*args, start, count, sphere=False,
                            lane_need=T(need).long())
    with pytest.raises(ValueError):
        tlanes.gather_lanes(args[0][:, :-1], *args[1:], start, count,
                            sphere=False)
    with pytest.raises(ValueError):
        tlanes.gather_lanes(*args[:4], args[4].T.contiguous().T, args[5],
                            start, count, sphere=False)
    with pytest.raises(ValueError):
        tlanes.gather_lanes(*(t.to("meta") for t in args), start, count,
                            sphere=False, lane_need=T(need).to("meta"))


def test_gather_planes_many_lights_not_ported():
    """More than SMEM_LIGHT_LIMIT slots (not ported until the many-light
    gather was): the lane layout returns the per-lane sum over samples of
    the many-light plain version's weighted sums, bit for bit."""
    from volumerenderer_tpu_torch.ops.kernels import gather_many as tmany

    px, py, pz, w, *_ = case(1)
    L = tgather.SMEM_LIGHT_LIMIT + 1
    rs = np.random.RandomState(4)
    lpos = T((rs.randn(L, 3) * 8 + 15).astype(np.float32))
    lint = T((rs.rand(L) * 20).astype(np.float32))
    valid = T(rs.rand(L) < 0.5)
    planes = (T(px), T(py), T(pz), T(w))
    got = tgather.gather_planes(*planes, lpos, lint, valid, sphere=False)
    want = tmany.gather_many_reference(*planes, lpos, lint, valid,
                                       sphere=False).sum(0)
    assert got.shape == (RC,) and got.any()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # layout="slots": the same planes as (R, C) slots, per-sample sums.
    out = tgather.gather_planes(T(px), T(py), T(pz), T(w), torch.zeros(1, 3),
                                torch.ones(1), torch.ones(1, dtype=torch.bool),
                                sphere=False, layout="slots")
    assert out.shape == px.shape
    rows = torch.zeros(RC)  # a lane's samples in row order, as lanes sum
    for r in out:
        rows = rows + r
    np.testing.assert_array_equal(rows.numpy(), tgather.gather_planes(
        T(px), T(py), T(pz), T(w), torch.zeros(1, 3), torch.ones(1),
        torch.ones(1, dtype=torch.bool), sphere=False).numpy())


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_plain_version_sums_in_kernel_order(sphere, paired):
    """The plain version adds a used sample's lights in table order (paired:
    its groups of 4 in order, overrun slots at (n = 0, q = 1)) and a lane's
    w * sum in row order, as the kernel does: bit for bit against those
    sums written out in numpy, one light at a time, with a sample on a
    light (a sphere's centre) and a range from 4 of 30 lights."""
    px, py, pz, w, lpos, lint, need, start, count = case(37)
    for c, p in enumerate((px, py, pz)):
        p[0, 0] = lpos[start, c]
    rad = np.float32(0.3) if sphere else None
    li = lint * np.float32(tlanes._INV_FOUR_PI)
    span = -(-count // 4) * 4 if paired else count
    k = np.minimum(start + np.arange(span), len(lpos) - 1)
    use = np.arange(CP)[:, None] < need[None, :]
    x, y, z = (T(p[use])[:, None] for p in (px, py, pz))
    d2e, bad = (t.numpy() for t in tlanes._d2e_bad(
        x, y, z, *(T(lpos[k, c]) for c in range(3)), rad))
    acc = np.zeros(d2e.shape[0], np.float32)
    one, zero = np.float32(1.0), np.float32(0.0)
    if paired:
        bad = bad | (np.arange(span) >= count)
        n = np.where(bad, zero, li[k])
        q = np.where(bad, one, d2e)
        for g in range(span // 4):
            n1, n2, n3, n4 = (n[:, 4 * g + i] for i in range(4))
            q1, q2, q3, q4 = (q[:, 4 * g + i] for i in range(4))
            q12, q34 = q1 * q2, q3 * q4
            n12, n34 = n1 * q2 + n2 * q1, n3 * q4 + n4 * q3
            acc = acc + (n12 * q34 + n34 * q12) / (q12 * q34)
    else:
        for t in range(span):
            term = li[k[t]] / np.maximum(d2e[:, t], np.float32(tlanes.GUARD))
            acc = acc + np.where(bad[:, t], zero, term)
    full = np.zeros((CP, RC), np.float32)
    full[use] = acc
    want = np.zeros(RC, np.float32)
    for j in range(CP):
        want = want + np.where(use[j], w[j] * full[j], zero)
    got = port(px, py, pz, w, lpos, lint, need, start, count, sphere=sphere,
               paired=paired)
    assert bad.any() and np.count_nonzero(want) > RC // 2
    np.testing.assert_array_equal(got, want)


GPU_CASES = ["range_4_30", "all_dead", "empty_range", "slots_2048",
             "slots_2500"]


def gpu_case(kind):
    """Lane planes and lights of one kernel case on the card: 37 slots with
    the range (4, 30) (start > 0, count % 4 = 2); every weight 0; an empty
    range; 2,048 slots, all valid (one stage of the kernel's table); 2,500
    slots with the range (3, 2497) (re-staged).  Sample (0, 0) sits on
    the range's first light (a sphere's centre)."""
    px, py, pz, w, lpos, lint, need, start, count = case(37)
    if kind == "all_dead":
        w = np.zeros_like(w)
    elif kind == "empty_range":
        count = 0
    elif kind.startswith("slots"):
        L = int(kind.split("_")[1])
        rs = np.random.RandomState(L)
        lpos = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
        lint = (rs.rand(L) * 20).astype(np.float32)
        start, count = (0, L) if L == 2048 else (3, L - 3)
    for c, p in enumerate((px, py, pz)):
        p[0, 0] = lpos[start, c]
    cuda = lambda a: T(a).cuda()
    return ([cuda(a) for a in (px, py, pz, w, lpos, lint)], cuda(need), start,
            count)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", GPU_CASES)
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_cuda_kernel_matches_plain_version(sphere, paired, kind):
    """On a GPU: the CUDA kernel against its plain version on the card,
    rtol 2e-5 in the same tier (the plain version sums in the kernel's
    order; an FMA and an approximate reciprocal round the terms
    differently), the paired tier also within 3e-5 of the exact plain
    version; every weight 0 or an empty range gives zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args, need, start, count = gpu_case(kind)
    kw = dict(sphere=sphere, radius=0.3, lane_need=need)
    n0 = tlanes.launches
    got = tlanes.gather_lanes(*args, start, count, paired=paired, **kw)
    torch.cuda.synchronize()
    assert tlanes.launches == n0 + 1
    ref = tlanes.gather_lanes_reference(*args, start, count, paired=paired,
                                        **kw)
    exact = tlanes.gather_lanes_reference(*args, start, count, **kw)
    got, ref, exact = (t.cpu().numpy() for t in (got, ref, exact))
    assert np.isfinite(got).all()
    if kind in ("all_dead", "empty_range"):
        assert not got.any()
    else:
        assert np.count_nonzero(got) > RC // 2
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=0)
    np.testing.assert_allclose(got, exact, rtol=3e-5 if paired else 2e-5,
                               atol=0)
