"""The lane gather's plain PyTorch version against the JAX package's Pallas
kernel (interpret mode on the CPU) and XLA oracle, and the wrapper's
dispatch rules.  The CUDA kernel itself runs only on a GPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumerenderer_tpu.ops import gather as jgather
from volumerenderer_tpu.ops.pallas import gather_lanes as jlanes
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
    np.testing.assert_array_equal(out.sum(0).numpy(), tgather.gather_planes(
        T(px), T(py), T(pz), T(w), torch.zeros(1, 3), torch.ones(1),
        torch.ones(1, dtype=torch.bool), sphere=False).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_cuda_kernel_matches_plain_version(sphere, paired):
    """On a GPU: the CUDA kernel against its plain version on the card,
    rtol 2e-5 (exact) / 3e-5 (paired, against the exact plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    px, py, pz, w, lpos, lint, need, start, count = case(37)
    dev = lambda a: T(a).cuda()
    args = [dev(a) for a in (px, py, pz, w, lpos, lint)]
    n0 = tlanes.launches
    got = tlanes.gather_lanes(*args, start, count, sphere=sphere, radius=0.3,
                              lane_need=dev(need), paired=paired)
    assert tlanes.launches == n0 + 1
    ref = tlanes.gather_lanes_reference(*args, start, count, sphere=sphere,
                                        radius=0.3, lane_need=dev(need))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=3e-5 if paired else 2e-5, atol=0)
