"""The CUDA many-light kernel (csrc/gather_many.cu) against its plain
PyTorch version on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (tests/conftest.py imports JAX, so skip
it there):

    python -m pytest tests/test_torch_gpu_many.py -m gpu --noconftest -q

Without a GPU every test skips.  The cases are those of
test_torch_gather_many.py: 2,049 and 4,096 slots at random 80% validity, a
valid range inside the last 256-slot tile only, 50 valid slots of 8,192, no
valid slot; invalid slots holding NaN and a sample's own position; samples
on a valid light; a third of the weights zero and a dead tail of planes.
"""

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch.ops.kernels import gather_many as tmany

RADIUS = 0.3
CASES = [(2049, "random"), (4096, "random"), (4096, "last_tile"),
         (8192, "sparse"), (3000, "none")]


def inputs(L, kind, R=96, C=1024, seed=3):
    rs = np.random.RandomState(seed + L)
    planes = [(rs.randn(R, C) * 8 + 15).astype(np.float32) for _ in range(3)]
    w = (rs.rand(R, C) * 0.01).astype(np.float32)
    w[rs.rand(R, C) < 0.3] = 0.0
    w[R // 2:] = 0.0  # whole blocks of dead samples
    lpos = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(L) * 20).astype(np.float32)
    valid = np.zeros(L, bool)
    if kind == "random":
        valid = rs.rand(L) < 0.8
    elif kind == "last_tile":
        valid[L - 200:L - 40] = True
    elif kind == "sparse":
        valid[rs.choice(L, 50, replace=False)] = True
    bad = np.nonzero(~valid)[0]
    lpos[bad[0]] = np.nan
    lint[bad[0]] = np.nan
    lpos[bad[1]] = [planes[c][0, 0] for c in range(3)]
    good = np.nonzero(valid)[0]
    if good.size:
        for c in range(3):
            planes[c][0, 1] = lpos[good[0], c]  # a sample on a valid light
    cuda = lambda a: torch.as_tensor(a).cuda()
    return [cuda(a) for a in (*planes, w, lpos, lint, valid)]


@pytest.mark.gpu
@pytest.mark.parametrize("L,kind", CASES)
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_cuda_many_kernel_matches_plain_version(sphere, L, kind):
    """rtol 2e-5 (the same terms in the same order; the plain version's
    vectorised arithmetic may differ by an ulp); zero weight gives 0; no
    valid slot gives 0 everywhere; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args = inputs(L, kind)
    n0 = tmany.launches["many"]
    got = tmany.gather_many(*args, sphere=sphere, radius=RADIUS)
    ref = tmany.gather_many_reference(*args, sphere=sphere, radius=RADIUS)
    torch.cuda.synchronize()
    assert tmany.launches["many"] == n0 + 1
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    assert not got[args[3] == 0].any()
    if kind == "none":
        assert not got.any()
    else:
        assert (got[args[3] != 0] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)


@pytest.mark.gpu
def test_cuda_many_kernel_takes_flat_and_lane_planes():
    """Any plane shape is read flat: the (R, C) result equals the flat one
    and the transposed lane planes' result, element for element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args = inputs(4096, "random")
    a = tmany.gather_many(*args, sphere=False)
    b = tmany.gather_many(*(t.reshape(-1) for t in args[:4]), *args[4:],
                          sphere=False)
    c = tmany.gather_many(*(t.T.contiguous() for t in args[:4]), *args[4:],
                          sphere=False)
    torch.cuda.synchronize()
    assert torch.equal(a.reshape(-1), b) and torch.equal(a, c.T)


def slot_view(R=4096, C=144, seed=4):
    """Slot planes as a ViewCache holds them: most rays dead (a zero row),
    a live ray's samples on a prefix of its slots with zero-weight gaps, so
    whole spans of the flat planes are dead and others partly live."""
    rs = np.random.RandomState(seed)
    planes = [(rs.randn(R, C) * 8 + 15).astype(np.float32) for _ in range(3)]
    w = (rs.rand(R, C) * 0.01).astype(np.float32)
    used = np.where(rs.rand(R) < 0.25, rs.randint(1, C + 1, R), 0)
    w[np.arange(C)[None, :] >= used[:, None]] = 0.0
    w[rs.rand(R, C) < 0.2] = 0.0
    w[R // 3:R // 2] = 0.0  # a long all-dead stretch
    return planes + [w]


@pytest.mark.gpu
@pytest.mark.parametrize("L,n_valid", [(3000, 1500), (6000, 5000)],
                         ids=["one_stage", "chunks"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_cuda_many_kernel_takes_live_samples_only(sphere, L, n_valid):
    """Slot-view planes (dead rays, partly live rows, an all-dead stretch)
    against the plain version at rtol 2e-5, with valid slots that fit one
    stage of 2,048 and more than fit (re-staged per batch); every
    zero-weight sample is written 0, every live one is > 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    rs = np.random.RandomState(L)
    lpos = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(L) * 20).astype(np.float32)
    valid = np.zeros(L, bool)
    valid[rs.choice(L, n_valid, replace=False)] = True
    cuda = lambda a: torch.as_tensor(a).cuda()
    planes = [cuda(a) for a in slot_view()]
    lights = [cuda(a) for a in (lpos, lint, valid)]
    got = tmany.gather_many(*planes, *lights, sphere=sphere, radius=RADIUS)
    ref = tmany.gather_many_reference(*planes, *lights, sphere=sphere,
                                      radius=RADIUS)
    torch.cuda.synchronize()
    live = planes[3] != 0
    assert torch.isfinite(got).all() and not got[~live].any()
    assert (got[live] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)
