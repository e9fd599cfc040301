"""The CUDA segment kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (tests/conftest.py imports JAX, so skip
it there):

    python -m pytest tests/test_torch_gpu_segments.py -m gpu --noconftest -q

Without a GPU every test skips.  The inputs hold the kernels' edge cases:
segments of zero length, of ns = 0 and of ns % 4 != 0, one of more than
512 sub-lights, a valid range with start > 0 and an odd count, samples on
a sub-light (a Beam centre), inside a beam and far along a segment's line.
"""

import numpy as np
import pytest
import torch

from volumerenderer_tpu_torch.ops.kernels import gather_segments as tseg

CP, RC, STEP, RADIUS = 24, 2048, 0.3, 0.25
ANALYTIC = [dict(sphere_radius=r, quad_rule=rule, paired=p)
            for r, rule in ((None, "midpoint"), (RADIUS, "midpoint"),
                            (RADIUS, "tangent"), (RADIUS, "closed"))
            for p in (False, True)]
ANALYTIC_IDS = [f"{v}_{t}" for v in ("vrl", "midpoint", "tangent", "closed")
                for t in ("exact", "paired")]
VARIANTS = (
    [("discrete", dict(sphere_radius=r, paired=p))
     for r in (None, RADIUS) for p in (False, True)]
    + [("analytic", kw) for kw in ANALYTIC]
)


def inputs(seed=5):
    rs = np.random.RandomState(seed)
    need = np.sort(rs.randint(0, CP + 1, RC))[::-1].astype(np.int32)
    need[-RC // 8:] = 0
    planes = [(rs.randn(CP, RC) * 8 + 15).astype(np.float32)
              for _ in range(3)]
    w = (rs.rand(CP, RC) * 0.01).astype(np.float32)
    w[np.arange(CP)[:, None] >= need[None, :]] = 0.0
    L = 10
    pf = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt[2] = pf[2]  # zero length
    pt[3] = pf[3] + np.float32([0.2, 0.0, 0.0])  # ns = 0
    pt[4] = pf[4] + np.float32([0.0, 1.6, 0.0])  # ns = 5
    pt[5] = pf[5] + np.float32([160.0, 0.0, 0.0])  # 533 sub-lights
    u = (pt[1] - pf[1]) / np.linalg.norm(pt[1] - pf[1])
    perp = np.float32([u[1], -u[0], 0.0]) / np.linalg.norm(u[:2])
    special = [pf[1], pf[1] + u * (3 * STEP), pf[1] + u + perp * 0.1,
               pf[1] - u * 50.0, pt[1] + u * 50.0]
    for i, p in enumerate(special):
        for c in range(3):
            planes[c][0, i] = p[c]
    inten = (rs.rand(L) * 30).astype(np.float32)
    valid = (np.arange(L) >= 1) & (np.arange(L) < 8)  # start 1, count 7
    return planes + [w, pf, pt, inten, valid], need


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw", VARIANTS)
def test_cuda_kernel_matches_plain_version(kind, kw):
    """Each kernel against its plain version on the card, same tier: rtol
    2e-5 (the same terms in the same order; the discrete kernel's FMA and
    approximate reciprocal round them differently)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    arrays, need = inputs()
    args = [torch.as_tensor(a).cuda() for a in arrays]
    need = torch.as_tensor(need).cuda()
    n0 = tseg.launches[kind]
    if kind == "discrete":
        got = tseg.gather_segments_discrete_lanes(*args, STEP,
                                                  lane_need=need, **kw)
        ref = tseg.gather_segments_discrete_lanes_reference(
            *args, STEP, lane_need=need, **kw)
    else:
        got = tseg.gather_segments_analytic_lanes(*args, lane_need=need, **kw)
        ref = tseg.gather_segments_analytic_lanes_reference(
            *args, lane_need=need, **kw)
    torch.cuda.synchronize()
    assert tseg.launches[kind] == n0 + 1
    assert torch.isfinite(got).all() and got.abs().max() > 0
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)


def chunked_segments():
    """2,500 short segments on the card, valid from 3: 2,497, more than one
    chunk of 1,024 and an odd count (the paired forms' tail)."""
    rs = np.random.RandomState(6)
    L = 2500
    pf = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt = pf + (rs.randn(L, 3) * 0.6).astype(np.float32)
    inten = (rs.rand(L) * 30).astype(np.float32)
    valid = np.arange(L) >= 3
    return [torch.as_tensor(a).cuda() for a in (pf, pt, inten, valid)]


@pytest.mark.gpu
def test_cuda_kernels_take_more_than_one_chunk():
    """More than 1024 segments: the kernels re-stage the segment table for
    each sample and keep one running sum per sample."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    arrays, need = inputs()
    args = [torch.as_tensor(a).cuda() for a in arrays[:4]] + chunked_segments()
    need = torch.as_tensor(need).cuda()
    for kw in (dict(sphere_radius=RADIUS, paired=False),
               dict(sphere_radius=None, paired=True)):
        got = tseg.gather_segments_discrete_lanes(*args, STEP,
                                                  lane_need=need, **kw)
        ref = tseg.gather_segments_discrete_lanes_reference(
            *args, STEP, lane_need=need, **kw)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2e-5, atol=0)
    for kw in (dict(sphere_radius=None, paired=True),
               dict(sphere_radius=RADIUS, quad_rule="closed", paired=True),
               dict(sphere_radius=RADIUS, quad_rule="tangent", paired=False)):
        got = tseg.gather_segments_analytic_lanes(*args, lane_need=need, **kw)
        ref = tseg.gather_segments_analytic_lanes_reference(
            *args, lane_need=need, **kw)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2e-5, atol=0)


def staging_inputs(lengths, seed=8):
    """Planes of every lane need 0..CP (each remainder modulo the samples a
    thread takes), a third of the weights zero inside the needs, and
    segments of the given lengths along x, valid on [2, len - 1)."""
    rs = np.random.RandomState(seed)
    need = np.sort(np.arange(RC) % (CP + 1))[::-1].astype(np.int32)
    planes = [(rs.randn(CP, RC) * 8 + 15).astype(np.float32)
              for _ in range(3)]
    w = (rs.rand(CP, RC) * 0.01).astype(np.float32)
    w[rs.rand(CP, RC) < 0.3] = 0.0
    w[np.arange(CP)[:, None] >= need[None, :]] = 0.0
    L = len(lengths)
    pf = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt = pf + np.float32(lengths)[:, None] * np.float32([1.0, 0.0, 0.0])
    inten = (rs.rand(L) * 30).astype(np.float32)
    valid = (np.arange(L) >= 2) & (np.arange(L) < L - 1)
    cuda = lambda a: torch.as_tensor(a).cuda()
    return [cuda(a) for a in planes + [w, pf, pt, inten, valid]], cuda(need)


DISCRETE = [dict(sphere_radius=r, paired=p) for r in (None, RADIUS)
            for p in (False, True)]
# Sub-light counts at STEP 0.3: ns = 0 (0.1, 0.25), 1-3 (paired overruns),
# 5, and long segments; the first table fits one stage of 2,048 entries,
# the second (2 x 1,000 + the rest) does not.
ONE_STAGE = [0.1, 0.35, 150.0, 0.25, 0.7, 1.6, 0.1, 60.0, 0.95, 2.0]
TWO_STAGES = [0.1, 0.35, 300.0, 0.25, 0.7, 1.6, 300.0, 0.1, 0.95, 60.0,
              2.0]


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [ONE_STAGE, TWO_STAGES],
                         ids=["one_stage", "two_stages"])
@pytest.mark.parametrize("kw", DISCRETE, ids=["ray_exact", "ray_paired",
                                              "beam_exact", "beam_paired"])
def test_cuda_discrete_kernel_staged_table(kw, lengths):
    """The discrete kernel's staged sub-light table, each template against
    its plain version at rtol 2e-5: one stage and more than one (a
    segment's sub-lights split between two stages), segments of ns = 0
    and paired overruns between long ones, every lane need modulo the
    samples a thread takes, zero-weight rows inside the needs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    args, need = staging_inputs(lengths)
    _, ns, *_ = tseg.discrete_cols(*args[4:], STEP)
    assert (int(ns.sum()) > 2048) == (lengths is TWO_STAGES)
    got = tseg.gather_segments_discrete_lanes(*args, STEP, lane_need=need,
                                              **kw)
    ref = tseg.gather_segments_discrete_lanes_reference(
        *args, STEP, lane_need=need, **kw)
    torch.cuda.synchronize()
    lit = (args[3] != 0).any(0)  # lanes with a nonzero weight
    assert torch.isfinite(got).all()
    assert not got[~lit].any() and (got[lit] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", DISCRETE, ids=["ray_exact", "ray_paired",
                                              "beam_exact", "beam_paired"])
def test_cuda_discrete_kernel_without_sublights(kw):
    """Valid segments all shorter than a step (no sub-light), and no valid
    segment: every lane is 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    args, need = staging_inputs([0.1, 0.2, 0.25, 0.05])
    for valid in (args[7], torch.zeros_like(args[7])):
        got = tseg.gather_segments_discrete_lanes(
            *args[:7], valid, STEP, lane_need=need, **kw)
        torch.cuda.synchronize()
        assert got.shape == (RC,) and not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("segments", ["one_chunk", "three_chunks"])
@pytest.mark.parametrize("kw", ANALYTIC, ids=ANALYTIC_IDS)
def test_cuda_analytic_kernel_on_the_live_sample_loop(kw, segments):
    """The lane analytic kernel on the live-sample loop, each variant and
    tier against its plain version at rtol 2e-5 (paired VRL also against
    the exact plain version at 3e-5): lane needs below Cp on most lanes
    (every need 0..CP), a third of the weights zero inside the needs, and
    a table of one chunk (the staging table, segments up to 150 long) or
    of 2,497 segments (three chunks, an odd count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    args, need = staging_inputs(ONE_STAGE)
    if segments == "three_chunks":
        args = args[:4] + chunked_segments()
    assert float((need < CP).double().mean()) > 0.9
    n0 = tseg.launches["analytic"]
    got = tseg.gather_segments_analytic_lanes(*args, lane_need=need, **kw)
    ref = tseg.gather_segments_analytic_lanes_reference(*args,
                                                        lane_need=need, **kw)
    torch.cuda.synchronize()
    assert tseg.launches["analytic"] == n0 + 1
    lit = (args[3] != 0).any(0)  # lanes with a nonzero weight
    assert torch.isfinite(got).all()
    assert not got[~lit].any() and (got[lit] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)
    if kw["sphere_radius"] is None and kw["paired"]:
        exact = tseg.gather_segments_analytic_lanes_reference(
            *args, lane_need=need, sphere_radius=None)
        np.testing.assert_allclose(got.cpu().numpy(), exact.cpu().numpy(),
                                   rtol=3e-5, atol=0)
