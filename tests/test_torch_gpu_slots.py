"""The CUDA slot kernels (csrc/gather_vpu.cu) against their plain PyTorch
versions on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (tests/conftest.py imports JAX, so skip
it there):

    python -m pytest tests/test_torch_gpu_slots.py -m gpu --noconftest -q

Without a GPU every test skips.  The inputs reuse the segment kernels'
edge cases (test_torch_gpu_segments.inputs: zero-length, ns = 0, ns % 4
!= 0 and 533-sub-light segments, a range starting at 1 with an odd count,
samples on a sub-light, at a Beam centre and inside a beam) read as (R, C)
slots, with zero-weight samples among live ones and all-zero blocks.  The
discrete kernel's staged sub-light table takes the lane kernel's staging
cases (test_torch_gpu_segments.staging_inputs) read as slots.
"""

import numpy as np
import pytest
import torch

from test_torch_gpu_segments import (
    DISCRETE, ONE_STAGE, RADIUS, RC, STEP, TWO_STAGES, chunked_segments,
    inputs, staging_inputs,
)
from volumerenderer_tpu_torch.ops.kernels import gather_vpu as tvpu

KIND = {"vpu": "vpu", "discrete": "segment_discrete"}
VARIANTS = (
    [("vpu", dict(sphere=s, radius=RADIUS, paired=p))
     for s in (False, True) for p in (False, True)]
    + [("discrete", dict(sphere_radius=r, paired=p))
       for r in (None, RADIUS) for p in (False, True)]
    + [("analytic", dict(sphere_radius=r, quad_rule=rule, paired=p))
       for r, rule in ((None, "midpoint"), (RADIUS, "midpoint"),
                       (RADIUS, "tangent"), (RADIUS, "closed"))
       for p in (False, True)]
)


def slot_args(lights=1100):
    """(R, C) slot planes with every sixth sample and the tail blocks at
    zero weight, the segment table, and a light table of ``lights`` slots
    (two shared-memory chunks) with a valid range from 3."""
    arrays, _need = inputs()
    planes = [np.ascontiguousarray(a) for a in arrays[:4]]
    w = planes[3]
    w.reshape(-1)[::6] = 0.0
    w[-2:] = 0.0
    rs = np.random.RandomState(9)
    lpos = (rs.randn(lights, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(lights) * 20).astype(np.float32)
    cuda = lambda a: torch.as_tensor(a).cuda()
    return ([cuda(a) for a in planes], [cuda(a) for a in arrays[4:]],
            (cuda(lpos), cuda(lint)))


def run(kind, planes, segs, lights, kw, plain):
    if kind == "vpu":
        fn = tvpu.gather_vpu_reference if plain else tvpu.gather_vpu
        return fn(*planes, *lights, 3, lights[0].shape[0] - 5, **kw)
    if kind == "discrete":
        fn = (tvpu.gather_segments_discrete_reference if plain
              else tvpu.gather_segments_discrete)
        return fn(*planes, *segs, STEP, **kw)
    fn = (tvpu.gather_segments_analytic_reference if plain
          else tvpu.gather_segments_analytic)
    return fn(*planes, *segs, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw", VARIANTS)
def test_cuda_slot_kernel_matches_plain_version(kind, kw):
    """Each kernel against its plain version on the card, same tier: rtol
    2e-5 (the same terms in the same order; the plain version's
    vectorised arithmetic may differ by an ulp); zero weight gives 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, segs, lights = slot_args()
    key = KIND.get(kind) or ("segment_analytic"
                             if kw["sphere_radius"] is None
                             else "segment_sphere")
    n0 = tvpu.launches[key]
    got = run(kind, planes, segs, lights, kw, plain=False)
    ref = run(kind, planes, segs, lights, kw, plain=True)
    torch.cuda.synchronize()
    assert tvpu.launches[key] == n0 + 1
    assert got.shape == planes[0].shape
    assert torch.isfinite(got).all() and got.abs().max() > 0
    assert not got[planes[3] == 0].any()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)


@pytest.mark.gpu
def test_cuda_slot_kernels_take_more_than_one_chunk():
    """More than 1024 segments: each sample keeps one running sum across
    the staged chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, _, _ = slot_args()
    segs = chunked_segments()
    for kind, kw in (("discrete", dict(sphere_radius=RADIUS, paired=False)),
                     ("discrete", dict(sphere_radius=None, paired=True)),
                     ("analytic", dict(sphere_radius=None, paired=True)),
                     ("analytic", dict(sphere_radius=RADIUS,
                                       quad_rule="closed", paired=True))):
        got = run(kind, planes, segs, None, kw, plain=False)
        ref = run(kind, planes, segs, None, kw, plain=True)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2e-5, atol=0, err_msg=str(kw))


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("rule", ["midpoint", "tangent", "closed"])
def test_cuda_slot_vbl_kernel_takes_more_than_one_chunk(rule, paired):
    """The VBL kernel on the live-sample loop over 2,497 segments (three
    chunks, an odd count): each rule and tier against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, _, _ = slot_args()
    kw = dict(sphere_radius=RADIUS, quad_rule=rule, paired=paired)
    n0 = tvpu.launches["segment_sphere"]
    got = run("analytic", planes, chunked_segments(), None, kw, plain=False)
    ref = run("analytic", planes, chunked_segments(), None, kw, plain=True)
    torch.cuda.synchronize()
    assert tvpu.launches["segment_sphere"] == n0 + 1
    assert not got[planes[3] == 0].any() and got.abs().max() > 0
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("case", ["three_chunks", "no_segments", "all_dead",
                                  "ragged"])
def test_cuda_slot_vrl_kernel_on_the_live_sample_loop(case, paired):
    """The slots VRL kernel on the live-sample loop against its plain
    version at rtol 2e-5 (paired also against the exact plain version at
    3e-5): 2,497 segments (three chunks, an odd count for the paired
    tier's tail), no valid segment, every sample dead, and 24 x 2043
    samples (N not a multiple of the 512-sample span)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, segs, _ = slot_args()
    if case == "three_chunks":
        segs = chunked_segments()
    elif case == "no_segments":
        segs = segs[:3] + [torch.zeros_like(segs[3])]
    elif case == "all_dead":
        planes = planes[:3] + [torch.zeros_like(planes[3])]
    else:
        planes = [p[:, :RC - 5].contiguous() for p in planes]
        assert planes[0].numel() % 512 != 0
    kw = dict(sphere_radius=None, paired=paired)
    n0 = tvpu.launches["segment_analytic"]
    got = run("analytic", planes, segs, None, kw, plain=False)
    ref = run("analytic", planes, segs, None, kw, plain=True)
    torch.cuda.synchronize()
    assert tvpu.launches["segment_analytic"] == n0 + 1
    live = planes[3] != 0
    assert got.shape == planes[0].shape and torch.isfinite(got).all()
    assert not got[~live].any()
    if case in ("no_segments", "all_dead"):
        assert not got.any()
    else:
        assert (got[live] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)
    if paired:
        exact = run("analytic", planes, segs, None,
                    dict(sphere_radius=None, paired=False), plain=True)
        np.testing.assert_allclose(got.cpu().numpy(), exact.cpu().numpy(),
                                   rtol=3e-5, atol=0)


DISCRETE_IDS = ["ray_exact", "ray_paired", "beam_exact", "beam_paired"]


@pytest.mark.gpu
@pytest.mark.parametrize("cut", [0, 5], ids=["whole_spans", "ragged"])
@pytest.mark.parametrize("lengths", [ONE_STAGE, TWO_STAGES],
                         ids=["one_stage", "two_stages"])
@pytest.mark.parametrize("kw", DISCRETE, ids=DISCRETE_IDS)
def test_cuda_slot_discrete_kernel_staged_table(kw, lengths, cut):
    """The slots discrete kernel's staged sub-light table, each template
    against its plain version at rtol 2e-5 (paired also against the exact
    plain version at 3e-5): one stage and more than one (a segment split
    between two stages), segments of ns = 0 and paired overruns between
    long ones, a third of the samples dead, on 24 x 2048 samples (whole
    spans of 512) and 24 x 2043 (a ragged last span)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    args, _need = staging_inputs(lengths)
    planes = [a[:, :RC - cut].contiguous() for a in args[:4]]
    segs = args[4:]
    assert (planes[0].numel() % 512 == 0) == (cut == 0)
    n0 = tvpu.launches["segment_discrete"]
    got = tvpu.gather_segments_discrete(*planes, *segs, STEP, **kw)
    ref = tvpu.gather_segments_discrete_reference(*planes, *segs, STEP, **kw)
    torch.cuda.synchronize()
    assert tvpu.launches["segment_discrete"] == n0 + 1
    live = planes[3] != 0
    assert torch.isfinite(got).all()
    assert not got[~live].any() and (got[live] > 0).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=0)
    if kw["paired"]:
        exact = tvpu.gather_segments_discrete_reference(
            *planes, *segs, STEP, sphere_radius=kw["sphere_radius"])
        np.testing.assert_allclose(got.cpu().numpy(), exact.cpu().numpy(),
                                   rtol=3e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", DISCRETE, ids=DISCRETE_IDS)
def test_cuda_slot_discrete_kernel_without_sublights_or_live_samples(kw):
    """Valid segments all shorter than a step (no sub-light), no valid
    segment, and every sample dead: every sample is 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    args, _need = staging_inputs([0.1, 0.2, 0.25, 0.05])
    for valid in (args[7], torch.zeros_like(args[7])):
        got = tvpu.gather_segments_discrete(*args[:7], valid, STEP, **kw)
        torch.cuda.synchronize()
        assert got.shape == args[0].shape and not got.any()
    args, _need = staging_inputs(ONE_STAGE)
    got = tvpu.gather_segments_discrete(*args[:3], torch.zeros_like(args[3]),
                                        *args[4:], STEP, **kw)
    torch.cuda.synchronize()
    assert got.shape == args[0].shape and not got.any()


POINT_CASES = ["range_3_1095", "all_dead", "ragged", "empty_range",
               "slots_2048", "slots_2500"]


def point_case(kind):
    """Slot planes and a light range of one point-kernel case: 1,100 slots
    with the range (3, 1095) (start > 0, count % 4 = 3); every sample
    dead; 23 x 2043 samples (a ragged last span, N odd); an empty
    range; 2,048 slots, all valid (one stage of the table); 2,500 slots
    with the range (3, 2497) (re-staged for every batch).  Sample (0, 0)
    sits on the range's first light (a sphere's centre)."""
    planes, _, (lpos, lint) = slot_args()
    start, count = 3, lpos.shape[0] - 5
    if kind == "all_dead":
        planes[3] = torch.zeros_like(planes[3])
    elif kind == "ragged":
        planes = [p[:23, :RC - 5].contiguous() for p in planes]
        assert planes[0].numel() % 512 and planes[0].numel() % 2
    elif kind == "empty_range":
        count = 0
    elif kind.startswith("slots"):
        _, _, (lpos, lint) = slot_args(int(kind.split("_")[1]))
        start, count = (0, 2048) if lpos.shape[0] == 2048 else (3, 2497)
    for c in range(3):
        planes[c][0, 0] = lpos[start, c]
    return planes, (lpos, lint), start, count


@pytest.mark.gpu
@pytest.mark.parametrize("kind", POINT_CASES)
@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_cuda_slot_point_kernel_on_the_live_sample_loop(sphere, paired, kind):
    """The slots point/sphere kernel on the live-sample loop against its
    plain version at rtol 2e-5 in the same tier (paired also against the
    exact plain version at 3e-5); dead samples and an empty range give
    0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, lights, start, count = point_case(kind)
    kw = dict(sphere=sphere, radius=RADIUS)
    n0 = tvpu.launches["vpu"]
    got = tvpu.gather_vpu(*planes, *lights, start, count, paired=paired, **kw)
    torch.cuda.synchronize()
    assert tvpu.launches["vpu"] == n0 + 1
    ref = tvpu.gather_vpu_reference(*planes, *lights, start, count,
                                    paired=paired, **kw)
    exact = tvpu.gather_vpu_reference(*planes, *lights, start, count, **kw)
    live = planes[3] != 0
    assert got.shape == planes[0].shape and torch.isfinite(got).all()
    assert not got[~live].any()
    if kind in ("all_dead", "empty_range"):
        assert not got.any()
    else:
        assert (got[live] > 0).all()
    got, ref, exact = (t.cpu().numpy() for t in (got, ref, exact))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=0)
    np.testing.assert_allclose(got, exact, rtol=3e-5 if paired else 2e-5,
                               atol=0)


@pytest.mark.gpu
def test_cuda_live_sample_kernels_take_misaligned_weights():
    """A weight plane that does not start on a 16-byte boundary (one float
    into its storage) is handed to the kernels as an aligned copy: the same
    output bit for bit as the aligned plane, for the point, discrete and
    analytic slot kernels; the C entry point itself refuses it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    planes, segs, (lpos, lint) = slot_args()
    store = torch.empty(planes[3].numel() + 1, device="cuda")
    store[1:] = planes[3].reshape(-1)
    w_off = store[1:].view(planes[3].shape)
    assert w_off.data_ptr() % 16 != 0
    for kind, kw in (("vpu", dict(sphere=True, radius=RADIUS, paired=True)),
                     ("discrete", dict(sphere_radius=None, paired=False)),
                     ("analytic", dict(sphere_radius=None, paired=True))):
        a = run(kind, planes, segs, (lpos, lint), kw, plain=False)
        b = run(kind, planes[:3] + [w_off], segs, (lpos, lint), kw,
                plain=False)
        assert torch.equal(a, b), kind
    out = torch.empty_like(planes[0])
    with pytest.raises(RuntimeError, match="misaligned"):
        tvpu._run("vr_gather_vpu", out.device, *planes[:3], w_off, lpos,
                  lint, tvpu._meta(0, 8, out.device), lpos.shape[0],
                  out.numel(), 0.0, 0, 0,
                  torch.zeros(1, dtype=torch.int32, device="cuda"), out)
