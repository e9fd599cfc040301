"""The slot-layout gathers: the plain PyTorch versions of the four slot
kernels (16 variants) against the JAX package's Pallas kernels
(``impl="vpu_interpret"`` on the CPU) and XLA oracles, zero-weight samples
and blocks, and the wrappers' dispatch rules.  The CUDA kernels themselves
run only on a GPU (test_torch_gpu_slots.py).

The slot output is per sample, (R, C) = w * sum, so each comparison is
element-wise.  As in test_torch_gather_segments.py, samples within MARGIN
of a guard surface get zero weight in the comparisons against the JAX
package: there XLA:CPU's contracted multiply-adds move a term by more than
the tolerance (the segments' scene, distances and margins are shared with
that file).  The midpoint rule's d^2 = c - 2bs + s^2 cancels where a
sample lies far along a segment's line; per sample (not summed over a
lane) that needs a wider margin, MARGIN_MIDPOINT_SLOTS (measured: 3.05e-5
at 1.66 from a segment, 1.1e-5 beyond 1.5)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_gather_segments import (
    ANALYTIC, MARGIN, ORACLE_RTOL, RADIUS, STEP, far_weights,
    scene, segment_distance,
)
from volumerenderer_tpu.ops import gather as jgather
from volumerenderer_tpu_torch.ops import gather as tgather
from volumerenderer_tpu_torch.ops.kernels import gather_lanes as tlanes
from volumerenderer_tpu_torch.ops.kernels import gather_many as tmany
from volumerenderer_tpu_torch.ops.kernels import gather_vpu as tvpu

T = torch.as_tensor
R, C = 16, 1024  # the segment scene's (Cp, Rc) planes read as (R, C) slots
NL, LSTART, LCOUNT = 41, 4, 33  # light slots, valid range (count % 4 = 1)
MARGIN_MIDPOINT_SLOTS = 1.5


def lights(seed=7):
    """Photon-style lights: a contiguous valid range starting past 0, one
    light sitting on sample (0, 0)."""
    rs = np.random.RandomState(seed)
    lpos = (rs.randn(NL, 3) * 8 + 15).astype(np.float32)
    lint = (rs.rand(NL) * 20).astype(np.float32)
    valid = (np.arange(NL) >= LSTART) & (np.arange(NL) < LSTART + LCOUNT)
    return lpos, lint, valid


def light_distance(px, py, pz, lpos, valid):
    p = np.stack([px.ravel(), py.ravel(), pz.ravel()], -1).astype(np.float64)
    d = np.linalg.norm(p[:, None, :] - lpos[valid][None].astype(np.float64),
                       axis=-1)
    return d.reshape(*px.shape, -1)


@pytest.fixture(scope="module")
def case():
    px, py, pz, w, pf, pt, inten, valid, _need = scene()
    lpos, lint, lvalid = lights()
    lpos[LSTART] = (px[0, 0], py[0, 0], pz[0, 0])
    ld = light_distance(px, py, pz, lpos, lvalid)
    return dict(planes=(px, py, pz), w=w, segs=(pf, pt, inten, valid),
                seg_dist=segment_distance(px, py, pz, pf, pt, valid),
                lights=(lpos, lint, lvalid), light_dist=ld)


def point_weights(case, sphere):
    """Weights zeroed within MARGIN of a light (point) or of a light's
    sphere (0.3) surface."""
    gap = case["light_dist"] if not sphere else np.abs(
        case["light_dist"] - 0.3)
    return np.where(gap.min(-1) > MARGIN, case["w"], 0.0).astype(np.float32)


def jax_slots(fn, planes, w, *args, **kw):
    return np.asarray(fn(*planes, w, *args, layout="slots", **kw))


def port_slots(fn, planes, w, *args, **kw):
    return fn(*map(T, planes), T(w), *map(T, args), layout="slots",
              **kw).numpy()


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("sphere", [False, True], ids=["point", "sphere"])
def test_vpu_plain_matches_pallas_interpret_and_xla(case, sphere, paired):
    """gather_vpu._kernel: rtol 2e-5 against the Pallas kernel of the same
    tier; against the exact XLA oracle 2e-5 (exact) and 3e-5 (paired)."""
    w = point_weights(case, sphere)
    kw = dict(sphere=sphere, radius=0.3)
    got = port_slots(tgather.gather_planes, case["planes"], w,
                     *case["lights"], paired=paired, **kw)
    want = jax_slots(jgather.gather_planes, case["planes"], w,
                     *case["lights"], impl="vpu_interpret", paired=paired,
                     **kw)
    assert got.shape == (R, C) and np.count_nonzero(want) > R * C // 4
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    oracle = jax_slots(jgather.gather_planes, case["planes"], w,
                       *case["lights"], impl="xla", **kw)
    np.testing.assert_allclose(got, oracle, rtol=3e-5 if paired else 2e-5,
                               atol=0)
    assert tvpu.launches["vpu"] == 0


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("radius", [None, RADIUS], ids=["ray", "beam"])
def test_discrete_plain_matches_pallas_interpret_and_xla(case, radius,
                                                         paired):
    """gather_vpu._segment_discrete_kernel: rtol 2e-5 against the Pallas
    kernel of the same tier; against the uncapped expansion oracle 2e-5
    (exact) and 3e-5 (paired)."""
    w = far_weights(case["w"], case["seg_dist"], radius)
    args = (*case["segs"], STEP)
    got = port_slots(tgather.gather_segments_discrete, case["planes"], w,
                     *args, sphere_radius=radius, paired=paired)
    want = jax_slots(jgather.gather_segments_discrete, case["planes"], w,
                     *args, sphere_radius=radius, paired=paired,
                     impl="vpu_interpret")
    assert np.count_nonzero(want) > R * C // 4
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    oracle = jax_slots(jgather.gather_segments_discrete, case["planes"], w,
                       *args, sphere_radius=radius, impl="xla",
                       max_points_per_segment=4096)
    np.testing.assert_allclose(got, oracle, rtol=3e-5 if paired else 2e-5,
                               atol=0)


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("name,radius,rule", ANALYTIC,
                         ids=[a[0] for a in ANALYTIC])
def test_analytic_plain_matches_pallas_interpret_and_xla(case, name, radius,
                                                         rule, paired):
    """gather_vpu._segment_kernel (VRL) and _segment_sphere_kernel (VBL
    midpoint, tangent, closed): rtol 2e-5 against the Pallas kernel of the
    same tier; against the oracles, whose exact arctan and cos replace the
    polynomials, at the lane gathers' bounds (ORACLE_RTOL) on the same
    sums test_torch_gather_segments.py compares, over axis 0 (per sample the closed rule's algebra is 3.7e-3
    from the oracle at one sample of 16,384, in the Pallas kernel as in the
    port); paired against exact per sample at the JAX suite's 2e-4 for the
    divide pairing."""
    margin = MARGIN_MIDPOINT_SLOTS if name == "vbl-midpoint" else MARGIN
    w = far_weights(case["w"], case["seg_dist"], radius, margin)
    kw = dict(sphere_radius=radius, quad_nodes=8, quad_rule=rule)
    got = port_slots(tgather.gather_segments, case["planes"], w,
                     *case["segs"], paired=paired, **kw)
    want = jax_slots(jgather.gather_segments, case["planes"], w,
                     *case["segs"], paired=paired, impl="vpu_interpret", **kw)
    assert np.count_nonzero(want) > R * C // 4
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    oracle = jax_slots(jgather.gather_segments, case["planes"], w,
                       *case["segs"], impl="xla", **kw)
    if paired:
        exact = port_slots(tgather.gather_segments, case["planes"], w,
                           *case["segs"], paired=False, **kw)
        np.testing.assert_allclose(got, exact, rtol=2e-4, atol=0)
    else:
        np.testing.assert_allclose(got.sum(0), oracle.sum(0),
                                   rtol=ORACLE_RTOL[name], atol=0)


@pytest.mark.parametrize("kind", ["vpu", "discrete", "analytic", "sphere"])
def test_zero_weights_and_blocks_give_zero(kind):
    """A sample of zero weight in a live block, and a whole 65,536-sample
    block of zero weight (which the TPU kernel skips), give 0, and every
    other sample, 1.5 or more from a guard surface, matches the Pallas
    kernel (rtol 2e-5)."""
    rs = np.random.RandomState(2)
    Rb, Cb = 160, 512  # 81,920 samples: two TPU blocks
    planes = [(rs.randn(Rb, Cb) * 8 + 15).astype(np.float32)
              for _ in range(3)]
    w = (rs.rand(Rb, Cb) * 0.01).astype(np.float32)
    w[rs.rand(Rb, Cb) < 0.3] = 0.0  # zero samples inside the live block
    w.reshape(-1)[65536:] = 0.0  # the second block is all zero
    pf, pt = np.float32([[0, 0, 0], [40, 30, 30]]), np.float32(
        [[30, 30, 30], [41, 30, 30]])
    inten, valid = np.float32([20, 10]), np.array([True, True])
    if kind == "vpu":
        fns = (tgather.gather_planes, jgather.gather_planes)
        args = (np.float32([[0, 0, 0], [30, 30, 30]]), inten, valid)
        kw = dict(sphere=False)
    elif kind == "discrete":
        fns = (tgather.gather_segments_discrete,
               jgather.gather_segments_discrete)
        args, kw = (pf, pt, inten, valid, STEP), {}
    else:
        fns = (tgather.gather_segments, jgather.gather_segments)
        args = (pf, pt, inten, valid)
        kw = dict(sphere_radius=RADIUS if kind == "sphere" else None,
                  quad_rule="closed")
    ends = (args[0], args[0]) if kind == "vpu" else (pf, pt)
    dist = segment_distance(*planes, *ends, valid)
    w = far_weights(w, dist, RADIUS if kind == "sphere" else None, 1.5)
    got = port_slots(fns[0], planes, w, *args, **kw)
    want = jax_slots(fns[1], planes, w, *args, impl="vpu_interpret", **kw)
    assert np.all(got[w == 0] == 0) and np.all(want[w == 0] == 0)
    assert np.all(got[w != 0] != 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


def test_guard_samples_match_pallas(case):
    """Samples on a sub-light, at a Beam centre, inside a beam and on a
    point light: finite, and within 1e-4 relative of the Pallas kernel
    (guarded terms are 0 in both; near the guard an ulp of a position
    moves the sum by more than 2e-5)."""
    px, py, pz, w, pf, pt, inten, valid, _need = scene()
    u = (pt[1] - pf[1]) / np.linalg.norm(pt[1] - pf[1])
    perp = np.float32([u[1], -u[0], 0.0]) / np.linalg.norm(u[:2])
    special = [pf[1], pf[1] + u * (3 * STEP), pf[1] + u + perp * 0.1]
    for i, p in enumerate(special):
        px[0, i], py[0, i], pz[0, i] = p
    w[0, :3] = 0.005
    planes = (px[:1].copy(), py[:1].copy(), pz[:1].copy())
    w = w[:1].copy()
    segs = (pf, pt, inten, valid)
    for radius in (None, RADIUS):
        got = port_slots(tgather.gather_segments_discrete, planes, w, *segs,
                         STEP, sphere_radius=radius)
        want = jax_slots(jgather.gather_segments_discrete, planes, w, *segs,
                         STEP, sphere_radius=radius, impl="vpu_interpret")
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[0, :3], want[0, :3], rtol=1e-4)
    for rule in ("midpoint", "tangent", "closed"):
        kw = dict(sphere_radius=RADIUS, quad_nodes=8, quad_rule=rule)
        got = port_slots(tgather.gather_segments, planes, w, *segs, **kw)
        want = jax_slots(jgather.gather_segments, planes, w, *segs,
                         impl="vpu_interpret", **kw)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[0, :3], want[0, :3], rtol=1e-4,
                                   err_msg=rule)


def test_wrappers_dispatch_and_validate(case):
    """CPU tensors run the plain versions (no launch); the wrappers take
    (R, C) f32 contiguous planes and raise on anything else; more than 2048
    light slots take the many-light gather (its plain version here); an
    unknown layout is an error."""
    planes = tuple(map(T, case["planes"]))
    w = T(case["w"])
    lpos, lint, lvalid = map(T, case["lights"])
    segs = tuple(map(T, case["segs"]))
    n0 = dict(tvpu.launches)
    a = tgather.gather_planes(*planes, w, lpos, lint, lvalid, sphere=False,
                              layout="slots")
    b = tvpu.gather_vpu_reference(*planes, w, lpos, lint, LSTART, LCOUNT,
                                  sphere=False)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = tgather.gather_segments(*planes, w, *segs, layout="slots")
    d = tvpu.gather_segments_analytic_reference(*planes, w, *segs)
    np.testing.assert_array_equal(c.numpy(), d.numpy())
    assert tvpu.launches == n0
    with pytest.raises(TypeError):
        tvpu.gather_vpu(*planes, w.double(), lpos, lint, 0, 1, sphere=False)
    with pytest.raises(ValueError):
        tvpu.gather_vpu(planes[0][:, :-1], *planes[1:], w, lpos, lint, 0, 1,
                        sphere=False)
    with pytest.raises(ValueError):
        tvpu.gather_segments_discrete(planes[0].T.contiguous().T,
                                      *planes[1:], w, *segs, STEP)
    with pytest.raises(ValueError):
        tvpu.gather_segments_analytic(*(t.to("meta") for t in planes),
                                      w.to("meta"), *(
                                          s.to("meta") for s in segs))
    with pytest.raises(ValueError):
        tvpu.gather_segments_analytic(*planes, w, *segs,
                                      sphere_radius=RADIUS,
                                      quad_rule="simpson")
    n = tgather.SMEM_LIGHT_LIMIT + 1
    many = (torch.cat([lpos] * 50)[:n], torch.cat([lint] * 50)[:n],
            torch.cat([lvalid] * 50)[:n])
    e = tgather.gather_planes(*planes, w, *many, sphere=False,
                              layout="slots")
    f = tmany.gather_many_reference(*planes, w, *many, sphere=False)
    assert e.shape == (R, C) and e.any()
    np.testing.assert_array_equal(e.numpy(), f.numpy())
    with pytest.raises(ValueError, match="layout"):
        tgather.gather_segments(*planes, w, *segs, layout="rows")


@pytest.mark.parametrize("kind", ["vpu", "discrete", "analytic"])
def test_empty_ranges_give_zero(case, kind):
    """No valid light or segment: zeros of the planes' shape."""
    planes = tuple(map(T, case["planes"]))
    w = T(case["w"])
    none = torch.zeros(8, dtype=torch.bool)
    pos, inten = torch.ones(8, 3), torch.ones(8)
    if kind == "vpu":
        out = tgather.gather_planes(*planes, w, pos, inten, none,
                                    sphere=True, radius=0.3, layout="slots",
                                    paired=True)
    elif kind == "discrete":
        out = tgather.gather_segments_discrete(*planes, w, pos, pos * 2,
                                               inten, none, STEP,
                                               layout="slots")
    else:
        out = tgather.gather_segments(*planes, w, pos, pos * 2, inten, none,
                                      sphere_radius=RADIUS, layout="slots",
                                      quad_rule="tangent", paired=True)
    assert out.shape == (R, C) and not out.any()


@pytest.mark.parametrize("kind", ["discrete", "vbl", "vrl", "vpu"])
def test_live_sample_wrappers_refuse_2_31_samples(kind):
    """The discrete, VBL, VRL and point/sphere slot kernels all run the
    live-sample loop, which indexes samples in int32: planes of 2^31
    samples or more are refused on every device, one sample fewer passes
    that check (and then meets the device check: meta tensors run
    nowhere)."""
    segs = (torch.zeros(8, 3, device="meta"), torch.ones(8, 3, device="meta"),
            torch.ones(8, device="meta"),
            torch.ones(8, dtype=torch.bool, device="meta"))
    radius = None if kind == "vrl" else RADIUS

    def call(shape):
        planes = [torch.empty(shape, device="meta") for _ in range(4)]
        if kind == "vpu":
            return tvpu.gather_vpu(*planes, segs[0], segs[2], 0, 8,
                                   sphere=True, radius=RADIUS)
        if kind == "discrete":
            return tvpu.gather_segments_discrete(*planes, *segs, STEP,
                                                 sphere_radius=radius)
        return tvpu.gather_segments_analytic(*planes, *segs,
                                             sphere_radius=radius)

    for shape in ((2**16, 2**15), (2**31 + 1, 1)):
        with pytest.raises(ValueError, match="fewer than 2\\^31"):
            call(shape)
    with pytest.raises(ValueError, match="unsupported device"):
        call((2**31 - 1, 1))


@pytest.mark.parametrize("offset", [0, 1, 4], ids=["base", "one", "four"])
def test_live_sample_weights_are_handed_over_aligned(offset):
    """The live-sample kernels take 16-byte aligned weight planes:
    ``aligned`` hands a weight plane over as it is when it starts on a
    16-byte boundary (a view 4 floats in does) and as a copy of the same
    values otherwise (one float in, as the last of several planes of one
    tensor can be)."""
    base = torch.arange(4 * 3 * 5 + 4, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    w = base[offset:offset + 60].view(12, 5)
    got = tlanes.aligned(w)
    assert got.data_ptr() % 16 == 0
    assert (got.data_ptr() == w.data_ptr()) == (offset % 4 == 0)
    np.testing.assert_array_equal(got.numpy(), w.numpy())
