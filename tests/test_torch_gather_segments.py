"""The segment gathers (Ray/VRL, Beam/VBL): their plain PyTorch versions
against the JAX package's Pallas kernels (interpret mode on the CPU) and
XLA oracles, the segment_math helpers against gather_vpu's, the segment
expansion against ops.lights, and the wrappers' dispatch rules.  The CUDA
kernels themselves run only on a GPU.

Near a sub-light or a sphere-light surface the terms 1/d^2 and 1/(d-r)^2
turn a one-ulp change of a position into more than 2e-5 of the sum.  The
Pallas kernels in interpret mode run through XLA:CPU, which contracts
multiply-adds such as the sub-light position ``ax + sf*ux`` into FMAs; the
port (and the CUDA kernel, built with -fmad=false) rounds each operation.
So the comparisons against the JAX package zero the weights of samples
within ``MARGIN`` of a segment's guard surface, as the JAX suite's own
``_far_from_guard`` does (measured without the mask: up to 1.5e-4 for a
Beam sample 0.01 from a sub-light's sphere; with the FMA emulated in the
port, 7e-7)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from volumerenderer_tpu.ops import gather as jgather
from volumerenderer_tpu.ops import lights as jlights
from volumerenderer_tpu.ops.pallas import gather_lanes as jlanes
from volumerenderer_tpu.ops.pallas import gather_vpu as jvpu
from volumerenderer_tpu_torch.ops import gather as tgather
from volumerenderer_tpu_torch.ops import lights as tlights
from volumerenderer_tpu_torch.ops.kernels import gather_segments as tseg
from volumerenderer_tpu_torch.ops.kernels import segment_math as sm

T = torch.as_tensor
CP, RC, L = 16, 1024, 8
STEP, RADIUS = 0.3, 0.25
# Guard margins (world units) of the comparisons against the JAX package;
# the midpoint rule's d^2 = c - 2bs + s^2 cancels, so it needs more room.
MARGIN = 0.3
MARGIN_MIDPOINT = 1.0
ANALYTIC = [("vrl", None, "midpoint"), ("vbl-midpoint", RADIUS, "midpoint"),
            ("vbl-tangent", RADIUS, "tangent"),
            ("vbl-closed", RADIUS, "closed")]


def scene(seed=3):
    """Planes with weights zero past each lane's need, and 8 segments whose
    valid range starts at 1 with an odd count (5): one of zero length, one
    shorter than a step (ns = 0), one of ns = 5 (ns % 4 != 0)."""
    rs = np.random.RandomState(seed)
    need = np.sort(rs.randint(0, CP + 1, RC))[::-1].astype(np.int32)
    need[-RC // 8:] = 0
    px, py, pz = ((rs.randn(CP, RC) * 8 + 15).astype(np.float32)
                  for _ in range(3))
    w = (rs.rand(CP, RC) * 0.01).astype(np.float32)
    w[np.arange(CP)[:, None] >= need[None, :]] = 0.0
    pf = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt = (rs.randn(L, 3) * 8 + 15).astype(np.float32)
    pt[2] = pf[2]  # zero length
    pt[3] = pf[3] + np.float32([0.2, 0.0, 0.0])  # ns = 0
    pt[4] = pf[4] + np.float32([0.0, 1.6, 0.0])  # ns = 5
    inten = (rs.rand(L) * 30).astype(np.float32)
    valid = (np.arange(L) >= 1) & (np.arange(L) < 6)
    return px, py, pz, w, pf, pt, inten, valid, need


def segment_distance(px, py, pz, pf, pt, valid):
    """Each sample's distance to the nearest valid segment (f64)."""
    p = np.stack([px.ravel(), py.ravel(), pz.ravel()], -1).astype(np.float64)
    dmin = np.full(p.shape[0], np.inf)
    for k in np.nonzero(valid)[0]:
        a = pf[k].astype(np.float64)
        seg = pt[k] - a
        t = np.clip((p - a) @ seg / max(seg @ seg, 1e-12), 0.0, 1.0)
        dmin = np.minimum(dmin,
                          np.linalg.norm(p - a - t[:, None] * seg, axis=-1))
    return dmin.reshape(px.shape)


def far_weights(w, dist, radius, margin=MARGIN):
    """Weights zeroed within ``margin`` of the guard surface (the segment
    for point sub-lights, the swept sphere for sphere lights)."""
    gap = dist if radius is None else np.abs(dist - radius)
    return np.where(gap > margin, w, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    px, py, pz, w, pf, pt, inten, valid, need = scene()
    return (px, py, pz, w, pf, pt, inten, valid, need,
            segment_distance(px, py, pz, pf, pt, valid))


def port_discrete(px, py, pz, w, pf, pt, inten, valid, need, *, radius,
                  paired):
    return tseg.gather_segments_discrete_lanes(
        *map(T, (px, py, pz, w, pf, pt, inten, valid)), STEP,
        sphere_radius=radius, lane_need=T(need), paired=paired).numpy()


def port_analytic(px, py, pz, w, pf, pt, inten, valid, need, *, radius, rule,
                  paired, nodes=8):
    return tseg.gather_segments_analytic_lanes(
        *map(T, (px, py, pz, w, pf, pt, inten, valid)), sphere_radius=radius,
        quad_nodes=nodes, quad_rule=rule, lane_need=T(need),
        paired=paired).numpy()


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("radius", [None, RADIUS], ids=["ray", "beam"])
def test_discrete_plain_matches_pallas_interpret(case, radius, paired):
    """rtol 2e-5 against the Pallas kernel of the same tier."""
    px, py, pz, w, pf, pt, inten, valid, need, dist = case
    w = far_weights(w, dist, radius)
    got = port_discrete(px, py, pz, w, pf, pt, inten, valid, need,
                        radius=radius, paired=paired)
    want = np.asarray(jlanes.gather_segments_discrete_lanes(
        px, py, pz, w, pf, pt, inten, valid, STEP, sphere_radius=radius,
        lane_need=jnp.asarray(need), paired=paired, interpret=True))
    assert np.count_nonzero(want) > RC // 2
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    assert tseg.launches == {"discrete": 0, "analytic": 0}


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("name,radius,rule", ANALYTIC,
                         ids=[a[0] for a in ANALYTIC])
def test_analytic_plain_matches_pallas_interpret(case, name, radius, rule,
                                                 paired):
    """rtol 2e-5 against the Pallas kernel of the same tier (paired: the
    node pairing, or two segments per trip for VRL and closed VBL)."""
    px, py, pz, w, pf, pt, inten, valid, need, dist = case
    margin = MARGIN_MIDPOINT if name == "vbl-midpoint" else MARGIN
    w = far_weights(w, dist, radius, margin)
    got = port_analytic(px, py, pz, w, pf, pt, inten, valid, need,
                        radius=radius, rule=rule, paired=paired)
    want = np.asarray(jlanes.gather_segments_analytic_lanes(
        px, py, pz, w, pf, pt, inten, valid, sphere_radius=radius,
        quad_nodes=8, quad_rule=rule, lane_need=jnp.asarray(need),
        paired=paired, interpret=True))
    assert np.count_nonzero(want) > RC // 2
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


def _oracle(fn, px, py, pz, w, *args, **kw):
    """A JAX ``impl="xla"`` gather in the lanes layout."""
    return np.asarray(fn(px, py, pz, w, *args, impl="xla", layout="lanes",
                         **kw))


@pytest.mark.parametrize("radius", [None, RADIUS], ids=["ray", "beam"])
def test_discrete_plain_matches_xla_oracle(case, radius):
    """Against the capped-expansion oracle where the cap does not bind:
    exact rtol 2e-5, paired 3e-5 (reassociation only)."""
    px, py, pz, w, pf, pt, inten, valid, need, dist = case
    w = far_weights(w, dist, radius)
    want = _oracle(jgather.gather_segments_discrete, px, py, pz, w, pf, pt,
                   inten, valid, STEP, sphere_radius=radius,
                   max_points_per_segment=4096)
    for paired, rtol in ((False, 2e-5), (True, 3e-5)):
        got = port_discrete(px, py, pz, w, pf, pt, inten, valid, need,
                            radius=radius, paired=paired)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# The kernels against their oracles, whose exact arctan/cos replace the
# kernels' polynomials: the JAX suite's own bounds, midpoint 1e-4
# (test_gather.py:198), tangent 5e-4 (:574), closed 3e-3 (:674).  VRL:
# 1.5e-4, not the suite's 1e-4 (:156, which adds atol 1e-6 on unit
# weights): a far segment's subtended angle is small, where the polynomial
# atan is 0.999866 z, 1.34e-4 below arctan (measured 1.15e-4 here).
ORACLE_RTOL = {"vrl": 1.5e-4, "vbl-midpoint": 1e-4, "vbl-tangent": 5e-4,
               "vbl-closed": 3e-3}


@pytest.mark.parametrize("name,radius,rule", ANALYTIC,
                         ids=[a[0] for a in ANALYTIC])
def test_analytic_plain_matches_xla_oracle(case, name, radius, rule):
    px, py, pz, w, pf, pt, inten, valid, need, dist = case
    margin = MARGIN_MIDPOINT if name == "vbl-midpoint" else MARGIN
    w = far_weights(w, dist, radius, margin)
    want = _oracle(jgather.gather_segments, px, py, pz, w, pf, pt, inten,
                   valid, sphere_radius=radius, quad_nodes=8, quad_rule=rule)
    exact = port_analytic(px, py, pz, w, pf, pt, inten, valid, need,
                          radius=radius, rule=rule, paired=False)
    np.testing.assert_allclose(exact, want, rtol=ORACLE_RTOL[name], atol=0)
    # Paired against exact: reassociation of the divides (the JAX suite's
    # bound for the cross-segment pairing, test_gather.py:333).
    paired = port_analytic(px, py, pz, w, pf, pt, inten, valid, need,
                           radius=radius, rule=rule, paired=True)
    np.testing.assert_allclose(paired, exact, rtol=2e-4, atol=0)


def test_port_oracles_match_jax_oracles(case):
    """The port's plain oracles against the JAX package's, samples (N, 3)
    away from the guard surfaces: rtol 2e-5."""
    px, py, pz, w, pf, pt, inten, valid, need, dist = case
    keep = np.abs(dist - RADIUS).ravel() > MARGIN_MIDPOINT
    samples = np.stack([px.ravel(), py.ravel(), pz.ravel()], -1)[keep][:2000]
    args = (samples, pf, pt, inten, valid)
    targs = tuple(map(T, args))
    np.testing.assert_allclose(
        tgather.segment_integral_xla(*targs).numpy(),
        np.asarray(jgather.segment_integral_xla(*args)), rtol=2e-5)
    for rule in ("midpoint", "tangent", "closed"):
        np.testing.assert_allclose(
            tgather.segment_sphere_quadrature_xla(
                *targs, RADIUS, 8, rule=rule).numpy(),
            np.asarray(jgather.segment_sphere_quadrature_xla(
                *args, RADIUS, 8, rule=rule)), rtol=2e-5, err_msg=rule)
    for radius in (None, RADIUS):
        np.testing.assert_allclose(
            tgather.segment_discrete_xla(
                *targs, STEP, sphere_radius=radius).numpy(),
            np.asarray(jgather.segment_discrete_xla(
                *args, STEP, sphere_radius=radius)), rtol=2e-5)


def test_discrete_is_uncapped():
    """A segment of 200 sub-lights against a cap of 64: the capped oracle
    dims, the kernel's plain version sums every sub-light (the JAX suite's
    test_discrete_segment_kernel_is_uncapped, in the lanes layout)."""
    px = np.full((8, 1024), 30.0, np.float32)
    py = np.full((8, 1024), 2.0, np.float32)
    pz = np.full((8, 1024), 1.0, np.float32)
    w = np.ones((8, 1024), np.float32)
    pf = np.float32([[0.0, 0.0, 0.0]])
    pt = np.float32([[60.0, 0.0, 0.0]])
    inten, valid = np.float32([50.0]), np.asarray([True])
    args = tuple(map(T, (px, py, pz, w, pf, pt, inten, valid)))
    got = tgather.gather_segments_discrete(*args, STEP)
    full = jgather.gather_segments_discrete(
        px, py, pz, w, pf, pt, inten, valid, STEP, impl="xla",
        layout="lanes", max_points_per_segment=4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=2e-5)
    samples = torch.stack([a.ravel() for a in args[:3]], -1)
    capped = tgather.segment_discrete_xla(
        samples, *args[4:], STEP, max_points_per_segment=64)
    assert float(capped.reshape(8, 1024).sum(0).max()) < float(got.min())


def test_segment_cols_bit_exact():
    """u, length, start, count and the discrete/analytic intensities equal
    the JAX package's bit for bit, so ns = floor(len / step) flips where
    the reference's does."""
    rs = np.random.RandomState(0)
    n = 4096
    pf = (rs.randn(n, 3) * 20 + 10).astype(np.float32)
    pt = (rs.randn(n, 3) * 20 + 10).astype(np.float32)
    pt[:8] = pf[:8]
    inten = (rs.rand(n) * 30).astype(np.float32)
    valid = np.arange(n) >= 3
    ju, jlen, jsafe, jstart, jcount = map(np.asarray, jlanes.segment_cols(
        jnp.asarray(pf), jnp.asarray(pt), jnp.asarray(inten),
        jnp.asarray(valid)))
    tu, tlen, tsafe, tstart, tcount = tseg.segment_cols(
        T(pf), T(pt), T(inten), T(valid))
    for got, want in ((tu, ju), (tlen, jlen), (tsafe, jsafe)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert (int(tstart), int(tcount)) == (int(jstart), int(jcount)) == (3, n - 3)
    # The wrappers' per-segment columns (gather_lanes.py:387-393, 440-444).
    steps = (jnp.asarray(jlen) / STEP).astype(jnp.int32)
    live = jnp.asarray(valid) & (steps > 0)
    jii = jnp.where(live, (jnp.asarray(inten) / jnp.maximum(steps, 1).astype(
        jnp.float32)) * jnp.float32(1.0 / jlights.FOUR_PI), 0.0)
    _, ns, ii, _, _ = tseg.discrete_cols(T(pf), T(pt), T(inten), T(valid),
                                         STEP)
    np.testing.assert_array_equal(ns.numpy(), np.where(live, steps, 0))
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jii))
    jia = jnp.where(jnp.asarray(valid) & (jnp.asarray(jlen) > 0),
                    jnp.asarray(inten) / (jnp.float32(jlights.FOUR_PI)
                                          * jnp.asarray(jsafe)), 0.0)
    np.testing.assert_array_equal(
        tseg.analytic_cols(T(pf), T(pt), T(inten), T(valid))[2].numpy(),
        np.asarray(jia))


def test_segment_math_matches_gather_vpu():
    """The helpers against gather_vpu's, element-wise: the polynomial atan
    and cos and the arithmetic helpers bit for bit; the quadrature node
    terms to rtol 2e-5, since XLA's rsqrt and PyTorch's CPU sqrt each
    differ from IEEE 1/sqrt and sqrt by an ulp on some inputs (measured
    <= 1.4e-7 per value; the closed rule's n_r = r (ds - r L) cancels,
    1.3e-5)."""
    rs = np.random.RandomState(1)
    n = 4096
    x = (rs.randn(n) * 5).astype(np.float32)
    y = (rs.randn(n) * 5).astype(np.float32)
    num = np.abs(rs.randn(n) * 5).astype(np.float32)
    J = jnp.asarray
    eq = np.testing.assert_array_equal
    eq(sm.atan(T(x)).numpy(), np.asarray(jvpu._atan(J(x))))
    eq(sm.cos(T(x / 4)).numpy(), np.asarray(jvpu._cos(J(x / 4))))
    eq(sm.atan_pos_ratio(T(num), T(y)).numpy(),
       np.asarray(jvpu._atan_pos_ratio(J(num), J(y))))
    for got, want in zip(
            sm.paired_pos_ratio_atans(T(num), T(y), T(num[::-1].copy()), T(x)),
            jvpu._paired_pos_ratio_atans(J(num), J(y), J(num[::-1].copy()),
                                         J(x))):
        eq(got.numpy(), np.asarray(want))
    d = [(rs.randn(n) * 8).astype(np.float32) for _ in range(3)]
    u = rs.randn(3)
    u = (u / np.linalg.norm(u)).astype(np.float32)
    eq(sm.cross_q2(list(map(T, d)), list(map(T, u))).numpy(),
       np.asarray(jvpu._cross_q2(list(map(J, d)), list(map(J, u)))))
    b = d[0] * u[0] + d[1] * u[1] + d[2] * u[2]
    ll = np.full(n, 7.5, np.float32)
    q2 = np.asarray(jvpu._cross_q2(list(map(J, d)), list(map(J, u))))
    qd = np.sqrt(q2)
    eq(sm.subtended_angle(T(b), T(q2), T(qd), T(ll)).numpy(),
       np.asarray(jvpu._subtended_angle(J(b), J(q2), J(qd), J(ll))))
    xs, ws = sm.gauss01(8)
    jxs, jws = jvpu._gauss01(8)
    eq(xs, np.float32(jxs))
    eq(ws, np.float32(jws))
    for rule, nodes in (("midpoint", 8), ("tangent", 8), ("closed", 2)):
        fn_t, sc_t = sm.quad_nodes_nq(rule, nodes, list(map(T, d)),
                                      list(map(T, u)), T(b), T(ll), RADIUS)
        fn_j, sc_j = jvpu._quad_nodes_nq(rule, nodes, list(map(J, d)),
                                         list(map(J, u)), J(b), J(ll),
                                         jnp.float32(RADIUS))
        close = lambda a, w: np.testing.assert_allclose(
            np.broadcast_to(np.asarray(a), (n,)),
            np.broadcast_to(np.asarray(w), (n,)), rtol=2e-5, err_msg=rule)
        close(sc_t, sc_j)
        for j in range(nodes + 1):
            for a, w in zip(fn_t(j), fn_j(j)):
                close(a, w)
        for paired in (False, True):
            close(sm.node_sum(fn_t, nodes, paired),
                  jvpu._node_sum(fn_j, nodes, paired, jnp.zeros(n)))


def test_expand_segments_and_compact_valid_match_jax():
    rs = np.random.RandomState(2)
    pf = (rs.randn(12, 3) * 5).astype(np.float32)
    pt = (rs.randn(12, 3) * 5).astype(np.float32)
    pt[0] = pf[0]
    inten = (rs.rand(12) * 30).astype(np.float32)
    valid = rs.rand(12) < 0.8
    want = jlights.expand_segments(pf, pt, inten, valid, STEP, 16)
    got = tlights.expand_segments(T(pf), T(pt), T(inten), T(valid), STEP, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tlights.segment_point_count(T(pf), T(pt), STEP).numpy(),
        np.asarray(jlights.segment_point_count(pf, pt, STEP)))
    for cap in (8, 64, 400):  # overflowing, and with room
        jc = jlights.compact_valid(*want, cap)
        tc = tlights.compact_valid(*got, cap)
        for g, w in zip(tc, jc):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_wrappers_dispatch_and_validation(case):
    px, py, pz, w, pf, pt, inten, valid, need, _ = case
    args = list(map(T, (px, py, pz, w, pf, pt, inten, valid)))
    n0 = dict(tseg.launches)
    a = tgather.gather_segments_discrete(*args, STEP, lane_need=T(need))
    b = tseg.gather_segments_discrete_lanes_reference(*args, STEP,
                                                      lane_need=T(need))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # lane_need derived from the weights when not given.
    np.testing.assert_array_equal(
        tgather.gather_segments(*args).numpy(),
        tseg.gather_segments_analytic_lanes_reference(
            *args, lane_need=T(need)).numpy())
    assert tseg.launches == n0 == {"discrete": 0, "analytic": 0}
    with pytest.raises(TypeError):
        tseg.gather_segments_discrete_lanes(*args[:7], args[7].int(), STEP)
    with pytest.raises(TypeError):
        tseg.gather_segments_analytic_lanes(*args, lane_need=T(need).long())
    with pytest.raises(ValueError):
        tseg.gather_segments_analytic_lanes(args[0][:, :-1], *args[1:])
    with pytest.raises(ValueError):
        tseg.gather_segments_analytic_lanes(*args, sphere_radius=RADIUS,
                                            quad_rule="simpson")
    with pytest.raises(ValueError):
        tseg.gather_segments_discrete_lanes(
            *(t.to("meta") for t in args), STEP, lane_need=T(need).to("meta"))
    # layout="slots": per-sample sums of the same planes, whose sum over
    # the sample axis is each lane's sum.
    for fn in (tgather.gather_segments, tgather.gather_segments_discrete):
        extra = () if fn is tgather.gather_segments else (STEP,)
        slots = fn(*args, *extra, layout="slots")
        assert slots.shape == args[0].shape
        np.testing.assert_allclose(slots.sum(0).numpy(),
                                   fn(*args, *extra).numpy(), rtol=2e-6)


def test_analytic_lanes_wrapper_refuses_2_31_samples():
    """The lane analytic kernel runs the live-sample loop over the Cp x Rc
    planes, which indexes samples in int32: Cp x Rc >= 2^31 is refused, one
    lane fewer passes that check and then meets the device check (meta
    tensors run nowhere)."""
    segs = (torch.zeros(L, 3, device="meta"), torch.ones(L, 3, device="meta"),
            torch.ones(L, device="meta"),
            torch.ones(L, dtype=torch.bool, device="meta"))

    def call(rc, radius):
        planes = [torch.empty((2**16, rc), device="meta") for _ in range(4)]
        need = torch.zeros(rc, dtype=torch.int32, device="meta")
        return tseg.gather_segments_analytic_lanes(
            *planes, *segs, sphere_radius=radius, lane_need=need)

    for radius in (None, RADIUS):
        with pytest.raises(ValueError, match="fewer than 2\\^31"):
            call(2**15, radius)
        with pytest.raises(ValueError, match="unsupported device"):
            call(2**15 - 1, radius)


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("name,radius,rule", ANALYTIC,
                         ids=[a[0] for a in ANALYTIC])
def test_analytic_plain_sums_in_column_order(name, radius, rule, paired):
    """The plain analytic version adds a sample's terms one column at a time
    in the kernel's order (segment by segment; paired VRL and closed VBL:
    each pair's parts in turn) and a lane's samples in row order, as the
    kernel does: bit for bit against those sums written out in numpy, one
    term at a time, with the plain version cut into several sample
    chunks."""
    px, py, pz, w, pf, pt, inten, valid, need = scene()
    args = tuple(map(T, (px, py, pz, w, pf, pt, inten, valid)))
    u, length, ii, start, count = tseg.analytic_cols(*args[4:])
    s0, c0 = tseg._light_range(start, count, L)
    rad = None if radius is None else tseg.f32(radius)
    nodes = None if radius is None else sm.effective_quad_nodes(rule, 8)
    use = np.arange(CP)[:, None] < need[None, :]
    x, y, z = (T(p[use])[:, None] for p in (px, py, pz))
    terms = tseg._analytic_terms(x, y, z, (args[4], u, length, ii), s0, c0,
                                 rad, nodes, rule, paired).numpy()
    acc = np.zeros(terms.shape[0], np.float32)
    for t in range(terms.shape[1]):
        acc = acc + terms[:, t]
    full = np.zeros((CP, RC), np.float32)
    full[use] = acc
    lane_terms = np.where(use, w * full, np.float32(0.0))
    want = np.zeros(RC, np.float32)
    for j in range(CP):
        want = want + lane_terms[j]
    got = tseg.gather_segments_analytic_lanes_reference(
        *args, sphere_radius=radius, quad_nodes=8, quad_rule=rule,
        lane_need=T(need), paired=paired, max_elems=1 << 14)
    assert terms.shape[1] >= c0 == 5 and x.shape[0] > (1 << 14) // c0
    assert np.count_nonzero(want) > RC // 2
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["discrete", "analytic"])
def test_empty_ranges_give_zero(case, kind):
    """No valid segment, and an all-miss band (Cp = 0): zeros."""
    px, py, pz, w, pf, pt, inten, valid, need, _ = case
    args = list(map(T, (px, py, pz, w, pf, pt, inten)))
    none = torch.zeros(L, dtype=torch.bool)
    empty = [torch.zeros((0, RC)) for _ in range(4)]
    zneed = torch.zeros(RC, dtype=torch.int32)
    for planes, v, nd in ((args[:4], none, T(need)), (empty, T(valid), zneed)):
        if kind == "discrete":
            out = tseg.gather_segments_discrete_lanes(
                *planes, *args[4:], v, STEP, sphere_radius=RADIUS,
                lane_need=nd, paired=True)
        else:
            out = tseg.gather_segments_analytic_lanes(
                *planes, *args[4:], v, sphere_radius=RADIUS,
                quad_rule="closed", lane_need=nd, paired=True)
        assert out.shape == (RC,) and not out.any()


def staged_entries(first, meta, ns, paired):
    """(segment, s) of each entry of the discrete kernel's sub-light table,
    placed as its stage_sublights places them: segment k of the range owns
    entries first[k] .. first[k] + slots_k - 1, slots_k = ns_k (paired:
    rounded up to a multiple of 4).  Every entry must be placed once."""
    start, count, total = (int(v) for v in meta)
    seg = np.full(total, -1)
    sub = np.full(total, -1)
    for k in range(start, start + count):
        slots = (int(ns[k]) + 3) // 4 * 4 if paired else int(ns[k])
        f = int(first[k])
        assert (seg[f:f + slots] == -1).all() and f + slots <= total
        seg[f:f + slots] = k
        sub[f:f + slots] = np.arange(slots)
    assert (seg >= 0).all()
    return seg, sub


def prefix_cases():
    """(pf, pt, inten, valid) tables: the scene's, and 40 segments with
    many of ns = 0, ns % 4 != 0 and a long one, valid on [3, 33)."""
    px, py, pz, w, pf, pt, inten, valid, need = scene()
    rs = np.random.RandomState(9)
    pf2 = (rs.randn(40, 3) * 5).astype(np.float32)
    pt2 = pf2 + (rs.randn(40, 3) * rs.choice([0.05, 0.5, 2.0], (40, 1))
                 ).astype(np.float32)
    pt2[7] = pf2[7] + np.float32([90.0, 0.0, 0.0])  # 300 sub-lights
    inten2 = (rs.rand(40) * 30).astype(np.float32)
    valid2 = (np.arange(40) >= 3) & (np.arange(40) < 33)
    return [(pf, pt, inten, valid), (pf2, pt2, inten2, valid2)]


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
def test_sublight_prefix_places_the_plain_versions_table(paired):
    """The discrete kernel's device-side prefix of ns places every
    sub-light where the plain version's _sublight_table has it: the same
    segment and s at each entry (paired: the same overrun slots), and the
    kernel's position a + (float(s) * step) * u, computed in f32 as the
    kernel computes it, bit for bit."""
    for pf, pt, inten, valid in prefix_cases():
        u, ns, ii, start, count = tseg.discrete_cols(
            T(pf), T(pt), T(inten), T(valid), STEP)
        first, meta = tseg.sublight_prefix(ns, start, count, paired)
        assert first.dtype == meta.dtype == torch.int32
        seg, sub = staged_entries(first.numpy(), meta.numpy(), ns.numpy(),
                                  paired)
        s0, c0 = tseg._light_range(start, count, len(pf))
        lx, ly, lz, lii, overrun, tseg_rel = tseg._sublight_table(
            T(pf), u, ns, ii, s0, c0, np.float32(STEP), paired)
        np.testing.assert_array_equal(seg, tseg_rel.numpy() + s0)
        np.testing.assert_array_equal(sub >= ns.numpy()[seg], overrun.numpy())
        sf = sub.astype(np.float32) * np.float32(STEP)
        un = u.numpy()
        for c, got in enumerate((lx, ly, lz)):
            np.testing.assert_array_equal(
                got.numpy(), pf[seg, c] + sf * un[seg, c])
        np.testing.assert_array_equal(lii.numpy(), ii.numpy()[seg])


def test_sublight_prefix_follows_expand_segments_order():
    """Where the two meet (a contiguous valid range, no cap reached), the
    exact tier's table holds the JAX package's expand_segments sub-lights
    in its order: its valid entries, segment by segment, s ascending."""
    for pf, pt, inten, valid in prefix_cases():
        u, ns, ii, start, count = tseg.discrete_cols(
            T(pf), T(pt), T(inten), T(valid), STEP)
        first, meta = tseg.sublight_prefix(ns, start, count, False)
        seg, sub = staged_entries(first.numpy(), meta.numpy(), ns.numpy(),
                                  False)
        cap = int(ns.max())
        jpos, jint, jvalid = map(np.asarray, jlights.expand_segments(
            pf, pt, inten, valid, STEP, cap))
        keep = np.nonzero(jvalid)[0]
        np.testing.assert_array_equal(keep // cap, seg)
        np.testing.assert_array_equal(keep % cap, sub)
        sf = sub.astype(np.float32) * np.float32(STEP)
        np.testing.assert_allclose(
            jpos[keep], pf[seg] + sf[:, None] * u.numpy()[seg], rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(
            jint[keep] * np.float32(1.0 / jlights.FOUR_PI), ii.numpy()[seg],
            rtol=1e-6)


def test_sublight_prefix_clamps_its_range():
    """The range clamps as the kernels clamp it (start >= 0, start + count
    <= L); segments outside it, and an empty range or table, place
    nothing."""
    ns = T(np.int32([3, 0, 5, 7, 2, 9]))
    first, meta = tseg.sublight_prefix(ns, T(4), T(10), True)
    assert meta.tolist() == [4, 2, 16]
    assert first.tolist() == [0, 0, 0, 0, 0, 4]
    first, meta = tseg.sublight_prefix(ns, T(-2), T(2), False)
    assert meta.tolist() == [0, 2, 3] and first.tolist() == [0, 3, 3, 3, 3, 3]
    for n, c in ((ns, 0), (torch.zeros(0, dtype=torch.int32), 5)):
        first, meta = tseg.sublight_prefix(n, T(0), T(c), False)
        assert meta.tolist()[2] == 0 and not first.any()


@pytest.mark.parametrize("paired", [False, True], ids=["exact", "paired"])
@pytest.mark.parametrize("radius", [None, RADIUS], ids=["ray", "beam"])
def test_discrete_plain_sums_in_table_order(radius, paired):
    """The plain discrete version adds a sample's sub-lights in table order
    (paired: its groups in order, each segment's part times the segment's
    ii where the segment ends) and a lane's samples in row order, as the
    kernel does: bit for bit against those sums written out in numpy, one
    term at a time, on the 40-segment table."""
    px, py, pz, w, _, _, _, _, need = scene()
    pf, pt, inten, valid = prefix_cases()[1]
    rad = None if radius is None else np.float32(radius)
    u, ns, ii, start, count = tseg.discrete_cols(
        T(pf), T(pt), T(inten), T(valid), STEP)
    s0, c0 = tseg._light_range(start, count, len(pf))
    lx, ly, lz, lii, overrun, seg = tseg._sublight_table(
        T(pf), u, ns, ii, s0, c0, np.float32(STEP), paired)
    use = np.arange(CP)[:, None] < need[None, :]
    x, y, z = (T(p[use])[:, None] for p in (px, py, pz))
    d2e, bad = (t.numpy() for t in tseg._d2e_bad(x, y, z, lx, ly, lz, rad))
    acc = np.zeros(d2e.shape[0], np.float32)
    if paired:
        q = np.where(bad | overrun.numpy(), np.float32(tseg.PAIR_BIG), d2e)
        segs, iis = seg.numpy(), ii.numpy()
        part = np.zeros_like(acc)
        for g in range(q.shape[1] // 4):
            q1, q2, q3, q4 = (q[:, 4 * g + i] for i in range(4))
            q12, q34 = q1 * q2, q3 * q4
            part = part + ((q1 + q2) * q34 + (q3 + q4) * q12) / (q12 * q34)
            if 4 * g + 4 == q.shape[1] or segs[4 * g + 4] != segs[4 * g]:
                acc = acc + iis[s0 + segs[4 * g]] * part
                part = np.zeros_like(acc)
    else:
        lis = lii.numpy()
        for t in range(d2e.shape[1]):
            term = lis[t] / np.maximum(d2e[:, t], np.float32(tseg.GUARD))
            acc = acc + np.where(bad[:, t], np.float32(0.0), term)
    full = np.zeros((CP, RC), np.float32)
    full[use] = acc
    terms = np.where(use, w * full, np.float32(0.0))
    want = np.zeros(RC, np.float32)
    for j in range(CP):
        want = want + terms[j]
    got = tseg.gather_segments_discrete_lanes_reference(
        *map(T, (px, py, pz, w, pf, pt, inten, valid)), STEP,
        sphere_radius=radius, lane_need=T(need), paired=paired)
    assert d2e.shape[1] > 300 and np.count_nonzero(want) > RC // 2
    np.testing.assert_array_equal(got.numpy(), want)
