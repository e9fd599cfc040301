"""Segment-light math of the analytic gather, in plain PyTorch.

Twins of the device helpers in volumerenderer_tpu/ops/pallas/gather_vpu.py,
term for term (same operations, same association, same f32 constants), so
that the plain versions in gather_segments.py round as the JAX kernels do
and csrc/gather_segments.cu can be read against them line by line.  Every
function is elementwise over broadcastable tensors; ``radius`` is a Python
float holding an f32 value.

The polynomial atan and cos are kept on purpose: libdevice's ``atanf``
differs from the minimax polynomial by up to ~2e-5 rad.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..lights import GUARD
from ..march import f32, sqrt

HALF_PI = f32(1.5707963267948966)
PI = f32(3.1415927410125732)


def _poly(z):
    z2 = z * z
    return z * (0.9998660 + z2 * (-0.3302995 + z2 * (
        0.1801410 + z2 * (-0.0851330 + z2 * 0.0208351))))


def atan(x):
    """Range-reduced odd minimax polynomial atan, |err| < 2e-5 rad."""
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.clamp(ax, min=1e-30), ax)
    p = _poly(z)
    p = torch.where(inv, HALF_PI - p, p)
    return torch.where(x < 0.0, -p, p)


def pos_ratio_parts(num, den):
    """(lo, hi, inverted) with tangent lo/hi <= 1 of num/den, num >= 0."""
    ad = torch.abs(den)
    return torch.minimum(num, ad), torch.maximum(num, ad), num > ad


def atan_pos_poly(z, inverted, den):
    """The angle of a min/max ratio z <= 1, with the inversion and the
    den < 0 quadrant."""
    p = _poly(z)
    p = torch.where(inverted, HALF_PI - p, p)
    return torch.where(den < 0.0, PI - p, p)


def atan_pos_ratio(num, den):
    """atan(num/den) + pi * (den < 0) for num >= 0, with one divide."""
    lo, hi, inv = pos_ratio_parts(num, den)
    return atan_pos_poly(lo / torch.clamp(hi, min=1e-30), inv, den)


def paired_pos_ratio_atans(num_a, den_a, num_b, den_b):
    """Two atan_pos_ratio evaluations sharing one divide."""
    lo_a, hi_a, inv_a = pos_ratio_parts(num_a, den_a)
    lo_b, hi_b, inv_b = pos_ratio_parts(num_b, den_b)
    inv = 1.0 / torch.clamp(hi_a * hi_b, min=1e-30)
    return (atan_pos_poly(lo_a * (hi_b * inv), inv_a, den_a),
            atan_pos_poly(lo_b * (hi_a * inv), inv_b, den_b))


def cos(x):
    """Even minimax polynomial cos on (-pi/2, pi/2), |err| < 3e-7."""
    z = x * x
    return 1.0 + z * (-4.9999936e-01 + z * (
        4.1664074e-02 + z * (-1.3856462e-03 + z * 2.3204736e-05)))


@functools.lru_cache(maxsize=None)
def gauss01(n: int):
    """Gauss-Legendre nodes and weights on [0, 1] as f32 numpy arrays."""
    x, w = np.polynomial.legendre.leggauss(n)
    return ((x + 1.0) / 2.0).astype(np.float32), (w / 2.0).astype(np.float32)


def rsqrt(x):
    """1 / sqrt(x), IEEE (the kernel's choice for jax.lax.rsqrt)."""
    return 1.0 / sqrt(x)


def cross_q2(d, u):
    """Cancellation-free squared distance |d x u|^2 to a segment's line,
    floored at the guard."""
    dx, dy, dz = d
    ux, uy, uz = u
    cx = dy * uz - dz * uy
    cy = dz * ux - dx * uz
    cz = dx * uy - dy * ux
    return torch.clamp(cx * cx + cy * cy + cz * cz, min=GUARD)


def subtended_angle(b, q2, qd, ll):
    """theta1 - theta0 of a segment [0, L] seen from the sample, via
    tan(dt) = L q / (q^2 - b (L - b))."""
    return atan_pos_ratio(ll * qd, q2 - b * (ll - b))


def closed_pre(d, u, b, ll, radius: float):
    """Closed-form VBL geometry up to the ds ratio: (ds_num, ds_den,
    (qc, d0, d1)); ds_den == 1 where the sample projects inside [0, L]."""
    q2 = cross_q2(d, u)
    qc = torch.clamp(sqrt(q2), min=f32(radius * 1.015625))
    qc2 = qc * qc
    lb = ll - b
    d0 = sqrt(qc2 + b * b)
    d1 = sqrt(qc2 + lb * lb)
    p0 = lb * d0
    p1 = b * d1
    den_c = p0 - p1
    inside = (b >= 0.0) & (b <= ll)
    ds_num = torch.where(inside, p0 + p1, qc2 * ll * (ll - 2.0 * b))
    ds_den = torch.where(inside, 1.0,
                         torch.where(den_c == 0.0, 1e-30, den_c))
    return ds_num, ds_den, (qc, d0, d1)


def closed_post(ds, b, ll, radius: float, geom):
    """The closed-form VBL antiderivative after the ds ratio, except its
    atan: (n_r, q_r, t_pre, numt, dent, qc)."""
    qc, d0, d1 = geom
    lb = ll - b
    sl = qc * ll
    A = (qc - radius) * (qc + radius)
    irA = rsqrt(A)
    kappa = (qc + radius) * irA
    n_r = radius * (ds - radius * ll)
    q_r = (A * qc) * ((d0 - radius) * (d1 - radius))
    numt = kappa * (ds + sl)
    dent = (d0 + qc) * (d1 + qc) - (kappa * kappa) * (b * lb)
    t_pre = (2.0 * qc) * (irA * irA * irA)
    return n_r, q_r, t_pre, numt, dent, qc


def closed_parts(d, u, b, ll, radius: float):
    ds_num, ds_den, geom = closed_pre(d, u, b, ll, radius)
    return closed_post(ds_num / ds_den, b, ll, radius, geom)


def quad_nodes_nq(rule: str, nodes: int, d, u, b, ll, radius: float):
    """Per-node (numerator, denominator) generator and the integral scale of
    the VBL quadrature ``rule``; node j contributes n_j / q_j, guarded and
    padding (j >= nodes) nodes are (0, 1).  The segment's contribution is
    ii * scale * sum_j n_j / q_j."""
    if rule == "midpoint":
        dx, dy, dz = d
        c = dx * dx + dy * dy + dz * dz

        def node_nq(j):
            if j >= nodes:
                return 0.0, 1.0
            s = ((j + 0.5) / nodes) * ll
            dist = sqrt(torch.clamp(c - 2.0 * b * s + s * s, min=0.0))
            dd = dist - radius
            d2e = dd * dd
            bad = (d2e < GUARD) | (dist == 0.0)
            return torch.where(bad, 0.0, 1.0), torch.where(bad, 1.0, d2e)

        return node_nq, ll / float(nodes)

    if rule == "tangent":
        xs, ws = gauss01(nodes)
        q2 = cross_q2(d, u)
        iq = rsqrt(q2)
        qd = q2 * iq
        t0 = atan(-b * iq)
        dt = subtended_angle(b, q2, qd, ll)

        def node_nq(j):
            if j >= nodes:
                return 0.0, 1.0
            cth = cos(t0 + float(xs[j]) * dt)
            e = qd - radius * cth
            e2 = e * e
            bad = e2 < GUARD * (cth * cth)
            return (torch.where(bad, 0.0, float(ws[j])),
                    torch.where(bad, 1.0, e2))

        return node_nq, dt * qd

    if rule == "closed":
        n_r, q_r, t_pre, numt, dent, qc = closed_parts(d, u, b, ll, radius)
        t_term = t_pre * atan_pos_ratio(numt, dent)

        def node_nq(j):
            if j == 0:
                return n_r, q_r
            if j == 1:
                return t_term, 1.0
            return 0.0, 1.0

        return node_nq, qc

    raise ValueError(f"unknown quadrature rule: {rule!r}")


def effective_quad_nodes(rule: str, nodes: int) -> int:
    """The closed form is exactly two interface nodes (rational + atan)."""
    return 2 if rule == "closed" else nodes


def node_sum(node_nq, nodes: int, paired: bool):
    """sum_j n_j / q_j: one divide per node, or (paired) one per 4 nodes via
    ((n1 q2 + n2 q1) q34 + (n3 q4 + n4 q3) q12) / (q12 q34)."""
    total = 0.0
    if paired:
        for j0 in range(0, nodes, 4):
            (n1, q1), (n2, q2), (n3, q3), (n4, q4) = (
                node_nq(j0), node_nq(j0 + 1), node_nq(j0 + 2), node_nq(j0 + 3))
            q12 = q1 * q2
            q34 = q3 * q4
            n12 = n1 * q2 + n2 * q1
            n34 = n3 * q4 + n4 * q3
            total = total + (n12 * q34 + n34 * q12) / (q12 * q34)
    else:
        for j in range(nodes):
            n, q = node_nq(j)
            total = total + n / q
    return total


def closed_pair_term(da, ua, ba, la, ii_a, db, ub, bb, lb, ii_b,
                     radius: float):
    """One trip of the closed-rule VBL pair loop (gather_vpu
    _closed_paired_sum): both segments' contributions with the three
    per-segment divides shared, 3 divides for 2 segments.  Returns the
    (rational, atan_a, atan_b) parts the trip adds, in that order."""
    dsn_a, dsd_a, ga = closed_pre(da, ua, ba, la, radius)
    dsn_b, dsd_b, gb = closed_pre(db, ub, bb, lb, radius)
    rec = 1.0 / (dsd_a * dsd_b)
    n_ra, q_ra, tp_a, nt_a, dt_a, qc_a = closed_post(
        dsn_a * (dsd_b * rec), ba, la, radius, ga)
    n_rb, q_rb, tp_b, nt_b, dt_b, qc_b = closed_post(
        dsn_b * (dsd_a * rec), bb, lb, radius, gb)
    ang_a, ang_b = paired_pos_ratio_atans(nt_a, dt_a, nt_b, dt_b)
    sa = ii_a * qc_a
    sb = ii_b * qc_b
    rat = ((sa * n_ra) * q_rb + (sb * n_rb) * q_ra) / (q_ra * q_rb)
    return rat, sa * (tp_a * ang_a), sb * (tp_b * ang_b)


def vrl_parts(d, u, b, ll):
    """(num, den, iq) of the closed-form VRL term: the subtended angle is
    atan_pos_ratio(num, den), the integral angle * iq."""
    q2 = cross_q2(d, u)
    iq = rsqrt(q2)
    return ll * (q2 * iq), q2 - b * (ll - b), iq
