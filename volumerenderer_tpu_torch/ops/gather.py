"""Radiance gather dispatch (twin of volumerenderer_tpu.ops.gather).

    point:   sum_l I_l / (4 pi |p - l|^2)         with |.|^2 < 1e-4 -> 0
    sphere:  sum_l I_l / (4 pi (|p - c_l| - r)^2)  same guard, centre -> 0
(common_functions.h:186-201); Ray/VRL and Beam/VBL segments through the
discrete sub-light sum or the analytic segment integral.  ``layout``
"lanes": (Cp, Rc) lane planes of a CompactView -> (Rc,) per-ray sums;
"slots": (R, C) planes of a ViewCache -> (R, C) weighted per-sample sums.
Above SMEM_LIGHT_LIMIT light slots, both layouts take the many-light
gather (kernels/gather_many.py), as the reference package does.
``*_xla`` are the plain oracles of the reference package's ``impl="xla"``,
with exact transcendentals.
"""

from __future__ import annotations

import torch

from .kernels import gather_vpu as vpu
from .kernels import segment_math as sm
from .kernels.gather_lanes import gather_lanes
from .kernels.gather_many import gather_many
from .kernels.gather_segments import (
    gather_segments_analytic_lanes, gather_segments_discrete_lanes,
)
from .lights import FOUR_PI, GUARD, SMEM_LIGHT_LIMIT, expand_segments
from .march import f32, sqrt

_PI = sm.PI


def gather_xla(samples, l_pos, l_int, l_valid, *, sphere: bool, radius=0.0,
               light_chunk: int = 512):
    """Plain light-chunked gather, the reference package's ``impl="xla"``
    oracle: samples (N, 3) -> (N,) radiance."""
    l_int = torch.where(l_valid, l_int, 0.0)
    # Park invalid lights far away so their zero terms cannot trip the guard.
    l_pos = torch.where(l_valid[:, None], l_pos, 1e15)
    acc = torch.zeros(samples.shape[0], dtype=torch.float32,
                      device=samples.device)
    for a in range(0, l_pos.shape[0], light_chunk):
        lp, li = l_pos[a:a + light_chunk], l_int[a:a + light_chunk]
        diff = samples[:, None, :] - lp[None, :, :]
        if sphere:
            dist = sqrt(torch.sum(diff * diff, dim=-1))
            d2 = (dist - radius) ** 2
            bad = (d2 < GUARD) | (dist == 0.0)
        else:
            d2 = torch.sum(diff * diff, dim=-1)
            bad = d2 < GUARD
        c = li[None, :] / (FOUR_PI * d2)
        acc = acc + torch.sum(torch.where(bad, 0.0, c), dim=-1)
    return acc


def gather(samples, l_pos, l_int, l_valid, *, sphere: bool, radius=0.0):
    """Samples (N, 3) -> (N,) unweighted radiance sums over any number of
    light slots with a per-slot validity, through the many-light gather.
    Distances are taken by direct differences, so the reference kernel's
    coordinate shift (its ``center``) has no counterpart here."""
    p = samples.T.contiguous()
    ones = torch.ones(samples.shape[0], dtype=torch.float32,
                      device=samples.device)
    return gather_many(p[0], p[1], p[2], ones, l_pos, l_int, l_valid,
                       sphere=sphere, radius=radius)


def gather_planes(px, py, pz, weight, l_pos, l_int, l_valid, *,
                  sphere: bool, radius=0.0, layout: str = "lanes",
                  lane_need=None, paired: bool = False):
    """Gather over lane planes (Cp, Rc) -> (Rc,) per-ray sums
    ``sum_samples(w * sum_lights)``, or (``layout="slots"``) over (R, C)
    planes -> (R, C) weighted sums ``w * sum_lights``.

    Up to SMEM_LIGHT_LIMIT slots the valid slots must form one contiguous
    range (true for photon lights and compacted expansions); its start and
    count stay on the device; ``paired=True``: one divide per 4 lights.
    Above it, the many-light gather takes any validity pattern, and
    ``paired`` and ``lane_need`` are ignored, as in the reference package;
    the lane layout sums the (Cp, Rc) weighted sums over samples here."""
    _check_layout("gather_planes", layout)
    if l_pos.shape[0] > SMEM_LIGHT_LIMIT:
        out = gather_many(px, py, pz, weight, l_pos, l_int, l_valid,
                          sphere=sphere, radius=radius)
        return out if layout == "slots" else torch.sum(out, dim=0)
    valid_i = l_valid.to(torch.int32)
    start = torch.argmax(valid_i)  # first valid slot (0 if none; count 0)
    count = valid_i.sum()
    if layout == "slots":
        return vpu.gather_vpu(px, py, pz, weight, l_pos, l_int, start, count,
                              sphere=sphere, radius=radius, paired=paired)
    return gather_lanes(
        px, py, pz, weight, l_pos, l_int, start, count, sphere=sphere,
        radius=radius, lane_need=lane_need, paired=paired,
    )


def _check_layout(name: str, layout: str) -> None:
    if layout not in ("lanes", "slots"):
        raise ValueError(f"{name}(layout={layout!r}): expected 'lanes' or "
                         "'slots'")


def _segment_frame(pos_from, pos_to, intensity, valid):
    """(u, length, ii = I / (4 pi L)) of the oracles."""
    seg = pos_to - pos_from
    length = torch.linalg.vector_norm(seg, dim=-1)
    safe = torch.where(length > 0, length, 1.0)
    ii = torch.where(valid & (length > 0), intensity / (FOUR_PI * safe), 0.0)
    return seg / safe[:, None], length, ii


def _safe_atan_ratio(num, den):
    """atan(num / den) + pi (den < 0), exact arctan (num >= 0)."""
    ad = torch.atan(num / torch.where(den == 0.0, 1e-30, den))
    return torch.where(den >= 0.0, ad, ad + _PI)


def segment_integral_xla(samples, pos_from, pos_to, intensity, valid):
    """Closed-form VRL line integral, plain oracle: I / (4 pi L) *
    int_0^L ds / d^2(s) per sample, (N, 3) -> (N,)."""
    u, length, ii = _segment_frame(pos_from, pos_to, intensity, valid)
    d = samples[:, None, :] - pos_from[None, :, :]  # (N, L, 3)
    b = torch.sum(d * u[None, :, :], dim=-1)
    cross = torch.linalg.cross(d, u[None, :, :].expand_as(d), dim=-1)
    q2 = torch.clamp(torch.sum(cross * cross, dim=-1), min=GUARD)
    q = sqrt(q2)
    ll = length[None, :]
    dt = _safe_atan_ratio(ll * q, q2 - b * (ll - b))
    return torch.sum(ii[None, :] * (dt / q), dim=-1)


def segment_sphere_quadrature_xla(samples, pos_from, pos_to, intensity,
                                  valid, radius, nodes: int,
                                  rule: str = "midpoint"):
    """VBL sphere-light integral, plain oracle with exact transcendentals:
    composite midpoint in s, Gauss-Legendre in the tangent-transformed
    variable, or the closed-form antiderivative (kept in its unrescaled
    normalized-trig form, an independent check of the kernels' algebra)."""
    u, length, ii = _segment_frame(pos_from, pos_to, intensity, valid)
    d = samples[:, None, :] - pos_from[None, :, :]
    b = torch.sum(d * u[None, :, :], dim=-1)
    c = torch.sum(d * d, dim=-1)
    r = f32(radius)
    ll = length[None, :]
    if rule in ("closed", "tangent"):
        cross = torch.linalg.cross(d, u[None, :, :].expand_as(d), dim=-1)
        q2 = torch.clamp(torch.sum(cross * cross, dim=-1), min=GUARD)
    if rule == "closed":
        qc = torch.clamp(sqrt(q2), min=f32(r * 1.015625))
        qc2 = qc * qc
        lb = ll - b
        d02 = qc2 + b * b
        d12 = qc2 + lb * lb
        id0 = 1.0 / sqrt(d02)
        id1 = 1.0 / sqrt(d12)
        c0 = qc * id0
        s0 = -b * id0
        c1 = qc * id1
        s1 = lb * id1
        sindt = qc * ll * id0 * id1
        direct = lb * id1 + b * id0
        den_c = lb * (d02 * id0) - b * (d12 * id1)
        conj = (qc2 * ll * (ll - 2.0 * b) * id0 * id1
                / torch.where(den_c == 0.0, 1e-30, den_c))
        ds = torch.where((b >= 0.0) & (b <= ll), direct, conj)
        A = (qc - r) * (qc + r)
        irA = 1.0 / sqrt(A)
        kappa = (qc + r) * irA
        n_r = (r * (irA * irA)) * (qc * ds - r * sindt)
        q_r = (qc - r * c0) * (qc - r * c1)
        numt = kappa * (ds + sindt)
        dent = (1.0 + c0) * (1.0 + c1) + (kappa * kappa) * (s1 * s0)
        ang = torch.atan(numt / torch.where(dent == 0.0, 1e-30, dent))
        ang = torch.where(dent < 0.0, ang + _PI, ang)
        total = n_r / q_r + (2.0 * qc) * (irA * irA * irA) * ang
        return torch.sum(ii[None, :] * (qc * total), dim=-1)
    if rule == "tangent":
        xs, ws = sm.gauss01(nodes)
        q = sqrt(q2)
        t0 = torch.atan(-b / q)
        dt = _safe_atan_ratio(ll * q, q2 - b * (ll - b))
        xj = torch.as_tensor(xs, device=samples.device)
        wj = torch.as_tensor(ws, device=samples.device)
        cth = torch.cos(t0[..., None] + xj * dt[..., None])
        e = q[..., None] - r * cth
        e2 = e * e
        bad = e2 < GUARD * (cth * cth)
        f = torch.where(bad, 0.0, wj / e2)
        total = torch.sum(f, dim=-1) * (dt * q)
        return torch.sum(ii[None, :] * total, dim=-1)
    if rule != "midpoint":
        raise ValueError(f"unknown quadrature rule: {rule!r}")
    s = (torch.arange(nodes, dtype=torch.float32, device=samples.device)
         + 0.5) / nodes
    sj = s[None, None, :] * length[None, :, None]
    dist = sqrt(torch.clamp(
        c[..., None] - 2.0 * b[..., None] * sj + sj * sj, min=0.0))
    dd = dist - r
    d2e = dd * dd
    bad = (d2e < GUARD) | (dist == 0.0)
    f = torch.where(bad, 0.0, 1.0 / torch.clamp(d2e, min=GUARD))
    total = torch.sum(f, dim=-1) * (length[None, :] / nodes)
    return torch.sum(ii[None, :] * total, dim=-1)


def segment_discrete_xla(samples, pos_from, pos_to, intensity, valid,
                         light_ray_step_size, *, sphere_radius=None,
                         max_points_per_segment: int = 512):
    """Discrete sub-light sum through the capped expansion, plain oracle:
    truncates segments past ``max_points_per_segment`` sub-lights (the
    kernels have no cap)."""
    pts, ints, vmask = expand_segments(pos_from, pos_to, intensity, valid,
                                       light_ray_step_size,
                                       max_points_per_segment)
    return gather_xla(samples, pts, ints, vmask,
                      sphere=sphere_radius is not None,
                      radius=0.0 if sphere_radius is None else sphere_radius)


def gather_segments_discrete(px, py, pz, weight, pos_from, pos_to, intensity,
                             valid, light_ray_step_size, *,
                             sphere_radius=None, layout: str = "lanes",
                             lane_need=None, paired: bool = False):
    """Reference-parity discrete Ray/VRL or Beam/VBL gather over lane planes
    (Cp, Rc) -> (Rc,) per-ray sums, or over slot planes (R, C) -> (R, C)
    weighted sums: the sub-lights are walked inside the kernel from the
    segment table, without caps."""
    _check_layout("gather_segments_discrete", layout)
    if layout == "slots":
        return vpu.gather_segments_discrete(
            px, py, pz, weight, pos_from, pos_to, intensity, valid,
            light_ray_step_size, sphere_radius=sphere_radius, paired=paired)
    return gather_segments_discrete_lanes(
        px, py, pz, weight, pos_from, pos_to, intensity, valid,
        light_ray_step_size, sphere_radius=sphere_radius,
        lane_need=lane_need, paired=paired)


def gather_segments(px, py, pz, weight, pos_from, pos_to, intensity, valid, *,
                    sphere_radius=None, quad_nodes: int = 16,
                    quad_rule: str = "midpoint", layout: str = "lanes",
                    lane_need=None, paired: bool = False):
    """Analytic Ray/VRL (closed form, ``sphere_radius=None``) or Beam/VBL
    (``quad_rule`` quadrature) gather over lane planes -> (Rc,) per-ray
    sums, or over slot planes -> (R, C) weighted sums."""
    _check_layout("gather_segments", layout)
    if layout == "slots":
        return vpu.gather_segments_analytic(
            px, py, pz, weight, pos_from, pos_to, intensity, valid,
            sphere_radius=sphere_radius, quad_nodes=quad_nodes,
            quad_rule=quad_rule, paired=paired)
    return gather_segments_analytic_lanes(
        px, py, pz, weight, pos_from, pos_to, intensity, valid,
        sphere_radius=sphere_radius, quad_nodes=quad_nodes,
        quad_rule=quad_rule, lane_need=lane_need, paired=paired)
