"""Geometric intersectors (twin of volumerenderer_tpu.ops.intersect):
branch-free, mask-returning, with the reference's IEEE semantics."""

from __future__ import annotations

import torch

from .rng import norm3


def intersect_aabb(origin, direction, box_min, box_max, tmin, tmax):
    """Slab test.  origin/direction (..., 3); box corners broadcast
    against them; tmin/tmax (...) initial interval.  Returns
    (hit, tmin, tmax) with the clipped interval; IEEE inf where a direction
    component is 0 and NaN propagation as in the reference."""
    inv_d = 1.0 / direction
    t0 = (box_min - origin) * inv_d
    t1 = (box_max - origin) * inv_d
    swap = inv_d < 0.0
    lo = torch.where(swap, t1, t0)
    hi = torch.where(swap, t0, t1)
    tmin = torch.maximum(tmin, torch.amax(lo, dim=-1))
    tmax = torch.minimum(tmax, torch.amin(hi, dim=-1))
    return tmax >= tmin, tmin, tmax


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def intersect_sphere(origin, direction, center, radius):
    """Ray-sphere (common_functions.h:73-102): (hit, t), the closest
    positive root (t 0 on a miss).  ``direction`` is unit length, as at
    the reference's call sites; a miss when both roots lie behind."""
    from .march import sqrt  # march imports this module

    oc = origin - center
    b = _dot(oc, direction)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    hit = (disc >= 0.0) & (t > 0.0)
    return hit, torch.where(hit, t, 0.0)


def intersect_thick_ray(cam_pos, cam_dir, line_origin, line_dir, width):
    """Segment-to-ray proximity test (common_functions.h:104-157):
    (hit, t_hit), t_hit the camera ray's parameter at the closest approach
    (0 on a miss); a hit needs distance <= ``width`` and t, s >= 0, or for
    parallel lines the line within ``width`` of the camera position."""
    cd = cam_dir / norm3(cam_dir)
    ld = line_dir / norm3(line_dir)
    w0 = cam_pos - line_origin
    a = _dot(cd, cd)
    b = _dot(cd, ld)
    c = _dot(ld, ld)
    d = _dot(cd, w0)
    e = _dot(ld, w0)
    denom = a * c - b * b
    parallel = torch.abs(denom) < 1e-6

    proj = line_origin + e[..., None] * ld
    hit_par = _dot(proj - cam_pos, proj - cam_pos) <= width * width

    inv = 1.0 / torch.where(parallel, 1.0, denom)
    t = (b * e - c * d) * inv
    s = (a * e - b * d) * inv
    p_cam = cam_pos + cd * t[..., None]
    p_line = line_origin + ld * s[..., None]
    dist2 = _dot(p_line - p_cam, p_line - p_cam)
    hit_gen = (dist2 <= width * width) & (t >= 0.0) & (s >= 0.0)

    hit = torch.where(parallel, hit_par, hit_gen)
    t_hit = torch.where(parallel, 0.0, t)
    return hit, torch.where(hit, t_hit, 0.0)
