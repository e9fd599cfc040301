"""Ray/box slab test (twin of volumerenderer_tpu.ops.intersect.intersect_aabb)."""

from __future__ import annotations

import torch


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
