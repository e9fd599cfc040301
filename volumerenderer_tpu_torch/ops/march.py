"""Transmittance ray-march (twin of volumerenderer_tpu.ops.march).

Every ray is AABB-clipped to a step grid ``t_k = tmin + k * step``; one
density fetch per (ray, step); transmittance is the exclusive cumulative
product of the attenuations; the per-sample gather weight is
``w_k = T_k * val_k * step`` where the reference loop would execute step k
(``t < tmax`` and ``T > 0.001``).

Rounding: ``k * step`` and ``d * t`` each round once in f32 before the add,
as the reference package pins them.  Eager PyTorch keeps that as long as
no fused multiply-add op (``addcmul``, ``lerp``, ``baddbmm``) is used here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..grid.dense import DenseGrid
from . import intersect

T_CUTOFF = 0.001  # point_compute_color.comp:68

# The first sample is nudged inside the box by ENTRY_EPS * step so that
# floor() at the entry face is deterministic (reference package, ops.march).
ENTRY_EPS = 1e-3


def f32(x) -> float:
    """A Python float holding ``x`` rounded to f32."""
    return float(np.float32(x))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  On the CPU, PyTorch's f32 sqrt is
    off by an ulp on ~0.7% of inputs (measured on a Xeon with AVX-512);
    numpy's is IEEE, as XLA's and the CUDA kernels' sqrtf are."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def f32mul(a, b) -> float:
    """Scalar product rounded once in f32 (as a traced f32 scalar op)."""
    return float(np.float32(a) * np.float32(b))


def t_grid(tmin, k, step_size):
    """March distances tmin + k*step, the product rounded on its own."""
    return tmin[..., None] + k * step_size


def ray_positions(origin_idx, dir_idx, t):
    """Sample positions o + d*t, the product rounded on its own: (..., S, 3)."""
    return origin_idx[..., None, :] + dir_idx[..., None, :] * t[..., None]


class MarchResult(NamedTuple):
    t: torch.Tensor  # (N, S) march distances (index space)
    tmin: torch.Tensor  # (N,)
    tmax: torch.Tensor  # (N,) clipped exit distance
    val: torch.Tensor  # (N, S) density at each sample
    trans: torch.Tensor  # (N, S) transmittance before sample k
    active: torch.Tensor  # (N, S) bool: the loop would execute step k
    weight: torch.Tensor  # (N, S) = trans * val * step * active
    hit: torch.Tensor  # (N,) ray intersects the volume bbox


def _clip(grid, origin_idx, dir_idx, ray_max_distance, step_size, clip_box):
    """Bbox clip, entry nudge and the occupied-box advance by whole steps:
    returns (hit, live, tmin, tmax)."""
    zero = torch.zeros(origin_idx.shape[:-1], dtype=torch.float32,
                       device=origin_idx.device)
    far = zero + ray_max_distance
    hit, tmin, tmax = intersect.intersect_aabb(
        origin_idx, dir_idx, grid.box_min_f, grid.box_max_f, zero, far,
    )
    live = hit & (tmax > 0.0)
    tmin = torch.clamp(tmin, min=0.0) + f32mul(ENTRY_EPS, step_size)
    if clip_box is not None:
        lo, hi = clip_box
        hit2, u_lo, u_hi = intersect.intersect_aabb(
            origin_idx, dir_idx, lo, hi, zero, far,
        )
        live = live & hit2 & (u_hi > 0.0)
        # Skip leading vacuum by whole steps: sample phases stay those of
        # the unclipped march, so results are bit-identical.
        m = torch.floor(torch.clamp(u_lo - tmin, min=0.0) / step_size)
        tmin = tmin + m * step_size
        tmax = torch.minimum(tmax, u_hi + step_size)
    return hit, live, tmin, tmax


def march(
    grid: DenseGrid,
    origin_idx: torch.Tensor,
    dir_idx: torch.Tensor,
    *,
    ray_max_distance: float,
    step_size: float,
    absorption: float,
    max_steps: int,
    interpolation: str = "nearest",
    clip_box=None,
    occupied_cap: int | None = None,
    cell: int = 8,
) -> MarchResult:
    """March rays given in index space (origins (N, 3), unit dirs (N, 3)).

    ``max_steps`` bounds the trip count.  ``interpolation``: "nearest"
    (the reference's voxel fetch) or "trilinear" (8 taps).  ``clip_box``:
    optional (lo, hi) index-space corners of the occupied region
    (grid.dense.occupied_bbox); it clips the trilinear march too, as in the
    reference package.  ``occupied_cap`` with ``cell > 1`` and nearest
    sampling: brick-level empty-space skipping —
    the step grid is grouped into cells of ``cell`` samples, the dilated
    brick table is tested at cell endpoints, and the first
    ``ceil(occupied_cap / cell)`` selected cells of each ray expand back to
    fine samples.  Skipped samples have density exactly 0, so the support
    equals the full march's whenever the cap covers the selection."""
    hit, live, tmin, tmax = _clip(
        grid, origin_idx, dir_idx, ray_max_distance, step_size, clip_box
    )
    dev = origin_idx.device
    if occupied_cap is not None and interpolation == "nearest" and cell > 1:
        sel_c, n_cells = _select_cells(
            grid, origin_idx, dir_idx, tmin, tmax, live,
            step_size=step_size, max_steps=max_steps, cell=cell,
        )
        kc = min(max(1, -(-min(occupied_cap, max_steps) // cell)), n_cells)
        # Selected cells first, each group in ascending cell order (the
        # order top_k gives the reference package's descending keys).
        idx_c = torch.argsort((~sel_c).to(torch.uint8), dim=-1,
                              stable=True)[..., :kc]
        cell_ok = torch.gather(sel_c, -1, idx_c)
        j = torch.arange(cell, dtype=torch.int64, device=dev)
        kf = (idx_c[..., :, None] * cell + j).reshape(*idx_c.shape[:-1], -1)
        sel = torch.repeat_interleave(cell_ok, cell, dim=-1) & (kf < max_steps)
        t = t_grid(tmin, kf.to(torch.float32), step_size)
        val = grid.sample_nearest(ray_positions(origin_idx, dir_idx, t))
        val = torch.where(sel, val, 0.0)
    else:
        sel = None
        k = torch.arange(max_steps, dtype=torch.float32, device=dev)
        t = t_grid(tmin, k, step_size)
        pos = ray_positions(origin_idx, dir_idx, t)
        val = (grid.sample_trilinear(pos) if interpolation == "trilinear"
               else grid.sample_nearest(pos))

    atten = torch.exp(-val * absorption * step_size)
    # Exclusive cumprod: T before sample k (the shader attenuates after
    # accumulating).
    trans = torch.cat(
        [torch.ones_like(atten[..., :1]), torch.cumprod(atten[..., :-1], dim=-1)],
        dim=-1,
    )
    active = live[..., None] & (t < tmax[..., None]) & (trans > T_CUTOFF)
    if sel is not None:
        active = active & sel
    weight = torch.where(active, trans * val * step_size, 0.0)
    return MarchResult(t, tmin, tmax, val, trans, active, weight, hit)


def _select_cells(grid, origin_idx, dir_idx, tmin, tmax, live, *,
                  step_size, max_steps: int, cell: int):
    """Coarse-cell selection mask (N, n_cells): the dilated brick table
    tested at both cell endpoints, masked to live rays and cells starting
    before tmax."""
    n_cells = -(-max_steps // cell)
    c = torch.arange(n_cells + 1, dtype=torch.float32, device=origin_idx.device)
    t_c = t_grid(tmin, c * cell, step_size)
    occ_d = grid.brick_occupancy_dilated_at(
        ray_positions(origin_idx, dir_idx, t_c)
    )
    sel = occ_d[..., :-1] | occ_d[..., 1:]
    sel = sel & live[..., None] & (t_c[..., :-1] < tmax[..., None])
    return sel, n_cells


def occupancy_counts(
    grid: DenseGrid,
    origin_idx,
    dir_idx,
    *,
    ray_max_distance: float,
    step_size: float,
    max_steps: int,
    clip_box=None,
    cell: int = 8,
):
    """Per-ray fine-sample budget of the coarse-cell selection (selected
    cells x cell): the exact bound for ``march(..., occupied_cap=...)``.
    Reads only the dilated brick table.  Returns (N,) int32."""
    _, live, tmin, tmax = _clip(
        grid, origin_idx, dir_idx, ray_max_distance, step_size, clip_box
    )
    sel, _ = _select_cells(
        grid, origin_idx, dir_idx, tmin, tmax, live,
        step_size=step_size, max_steps=max_steps, cell=cell,
    )
    return (sel.sum(dim=-1) * cell).to(torch.int32)
