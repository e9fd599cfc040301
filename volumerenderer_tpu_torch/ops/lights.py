"""Light-model constants and segment expansion (twin of
volumerenderer_tpu.ops.lights).

A Ray/Beam segment from -> to is discretized every ``light_ray_step_size``
into floor(len/step) sub-lights of intensity I/steps
(ray_compute_color.comp:11-24, beam_compute_color.comp:11-24).
``expand_segments`` materializes them as a flat point/sphere light array;
``compact_valid`` packs the valid ones into a bounded buffer.
"""

from __future__ import annotations

import torch

GUARD = 1e-4  # d^2 guard from common_functions.h:190
FOUR_PI = 4.0 * 3.14159265358979323846

# Light slots the lane and slot point gathers take; above it both layouts
# take the many-light gather (kernels/gather_many.py), the threshold at
# which the reference package takes its gather_mxu, so one config runs the
# same kernel body in both packages.
SMEM_LIGHT_LIMIT = 2048


def segment_point_count(pos_from, pos_to, light_ray_step_size):
    """floor(|to - from| / step) as int32 (ray_compute_color.comp:15).
    ``vector_norm`` rounds as the reference package's ``jnp.linalg.norm``
    does on the CPU (bit for bit), so the floor flips where it does."""
    length = torch.linalg.vector_norm(pos_to - pos_from, dim=-1)
    return (length / light_ray_step_size).to(torch.int32)


def expand_segments(pos_from, pos_to, intensity, valid, light_ray_step_size,
                    max_points_per_light: int):
    """Discretize segment lights (L,) into point lights (L * S,), S =
    ``max_points_per_light``: sub-light s sits at from + (s * step) * dir for
    s < min(steps, S), with intensity I / steps (the uncapped count).
    Returns (positions (L*S, 3), intensities (L*S,), valid (L*S,))."""
    seg = pos_to - pos_from
    length = torch.linalg.vector_norm(seg, dim=-1)
    direction = seg / torch.where(length > 0.0, length, 1.0)[:, None]
    steps = (length / light_ray_step_size).to(torch.int32)
    steps_c = torch.clamp(steps, max=max_points_per_light)
    s = torch.arange(max_points_per_light, dtype=torch.float32,
                     device=pos_from.device)
    pts = (pos_from[:, None, :]
           + (s[None, :, None] * light_ray_step_size) * direction[:, None, :])
    sub_valid = (valid[:, None]
                 & (s[None, :].to(torch.int32) < steps_c[:, None])
                 & (steps[:, None] > 0))
    sub_int = torch.where(
        steps[:, None] > 0,
        intensity[:, None] / torch.clamp(steps[:, None], min=1).to(torch.float32),
        0.0,
    )
    L, S = pts.shape[0], pts.shape[1]
    return (pts.reshape(L * S, 3), sub_int.expand(L, S).reshape(L * S),
            sub_valid.reshape(L * S))


def compact_valid(positions, intensities, valid, capacity: int):
    """Pack the valid lights, in order, into ``capacity`` slots; overflow is
    dropped and counted.  Returns (pos (C, 3), inten (C,), valid (C,),
    n_dropped)."""
    rank = torch.cumsum(valid.to(torch.int32), dim=0)  # 1-based
    keep = valid & (rank <= capacity)
    dest = torch.where(keep, rank - 1, capacity).to(torch.int64)
    # Dropped entries land in the extra row `capacity`, then cut.
    out_pos = positions.new_zeros((capacity + 1, 3)).index_copy_(
        0, dest, positions)[:capacity]
    out_int = intensities.new_zeros(capacity + 1).index_copy_(
        0, dest, intensities)[:capacity]
    total = valid.to(torch.int32).sum()
    count = torch.clamp(total, max=capacity)
    out_valid = torch.arange(capacity, device=valid.device) < count
    return out_pos, out_int, out_valid, total - count
