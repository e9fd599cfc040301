"""Photon-walk virtual-light generation (twin of
volumerenderer_tpu.render.photon).

Reference semantics (light_gen.comp:9-100): 16 photon threads per frame
start at ``lightSourceWorldPos`` with a uniform random direction and march
in fixed steps; at each occupied voxel a photon attenuates its intensity
and transmittance by ``exp(-val * absorption * dt)`` and rolls
``scatteringProbability``; a scatter appends a light {from = previous
scatter position, to = here, intensity} and re-marches from the scatter
point in a fresh random direction.

The walk is set up here (``walk_start``), for every photon at once: the
seeds, the first direction (draws 1 and 2), the clip against the volume
box.  Photons of several frames walk together: the photon axis carries
one frame count per photon, so a batch of F frames is one walk of F x 16
photons.  The window loop itself is ``ops.kernels.photon_walk``'s: on a
CUDA grid one launch of csrc/photon_walk.cu, a warp per photon, on the
card and with no host read; on a CPU grid the plain loop, which
evaluates a window of steps for every photon at once and reads back once
a window whether any photon is alive.  After it, the global
``max_lights`` clamp (``clamp_lights``) keeps each frame's events in
photon-major order.  Each call is a span, "photon.walk", and counts one
"walk" at "photon.walk.kernel" or "photon.walk.plain".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..engine.params import RenderParams, StaticConfig
from ..grid.dense import DenseGrid
from ..ops import intersect, rng
from ..ops.kernels import photon_walk
from ..ops.march import ENTRY_EPS, f32mul
from ..utils import profiling


@dataclass
class LightArray:
    """Fixed-size light slots of F frames (leading axis F)."""

    pos_from: torch.Tensor  # (F, L, 3) world
    pos_to: torch.Tensor  # (F, L, 3) world
    intensity: torch.Tensor  # (F, L)
    valid: torch.Tensor  # (F, L) bool
    count: torch.Tensor  # (F,) int32, lightCount after clamping
    # (F,) bool: a photon scattered with no free event slot, so the
    # max_events_per_photon budget truncated the light population.
    truncated: torch.Tensor

    def frame(self, i: int) -> "LightArray":
        """The lights of frame ``i`` of the batch, keeping a unit axis."""
        s = slice(i, i + 1)
        return LightArray(self.pos_from[s], self.pos_to[s], self.intensity[s],
                          self.valid[s], self.count[s], self.truncated[s])


def walk_start(
    grid: DenseGrid,
    params: RenderParams,
    frame_counts,
    config: StaticConfig,
    max_steps: int | None = None,
):
    """The walk's start state for the frames ``frame_counts`` (1-based
    frame counters, (F,) ints; the reference seeds with gid * frameCount):
    the (args, kwargs) of ``ops.kernels.photon_walk.photon_walk``.

    ``max_steps`` bounds each straight segment (a segment crosses the
    convex bbox at most once, so the bbox diagonal bound is exact)."""
    dev = grid.device
    f32 = torch.float32
    frame_counts = [int(fc) for fc in frame_counts]
    F = len(frame_counts)
    n = config.photon_grid
    P1 = config.num_photons
    P = F * P1
    S = max_steps if max_steps is not None else config.max_photon_steps

    # Photon p of a frame <-> gid (p % n, p // n, 0); x varies fastest.
    p_ids = torch.arange(P1, dtype=torch.int64, device=dev).repeat(F)
    fc = torch.cat([torch.full((P1,), fc, dtype=torch.int64, device=dev)
                    for fc in frame_counts])
    seed0 = rng.make_seed(p_ids % n, p_ids // n, torch.zeros_like(p_ids), fc)

    # Draws 1 and 2 of each photon in one call, their indices made on the
    # device, so that no host value is copied up.
    r12 = rng.randf_at(seed0[:, None, :],
                       torch.arange(1, 3, dtype=torch.int64, device=dev))
    dir_world = rng.random_dir(r12[:, 0], r12[:, 1])

    origin_world = torch.stack(
        [torch.full((P,), float(v), dtype=f32, device=dev)
         for v in params.light_source_world_pos], dim=-1,
    )
    origin_idx = grid.world_to_index(origin_world)
    d_idx = grid.world_to_index_dir(dir_world)
    d_idx = d_idx / rng.norm3(d_idx)

    step = params.ray_marching_step_size
    hit, tmin, tmax = intersect.intersect_aabb(
        origin_idx, d_idx, grid.box_min_f, grid.box_max_f,
        torch.zeros((P,), dtype=f32, device=dev),
        torch.full((P,), params.ray_max_distance, dtype=f32, device=dev),
    )
    args = (grid, seed0, origin_idx, d_idx, tmin + f32mul(ENTRY_EPS, step),
            tmax, hit, origin_world)
    kwargs = dict(step=step, absorption=params.absorption_coefficient,
                  scattering_probability=params.scattering_probability,
                  intensity=params.photon_initial_intensity,
                  max_events=config.max_events_per_photon, max_steps=S,
                  max_photon_steps=config.max_photon_steps)
    return args, kwargs


def clamp_lights(events, n_events, dropped, params: RenderParams,
                 config: StaticConfig) -> LightArray:
    """The walk's (events (P, K, 7), n_events (P,), dropped (P,)) of F
    frames as their lights: the global maxLights clamp per frame, in
    deterministic photon-major order."""
    dev = events.device
    f32 = torch.float32
    P1 = config.num_photons
    F = n_events.shape[0] // P1
    K = config.max_events_per_photon
    L = config.light_capacity
    ev = events.reshape(F, P1 * K, 7)
    valid_flat = (
        torch.arange(K, device=dev)[None, :] < n_events[:, None]
    ).reshape(F, P1 * K)
    rank = torch.cumsum(valid_flat.to(torch.int64), dim=-1)  # 1-based
    keep = valid_flat & (rank <= params.max_lights) & (rank <= L)
    dest = torch.where(keep, rank - 1, torch.full_like(rank, L))
    out = torch.zeros((F, L + 1, 7), dtype=f32, device=dev)
    out.scatter_(1, dest[:, :, None].expand(-1, -1, 7), ev)
    out = out[:, :L]
    count = torch.clamp(valid_flat.sum(dim=-1), max=params.max_lights)
    return LightArray(
        pos_from=out[..., 0:3].contiguous(),
        pos_to=out[..., 3:6].contiguous(),
        intensity=out[..., 6].contiguous(),
        valid=torch.arange(L, device=dev)[None, :] < count[:, None],
        count=count.to(torch.int32),
        truncated=dropped.reshape(F, P1).any(dim=-1),
    )


@profiling.spanned("photon.walk")
def generate_lights(
    grid: DenseGrid,
    params: RenderParams,
    frame_counts,
    config: StaticConfig,
    max_steps: int | None = None,
) -> LightArray:
    """Run the photon walk for the frames ``frame_counts``: its start
    state (``walk_start``), the walk, the clamp (``clamp_lights``)."""
    args, kwargs = walk_start(grid, params, frame_counts, config, max_steps)
    return clamp_lights(*photon_walk.photon_walk(*args, **kwargs), params,
                        config)


def empty_lights(config: StaticConfig, device="cpu") -> LightArray:
    """PATH's light generation is a no-op (path_light_gen.comp:9-11):
    lightCount stays 0 after the per-frame counter reset
    (src/main.cpp:722-728).  One frame of empty slots."""
    L = config.light_capacity
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    return LightArray(
        pos_from=z(1, L, 3), pos_to=z(1, L, 3), intensity=z(1, L),
        valid=z(1, L, dtype=torch.bool), count=z(1, dtype=torch.int32),
        truncated=z(1, dtype=torch.bool),
    )
