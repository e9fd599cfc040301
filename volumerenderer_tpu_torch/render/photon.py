"""Photon-walk virtual-light generation (twin of
volumerenderer_tpu.render.photon).

Reference semantics (light_gen.comp:9-100): 16 photon threads per frame
start at ``lightSourceWorldPos`` with a uniform random direction and march
in fixed steps; at each occupied voxel a photon attenuates its intensity
and transmittance by ``exp(-val * absorption * dt)`` and rolls
``scatteringProbability``; a scatter appends a light {from = previous
scatter position, to = here, intensity} and re-marches from the scatter
point in a fresh random direction.

The walk is evaluated a window of steps at a time for every photon at
once (the RNG is counter-based, so every roll of a window is one
vectorized call); the first accepted scatter of each photon is found with
an argmax.  Photons of several frames walk together: the photon axis
carries one frame count per photon, so a batch of F frames is one walk of
F x 16 photons.  The window loop runs in Python and stops when no photon
is alive (one host read per window, counted as a sync at "photon.walk")
or at the reference package's iteration bound.  Each call is a span,
"photon.walk".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..engine.params import RenderParams, StaticConfig
from ..grid.dense import DenseGrid
from ..ops import intersect, rng
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


@profiling.spanned("photon.walk")
def generate_lights(
    grid: DenseGrid,
    params: RenderParams,
    frame_counts,
    config: StaticConfig,
    max_steps: int | None = None,
) -> LightArray:
    """Run the photon walk for the frames ``frame_counts`` (1-based frame
    counters, (F,) ints; the reference seeds with gid * frameCount).

    ``max_steps`` bounds each straight segment (a segment crosses the
    convex bbox at most once, so the bbox diagonal bound is exact)."""
    dev = grid.device
    f32 = torch.float32
    frame_counts = [int(fc) for fc in frame_counts]
    F = len(frame_counts)
    n = config.photon_grid
    P1 = config.num_photons
    P = F * P1
    K = config.max_events_per_photon
    S = max_steps if max_steps is not None else config.max_photon_steps

    # Photon p of a frame <-> gid (p % n, p // n, 0); x varies fastest.
    p_ids = torch.arange(P1, dtype=torch.int64, device=dev).repeat(F)
    fc = torch.cat([torch.full((P1,), fc, dtype=torch.int64, device=dev)
                    for fc in frame_counts])
    seed0 = rng.make_seed(p_ids % n, p_ids // n, torch.zeros_like(p_ids), fc)

    dir_world = rng.random_dir(rng.randf_at(seed0, 1), rng.randf_at(seed0, 2))
    n_draws = torch.full((P,), 2, dtype=torch.int64, device=dev)

    origin_world = torch.stack(
        [torch.full((P,), float(v), dtype=f32, device=dev)
         for v in params.light_source_world_pos], dim=-1,
    )
    origin_idx = grid.world_to_index(origin_world)
    d_idx = grid.world_to_index_dir(dir_world)
    d_idx = d_idx / rng.norm3(d_idx)

    step = params.ray_marching_step_size
    absorption = params.absorption_coefficient
    hit, tmin, tmax = intersect.intersect_aabb(
        origin_idx, d_idx, grid.box_min_f, grid.box_max_f,
        torch.zeros((P,), dtype=f32, device=dev),
        torch.full((P,), params.ray_max_distance, dtype=f32, device=dev),
    )

    origin = origin_idx
    direction = d_idx
    t0 = tmin + f32mul(ENTRY_EPS, step)
    trans = torch.ones((P,), dtype=f32, device=dev)
    intensity = torch.full((P,), params.photon_initial_intensity, dtype=f32,
                           device=dev)
    prev_pos = origin_world
    n_events = torch.zeros((P,), dtype=torch.int64, device=dev)
    alive = hit
    events = torch.zeros((P, K, 7), dtype=f32, device=dev)
    seg_steps = torch.zeros((P,), dtype=torch.int64, device=dev)
    dropped = torch.zeros((P,), dtype=torch.bool, device=dev)

    Wn = min(256, S)
    ks = torch.arange(Wn, dtype=f32, device=dev)
    ones = torch.ones((P, 1), dtype=f32, device=dev)
    max_iters = (K + 1) + max(1, config.max_photon_steps // Wn)
    it = 0
    while it < max_iters:
        profiling.count("sync", "photon.walk")
        if not bool(alive.any()):
            break
        it += 1
        t = t0[:, None] + ks[None, :] * step  # (P, Wn)
        pos = origin[:, None, :] + direction[:, None, :] * t[:, :, None]
        val = grid.sample_nearest(pos)
        occ = val > 0.0

        atten = torch.where(occ, torch.exp(-val * absorption * step), 1.0)
        cum_att = torch.cumprod(atten, dim=-1)  # inclusive
        excl = torch.cat([ones, cum_att[:, :-1]], dim=-1)
        trans_before = excl * trans[:, None]
        int_before = excl * intensity[:, None]
        # Loop-entry condition at step k (light_gen.comp:51), on the
        # pre-attenuation values, within tmax of the initial clip.
        entered = (
            alive[:, None]
            & (t < tmax[:, None])
            & (trans_before > 0.001)
            & (int_before > 0.01)
        )

        # Occupied voxel k consumes one draw after its attenuation; the
        # draw index is n_draws + #occupied in [0..k].
        occ_rank = torch.cumsum((occ & entered).to(torch.int64), dim=-1)
        roll = rng.randf_at(seed0[:, None, :], n_draws[:, None] + occ_rank)
        scatter = occ & entered & (roll < params.scattering_probability)

        any_scatter = scatter.any(dim=-1)
        k_star = torch.argmax(scatter.to(torch.int8), dim=-1)[:, None]
        att_at = torch.gather(cum_att, 1, k_star)[:, 0]
        new_trans = trans * att_at
        new_int = intensity * att_at
        draws_used = torch.gather(occ_rank, 1, k_star)[:, 0]
        scat_pos = torch.gather(pos, 1, k_star[:, :, None].expand(-1, 1, 3))[:, 0]

        # New direction: two more draws (light_gen.comp:72), used
        # directly in index space as the reference does.
        nd1 = rng.randf_at(seed0, n_draws + draws_used + 1)
        nd2 = rng.randf_at(seed0, n_draws + draws_used + 2)
        new_dir = rng.random_dir(nd1, nd2)

        # Emit into the photon's next free slot; a scatter with no free
        # slot is a dropped event (the truncation signal).
        scat_world = grid.index_to_world(scat_pos)
        can_store = any_scatter & (n_events < K)
        dropped = dropped | (any_scatter & ~can_store)
        slot = torch.clamp(n_events, 0, K - 1)[:, None, None].expand(-1, 1, 7)
        record = torch.cat([prev_pos, scat_world, new_int[:, None]], dim=-1)
        events.scatter_(
            1, slot,
            torch.where(can_store[:, None, None], record[:, None, :],
                        torch.gather(events, 1, slot)),
        )

        # No scatter in this window: the segment continues into the next
        # window iff the walk was live at the window's end and the
        # segment is still within its bbox-crossing bound S.
        seg_steps = seg_steps + Wn
        cont = ~any_scatter & entered[:, -1] & (seg_steps < S)
        win_att = cum_att[:, -1]

        origin = torch.where(any_scatter[:, None], scat_pos, origin)
        direction = torch.where(any_scatter[:, None], new_dir, direction)
        # After a scatter currentT = 0, then += step before the next sample.
        t0 = torch.where(any_scatter, torch.full_like(t0, step),
                         t0 + float(Wn) * step)
        trans = torch.where(any_scatter, new_trans,
                            torch.where(cont, trans * win_att, trans))
        intensity = torch.where(any_scatter, new_int,
                                torch.where(cont, intensity * win_att, intensity))
        prev_pos = torch.where(can_store[:, None], scat_world, prev_pos)
        n_draws = n_draws + torch.where(
            any_scatter, draws_used + 2,
            torch.where(cont, occ_rank[:, -1], torch.zeros_like(draws_used)),
        )
        n_events = n_events + can_store.to(torch.int64)
        alive = alive & (any_scatter | cont)
        seg_steps = torch.where(any_scatter, torch.zeros_like(seg_steps),
                                seg_steps)

    # Global maxLights clamp per frame, deterministic photon-major order.
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
