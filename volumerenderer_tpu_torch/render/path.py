"""PATH: per-pixel stochastic single-scattering path trace (twin of
volumerenderer_tpu.render.path; path_compute_color.comp).

Reference semantics: camera-ray fixed-step march; at each occupied voxel,
roll ``scatteringProbability``; on success redirect the ray (random
direction, origin reset, t = 0, path_compute_color.comp:96-104); every
occupied voxel adds in-scattering from the single configured light
(``computeLightContribution``, :9-31).  Neither transmittance nor intensity
is ever attenuated, so a walk ends only past the clipped tmax; the color is
``clamp(finalColor)``, averaged by frameCount.

``Fidelity.REFERENCE`` reproduces the reference light term literally: the
density at ONE fixed point one step from the light, raised to the number
of steps.  ``Fidelity.CORRECTED`` marches the light->sample segment.

Structure (every level exact):

  1. Camera segment, baked (``bake_path_view`` -> ``PathView``): the march
     positions, densities, light terms and the prefix of the in-scattering
     contributions depend on camera, volume, light and march parameters,
     not on the frame counter.  The per-ray RNG draw index of a roll site
     is its occupancy rank, so the bake stores, rank by rank, the sample
     index (``rank_k``) and the prefix (``rank_prefix``) of each roll
     site.  A frame replays the segment from these planes: the draws at
     ranks 1..S, the first rank that scatters, and two gathers.
  2. Shadow-probe LUT: the REFERENCE light term reads the density at a
     point within ``step`` of the light, so with R = ceil(step) the
     (2R+1)^3 voxels around the light hold every value it can read; a
     lookup is one indexed load, bit-equal to the gather.
  3. Scatter segments: only rays that scattered stay alive.  Each segment
     compacts the alive rays (ordered by a bound on their walk cost), walks
     them in chunks of ``path_chunk`` rays, and writes the walked rows
     contiguously as the next segment's state; ``orig`` holds each row's
     image index (-1 once resolved) and the RNG seeds are re-derived from
     it.  A chunk marches sub-blocks of samples and stops when every ray
     in it is resolved (one host read per sub-block).

Positions go through ops.march.t_grid / ray_positions, so every path sees
bit-identical sample positions (a 1-ulp difference would flip floor() at a
voxel boundary and fork the walk).  Float sums over a row are halving
trees of elementwise adds (``_row_sum``), so a ray's color does not depend
on how many rays share its launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.params import Fidelity, RenderParams, StaticConfig
from ..grid.dense import DenseGrid
from ..ops import intersect, rng
from ..ops.march import ENTRY_EPS, _select_cells, f32, f32mul, ray_positions
from ..ops.march import sqrt, t_grid
from ..utils import profiling
from .color import camera_rays_index

# Bytes of one (tile, S) int64 temporary of the camera segment's bake and
# replay: the tiles (and the padding of the view) are sized by it.
TILE_BYTES = 256 << 20
# Samples per sub-block of the scatter walk (one host read each).
SUBBLOCK = 32
# "auto" path_sort_key: "cells" up to this many rays a frame, "span" above
# (the reference package's crossover).
SORT_CELLS_MAX_RAYS = 262144

_I32_MAX = 2**31 - 1


class PathView(NamedTuple):
    """Frame-invariant planes of the camera segment, padded to a whole
    number of tiles (``n_pad`` rows; padding rows are not live).

    Column ``r`` of ``rank_k`` / ``rank_prefix`` holds the sample index and
    the inclusive contribution prefix of the ray's rank-``r+1`` roll site;
    columns at or beyond ``n_occ`` (the ray's roll-site total) are filler
    and never read.  ``prefix_total`` is the full-ray prefix (the color of
    a ray that never scatters)."""

    o_i: torch.Tensor  # (n_pad, 3) camera origins, index space
    d_i: torch.Tensor  # (n_pad, 3) unit directions, index space
    tmin: torch.Tensor  # (n_pad,) entry distance (ENTRY_EPS applied)
    tmax: torch.Tensor  # (n_pad,) clipped exit distance
    live: torch.Tensor  # (n_pad,) bool: the ray marches at all
    rank_k: torch.Tensor  # (n_pad, S) int16: sample index of rank r+1
    n_occ: torch.Tensor  # (n_pad,) int16: roll sites on the ray
    rank_prefix: torch.Tensor  # (n_pad, S) f32: prefix at rank r+1
    prefix_total: torch.Tensor  # (n_pad,) f32: full-ray prefix


def view_bytes(n_pad: int, S: int) -> int:
    """Bytes of a PathView of n_pad rows: rank_k and rank_prefix per step,
    then o_i, d_i, tmin, tmax, live, n_occ and prefix_total per ray."""
    return n_pad * (6 * S + 12 + 12 + 4 + 4 + 1 + 2 + 4)


def padded_rays(n_rays: int, S: int, tile_bytes: int = TILE_BYTES) -> int:
    """Rows of the PathView of ``n_rays`` rays (a whole number of tiles)."""
    return _tiling(n_rays, S, tile_bytes)[0]


def _tiling(n_rays: int, S: int, tile_bytes: int):
    """(n_pad, tile): the fewest tiles whose (tile, S) int64 temporary fits
    ``tile_bytes``, evened out over the rays and rounded up to 32 rays."""
    cap = max(32, tile_bytes // (8 * S) // 32 * 32)
    m = -(-n_rays // cap)
    tile = -(-(-(-n_rays // m)) // 32) * 32
    return m * tile, tile


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a halving tree of elementwise adds (zero
    padded to a power of two): the same order for any number of rows."""
    w = x.shape[-1]
    p = 1 << (w - 1).bit_length()
    if p != w:
        x = F.pad(x, (0, p - w))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the trailing axis: the root of x*x + y*y + z*z, in order."""
    x, y, z = v.unbind(-1)
    return sqrt(x * x + y * y + z * z)


def _light_local(grid: DenseGrid, params: RenderParams) -> torch.Tensor:
    profiling.count("sync", "path.upload")
    return grid.world_to_index(torch.as_tensor(
        params.light_source_world_pos, dtype=torch.float32,
        device=grid.device))


def _intensity_scale(params: RenderParams) -> float:
    return float(np.float32(params.photon_initial_intensity)
                 / np.float32(10000.0))


# ---------------------------------------------------------------------------
# light terms


def _lut_offsets(radius: int) -> np.ndarray:
    L = 2 * radius + 1
    return np.stack(
        np.meshgrid(*([np.arange(L, dtype=np.int64)] * 3), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)


def _shadow_lut(grid: DenseGrid, light_local, radius: int):
    """Densities of the (2R+1)^3 voxels around the light, read at the
    voxel centres: valid for any probe within R of the light."""
    base = torch.floor(light_local).to(torch.int64) - radius
    profiling.count("sync", "path.upload")
    offs = torch.as_tensor(_lut_offsets(radius), device=light_local.device)
    vals = grid.sample_nearest((base + offs).to(torch.float32) + 0.5)
    return base, vals


def _lut_lookup(probe, base, vals, radius: int):
    """sample_nearest(probe) from the LUT: one indexed load (0 outside it,
    as the reference package's select-sum)."""
    L = 2 * radius + 1
    rel = torch.floor(probe).to(torch.int64) - base
    lin = (rel[..., 0] * L + rel[..., 1]) * L + rel[..., 2]
    ok = (lin >= 0) & (lin < L * L * L)
    return torch.where(ok, vals[torch.clamp(lin, 0, L * L * L - 1)], 0.0)


def _light_term_reference(grid, sample_local, light_local, params, lut=None,
                          light_step=None):
    """computeLightContribution (path_compute_color.comp:9-31), literally:
    the density at light + dir * step, attenuated once per step of the
    distance.  ``lut``: (base, vals, radius), radius >= ceil(step).
    ``light_step``: the step the term derives its probe and count from
    (the path_stride tier passes the original step)."""
    step = (params.ray_marching_step_size if light_step is None
            else f32(light_step))
    ray_local = light_local - sample_local
    length = _norm(ray_local)
    ray_dir = ray_local / torch.where(length > 0, length, 1.0)[..., None]
    n_steps = (length / step).to(torch.int32)
    probe = light_local + ray_dir * step
    if lut is None:
        val = grid.sample_nearest(probe)
    else:
        base, vals, radius = lut
        val = _lut_lookup(probe, base, vals, radius)
    return _intensity_scale(params) * torch.exp(
        -val * params.absorption_coefficient * step
        * n_steps.to(torch.float32))


# Positions per piece of the corrected light term's (..., n_shadow, 3)
# march (bounds its temporaries; pieces are exact).
_CORRECTED_ELEMS = 1 << 24


def _light_term_corrected(grid, sample_local, light_local, params,
                          n_shadow: int):
    """Transmittance along the light->sample segment, n_shadow steps at
    most."""
    shape = sample_local.shape[:-1]
    flat = sample_local.reshape(-1, 3)
    piece = max(1, _CORRECTED_ELEMS // n_shadow)
    dt = params.ray_marching_step_size
    s = torch.arange(1, n_shadow + 1, dtype=torch.float32,
                     device=flat.device)
    out = []
    for a in range(0, flat.shape[0], piece):
        seg = flat[a:a + piece] - light_local
        length = _norm(seg)
        direction = seg / torch.where(length > 0, length, 1.0)[..., None]
        n_steps = (length / dt).to(torch.int32)
        pts = light_local + direction[:, None, :] * (s[:, None] * dt)
        vals = grid.sample_nearest(pts)
        mask = s <= torch.clamp(n_steps, max=n_shadow)[:, None]
        od = _row_sum(torch.where(mask, vals, 0.0)) * f32mul(
            params.absorption_coefficient, dt)
        out.append(_intensity_scale(params) * torch.exp(-od))
    return torch.cat(out).reshape(shape)


def _light_term(grid, pos, light_local, params, config, lut, n_shadow,
                light_step=None):
    if config.fidelity is Fidelity.REFERENCE:
        return _light_term_reference(grid, pos, light_local, params, lut,
                                     light_step=light_step)
    # CORRECTED marches the light segment at the march step.
    return _light_term_corrected(grid, pos, light_local, params, n_shadow)


def _make_lut(grid, params, config, shadow_lut_radius):
    if shadow_lut_radius <= 0 or config.fidelity is not Fidelity.REFERENCE:
        return None
    base, vals = _shadow_lut(grid, _light_local(grid, params),
                             shadow_lut_radius)
    return (base, vals, shadow_lut_radius)


# ---------------------------------------------------------------------------
# camera rays and seeds


def _pad_rays(o_i, d_i, n_pad: int):
    pad = n_pad - o_i.shape[0]
    o_i = F.pad(o_i, (0, 0, 0, pad))
    profiling.count("sync", "path.upload")
    d_pad = torch.tensor([0.0, 0.0, 1.0], device=d_i.device).expand(pad, 3)
    return o_i, torch.cat([d_i, d_pad], dim=0)


class _SeedSpec(NamedTuple):
    """What a row's RNG seed is a function of: its index ``og`` in the
    concatenated frames (n_pad_frame rows each) and the frame counters."""

    width: int
    rows: int
    row_start: int
    frame_counts: torch.Tensor  # (F,) int64
    n_pad_frame: int


def _chunk_seeds(og: torch.Tensor, spec: _SeedSpec) -> torch.Tensor:
    """Per-pixel seeds uvec3(px, py, 0) * frameCount
    (path_compute_color.comp:36-37) for rows ``og`` (>= 0); 0 for padding
    rows.  py is the global image row (row_start keeps seeds band-
    invariant)."""
    og = og.to(torch.int64)
    ol = og % spec.n_pad_frame
    fc = spec.frame_counts[og // spec.n_pad_frame]
    in_img = ol < spec.rows * spec.width
    px = ol % spec.width
    py = spec.row_start + ol // spec.width
    seeds = rng.make_seed(px, py, torch.zeros_like(px), fc)
    return torch.where(in_img[:, None], seeds, 0)


# ---------------------------------------------------------------------------
# camera segment: bake and replay


def _seg1_planes(grid, params, config, lut, S, o, d, real, light_step=None):
    """Frame-invariant planes of a tile of camera rays (``real``: (n,) bool,
    False on padding rows)."""
    n = o.shape[0]
    step = params.ray_marching_step_size
    zero = torch.zeros(n, device=o.device)
    hit, tmin, tmax = intersect.intersect_aabb(
        o, d, grid.box_min_f, grid.box_max_f, zero,
        zero + params.ray_max_distance,
    )
    # Entry-face disambiguation (ops.march.ENTRY_EPS).
    tmin = torch.where(hit, tmin, 0.0) + f32mul(ENTRY_EPS, step)
    live = hit & (tmax > tmin) & real
    ks = torch.arange(S, dtype=torch.float32, device=o.device)
    t = t_grid(tmin, ks, step)
    pos = ray_positions(o, d, t)
    val = grid.sample_nearest(pos)
    roll_site = (val > 0.0) & live[:, None] & (t < tmax[:, None])
    light_in = _light_term(grid, pos, _light_local(grid, params), params,
                           config, lut, S, light_step=light_step)
    d_c = torch.where(roll_site, val * step * light_in, 0.0)
    prefix = torch.cumsum(d_c, dim=-1)
    # The per-site RNG draw rank is frame-invariant: it depends only on the
    # roll-site pattern.
    occ_rank = torch.cumsum(roll_site.to(torch.int32), dim=-1,
                            dtype=torch.int32)
    site_rank = torch.where(roll_site, occ_rank, 0).to(torch.int16)
    n_occ = occ_rank[:, -1].to(torch.int16)
    return tmin, tmax, live, site_rank, n_occ, prefix


def _seg1_planes_ranked(grid, params, config, lut, S, o, d, real,
                        light_step=None):
    """_seg1_planes laid out by occupancy rank (see PathView): a stable row
    sort on the rank key, non-sites keyed S + 1, after every site."""
    tmin, tmax, live, site_rank, n_occ, prefix = _seg1_planes(
        grid, params, config, lut, S, o, d, real, light_step=light_step)
    key = torch.where(site_rank > 0, site_rank.to(torch.int32), S + 1)
    _, sk = torch.sort(key, dim=-1, stable=True)
    return (tmin, tmax, live, sk.to(torch.int16), n_occ,
            torch.gather(prefix, -1, sk), prefix[:, -1])


def _redirect(params, o, d, tmin, k_star, any_sc, draws, seed0):
    """The walk state leaving the camera segment: scattered rays re-origin
    at sample ``k_star`` in a fresh direction (draws + 1, + 2)."""
    step = params.ray_marching_step_size
    nd1 = rng.randf_at(seed0, draws + 1)
    nd2 = rng.randf_at(seed0, draws + 2)
    new_dir = rng.random_dir(nd1, nd2)  # index space, as in the reference
    t_sc = t_grid(tmin, k_star.to(torch.float32)[:, None], step)
    scat_pos = ray_positions(o, d, t_sc)[:, 0, :]
    origin2 = torch.where(any_sc[:, None], scat_pos, o)
    dir2 = torch.where(any_sc[:, None], new_dir, d)
    seed_draws2 = draws + torch.where(any_sc, 2, 0)
    return origin2, dir2, seed_draws2


def _seg1_frame(params, o, d, tmin, live, site_rank, n_occ, prefix, seed0):
    """Camera segment of one frame from site-ranked planes (the uncached
    path): the scatter site is the roll site of least rank whose draw is
    below the scattering probability.  Returns (color, origin2, dir2,
    seed_draws2, alive2)."""
    prob = params.scattering_probability
    sr = site_rank.to(torch.int64)
    roll = rng.randf_at(seed0[:, None, :], sr)
    scatter = (sr > 0) & (roll < prob)
    any_sc = scatter.any(dim=-1)
    # Ranks increase along the ray: the first scatter has the least rank.
    k_star = scatter.to(torch.int8).argmax(dim=-1)
    r_min = torch.gather(sr, -1, k_star[:, None])[:, 0]
    color = torch.where(any_sc, torch.gather(prefix, -1, k_star[:, None])[:, 0],
                        prefix[:, -1])
    draws = torch.where(any_sc, r_min, n_occ.to(torch.int64))
    o2, d2, sd2 = _redirect(params, o, d, tmin, k_star, any_sc, draws, seed0)
    return color, o2, d2, sd2, live & any_sc


def _seg1_frame_rank(params, S, o, d, tmin, n_occ, rank_k, rank_prefix,
                     prefix_total, seed0):
    """Camera segment of one frame from the rank planes (PathView): the
    draws at ranks 1..S, the least rank that scatters (a scatter exists iff
    it is <= n_occ), and the winner's sample index and prefix by one gather
    each.  Bit-identical to _seg1_frame on the same planes."""
    prob = params.scattering_probability
    ranks = torch.arange(1, S + 1, dtype=torch.int64, device=o.device)
    roll = rng.randf_at(seed0[:, None, :], ranks)
    r_min = torch.where(roll < prob, ranks, S + 1).amin(dim=-1)
    n_occ64 = n_occ.to(torch.int64)
    any_sc = r_min <= n_occ64
    col = (torch.clamp(r_min, max=S) - 1)[:, None]
    color = torch.where(any_sc, torch.gather(rank_prefix, -1, col)[:, 0],
                        prefix_total)
    k_star = torch.gather(rank_k, -1, col)[:, 0].to(torch.int64)
    draws = torch.where(any_sc, r_min, n_occ64)
    o2, d2, sd2 = _redirect(params, o, d, tmin, k_star, any_sc, draws, seed0)
    return color, o2, d2, sd2, any_sc


# ---------------------------------------------------------------------------
# scatter segments (2..max_path_segments)


def _walk_chunk(grid, params, config, lut, S, light_local, o, d, seed0,
                seed_draws, tmax, alive, *, march_cell=1, light_step=None,
                subblock=SUBBLOCK):
    """One scatter segment for a chunk of rays: t0 = step (the reference
    resets currentT on scatter), march to the ray's original tmax.
    Returns (d_color, origin', dir', seed_draws', alive').

    The sample axis runs in sub-blocks; after each, one host read stops
    the loop once every ray is resolved: scattered, past its box exit (no
    density beyond, so no further roll site) or past tmax.  Skipped blocks
    are all masked, so results are exact.

    ``march_cell > 1`` walks only the coarse cells that touch an occupied
    brick (ops.march._select_cells), in ascending t: skipped cells have
    density exactly 0, so they host no roll site and consume no draw.  The
    caller keeps ``march_cell * step`` within one 8-voxel brick."""
    step = params.ray_marching_step_size
    prob = params.scattering_probability
    n = o.shape[0]
    dev = o.device
    SB = min(max(8, subblock), S)
    t0 = torch.full((n,), step, dtype=torch.float32, device=dev)
    zero = torch.zeros(n, device=dev)
    # Box exit from the segment origin (origins are scatter sites inside
    # the volume; a straight ray never re-enters a convex box), clamped by
    # the original ray's tmax.
    _, _, seg_exit = intersect.intersect_aabb(
        o, d, grid.box_min_f, grid.box_max_f, zero,
        zero + params.ray_max_distance,
    )
    stop_t = torch.minimum(tmax, seg_exit)

    C = march_cell
    if C > 1:
        sel_c, n_cells = _select_cells(
            grid, o, d, t0, stop_t, alive, step_size=step, max_steps=S,
            cell=C,
        )
        # Selected cells first, in ascending cell order.
        idx_c = torch.argsort((~sel_c).to(torch.uint8), dim=-1, stable=True)
        cell_ok = torch.gather(sel_c, -1, idx_c)
        ncell_sel = sel_c.sum(dim=-1)
        CB = max(1, SB // C)
        n_sb = -(-n_cells // CB)
        pad = n_sb * CB - n_cells
        if pad:
            # A whole last block: its padding cells are not selected.
            idx_c = F.pad(idx_c, (0, pad))
            cell_ok = torch.cat(
                [cell_ok, torch.zeros((n, pad), dtype=torch.bool,
                                      device=dev)], dim=-1)
        jj = torch.arange(C, device=dev)
    else:
        n_sb = -(-S // SB)
        ks0 = torch.arange(SB, device=dev)

    found = torch.zeros(n, dtype=torch.bool, device=dev)
    color = torch.zeros(n, device=dev)
    rank_base = torch.zeros(n, dtype=torch.int64, device=dev)
    scat_t = t0.clone()
    draws_sc = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(n_sb):
        if C > 1:
            cells_j = idx_c[:, j * CB:(j + 1) * CB]
            kf = (cells_j[:, :, None] * C + jj).reshape(n, CB * C)
            valid = (torch.repeat_interleave(
                cell_ok[:, j * CB:(j + 1) * CB], C, dim=-1) & (kf < S))
            t = t_grid(t0, kf.to(torch.float32), step)
        else:
            valid = None
            t = t_grid(t0, (j * SB + ks0).to(torch.float32), step)
        pos = ray_positions(o, d, t)
        val = grid.sample_nearest(pos)
        if valid is not None:
            val = torch.where(valid, val, 0.0)
        roll_site = (val > 0.0) & alive[:, None] & (t < tmax[:, None])
        rank = rank_base[:, None] + torch.cumsum(roll_site, dim=-1)
        roll = rng.randf_at(seed0[:, None, :], seed_draws[:, None] + rank)
        scatter = roll_site & (roll < prob) & ~found[:, None]
        newly = scatter.any(dim=-1)
        # Contributions: sites with no scatter strictly before them (the
        # scatter site itself still adds, path_compute_color.comp:106-110).
        sc = scatter.to(torch.int32)
        before = torch.cumsum(sc, dim=-1, dtype=torch.int32) - sc
        contrib = roll_site & (before == 0) & ~found[:, None]
        light_in = _light_term(grid, pos, light_local, params, config, lut,
                               S, light_step=light_step)
        color = color + _row_sum(
            torch.where(contrib, val * step * light_in, 0.0))
        first = sc.argmax(dim=-1, keepdim=True)
        scat_t = torch.where(newly, torch.gather(t, -1, first)[:, 0], scat_t)
        draws_sc = torch.where(newly, torch.gather(rank, -1, first)[:, 0],
                               draws_sc)
        found = found | newly
        rank_base = rank[:, -1]
        if j + 1 == n_sb:
            break
        if C > 1:
            # Past its last selected cell a ray sees only zero density.
            done = ~alive | found | ((j + 1) * CB >= ncell_sel)
        else:
            done = ~alive | found | (t[:, -1] >= stop_t)
        profiling.count("sync", "path.walk")
        if bool(done.all()):
            break

    draws = torch.where(found, draws_sc, rank_base)
    nd1 = rng.randf_at(seed0, seed_draws + draws + 1)
    nd2 = rng.randf_at(seed0, seed_draws + draws + 2)
    new_dir = rng.random_dir(nd1, nd2)
    scat_pos = ray_positions(o, d, scat_t[:, None])[:, 0, :]
    return (
        color,
        torch.where(found[:, None], scat_pos, o),
        torch.where(found[:, None], new_dir, d),
        seed_draws + draws + torch.where(found, 2, 0),
        alive & found,
    )


def _chunk_cost_key(grid, params, S, o, d, tmax, alive, *, march_cell=1,
                    key_mode="cells", subblock=SUBBLOCK):
    """Per-ray bound on the _walk_chunk sub-block count: "cells" (the
    selected occupied cells over the cell block, the loop's own trip
    count; march_cell > 1 only) or "span" (the in-box distance over the
    sub-block span).  Purely a scheduling key: any key keeps results
    bit-identical.  Dead rays key to INT32_MAX."""
    step = params.ray_marching_step_size
    n = o.shape[0]
    SB = min(max(8, subblock), S)
    t0 = torch.full((n,), step, dtype=torch.float32, device=o.device)
    zero = torch.zeros(n, device=o.device)
    _, _, seg_exit = intersect.intersect_aabb(
        o, d, grid.box_min_f, grid.box_max_f, zero,
        zero + params.ray_max_distance,
    )
    stop_t = torch.minimum(tmax, seg_exit)
    C = march_cell
    if C > 1 and key_mode == "cells":
        sel_c, _ = _select_cells(grid, o, d, t0, stop_t, alive,
                                 step_size=step, max_steps=S, cell=C)
        CB = max(1, SB // C)
        blocks = (sel_c.sum(dim=-1) + CB - 1) // CB
    else:
        span = torch.clamp(stop_t - t0, min=0.0)
        blocks = torch.ceil(span / f32mul(step, SB))
    return torch.where(alive, blocks.to(torch.int32), _I32_MAX)


def _sorted_compact(grid, params, config, S, o, d, tmax, alive, *,
                    march_cell, key_mode, subblock):
    """Rows ordered by _chunk_cost_key, ascending (a stable argsort): the
    alive rows first, cheapest first.  The key runs in probe_tile rows."""
    n = o.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=o.device)
    for a in range(0, n, config.probe_tile):
        b = min(a + config.probe_tile, n)
        key[a:b] = _chunk_cost_key(grid, params, S, o[a:b], d[a:b],
                                   tmax[a:b], alive[a:b],
                                   march_cell=march_cell, key_mode=key_mode,
                                   subblock=subblock)
    return torch.argsort(key, stable=True)


def _compact_indices(alive: torch.Tensor, count: int) -> torch.Tensor:
    """Indices of the ``count`` alive rows, in order (a cumsum and a
    scatter; no host read)."""
    n = alive.shape[0]
    pos = torch.cumsum(alive.to(torch.int64), dim=0) - 1
    tgt = torch.where(alive, pos, count)
    idx = torch.zeros(count + 1, dtype=torch.int64, device=alive.device)
    idx.scatter_(0, tgt, torch.arange(n, device=alive.device))
    return idx[:count]


def _scatter_segments(grid, params, config, lut, S, light_local, state,
                      spec: _SeedSpec, *, march_cell=1, light_step=None,
                      subblock=SUBBLOCK):
    """Segments 2..max_path_segments.  Returns the (n,) colors.

    At most ``path_compact_min`` rays walk full width, every ray every
    segment.  Above it each segment compacts its alive rows (cost-sorted
    unless ``path_sort_chunks`` is off), walks them in chunks of
    ``path_chunk`` rays (scaled by the frame count in a batch), adds each
    row's contribution at its image index ``orig`` and keeps the walked
    rows, in order, as the next segment's state (-1 in ``orig`` once a
    ray is resolved).  One host read per segment counts the alive rows;
    with none left the remaining segments do nothing."""
    color, o, d, seed_draws, tmax, alive = state
    n = o.shape[0]
    n_frames = spec.frame_counts.shape[0]
    kw = dict(march_cell=march_cell, light_step=light_step,
              subblock=subblock)
    all_rows = torch.arange(n, device=o.device)

    if n <= config.path_compact_min:
        seed0 = _chunk_seeds(all_rows, spec)
        for _ in range(2, config.max_path_segments + 1):
            with profiling.span("path.compact"):
                profiling.count("sync", "path.compact")
                any_alive = bool(alive.any())
            if not any_alive:
                break
            with profiling.span("path.walk"):
                dc, o, d, seed_draws, alive = _walk_chunk(
                    grid, params, config, lut, S, light_local, o, d, seed0,
                    seed_draws, tmax, alive, **kw)
                color = color + dc
        return color

    W = max(32, config.path_chunk * n_frames)
    key_mode = config.path_sort_key
    if key_mode == "auto":
        key_mode = ("cells" if spec.n_pad_frame <= SORT_CELLS_MAX_RAYS
                    else "span")
    orig = torch.where(alive, all_rows, -1).to(torch.int32)
    for _ in range(2, config.max_path_segments + 1):
        with profiling.span("path.compact"):
            alive = orig >= 0
            profiling.count("sync", "path.compact")
            count = int(alive.sum())
            if count == 0:
                break
            if config.path_sort_chunks:
                idx = _sorted_compact(grid, params, config, S, o, d, tmax,
                                      alive, march_cell=march_cell,
                                      key_mode=key_mode,
                                      subblock=subblock)[:count]
            else:
                idx = _compact_indices(alive, count)
            o, d, seed_draws, tmax, orig = (
                o[idx], d[idx], seed_draws[idx], tmax[idx], orig[idx])
        with profiling.span("path.walk"):
            out = []
            for a in range(0, count, W):
                og = orig[a:a + W]
                dc, o2, d2, sd2, al2 = _walk_chunk(
                    grid, params, config, lut, S, light_local, o[a:a + W],
                    d[a:a + W], _chunk_seeds(og, spec), seed_draws[a:a + W],
                    tmax[a:a + W], torch.ones_like(og, dtype=torch.bool),
                    **kw)
                og64 = og.to(torch.int64)
                color[og64] = color[og64] + dc
                out.append((o2, d2, sd2, torch.where(al2, og, -1)))
            o, d, seed_draws, orig = (torch.cat(c) for c in zip(*out))
    return color


# ---------------------------------------------------------------------------
# public API


def _check_steps(S: int) -> None:
    if S > torch.iinfo(torch.int16).max:
        raise ValueError(f"max_steps={S}: the rank planes hold int16 sample "
                         "indices (at most 32767 steps)")


def bake_path_view(
    grid: DenseGrid,
    params: RenderParams,
    config: StaticConfig,
    max_steps: int,
    row_start: int = 0,
    num_rows: int | None = None,
    shadow_lut_radius: int = 0,
    light_step=None,
    *,
    tile_bytes: int = TILE_BYTES,
) -> PathView:
    """Bake the frame-invariant camera-segment planes (see PathView), in
    tiles sized by ``tile_bytes``; rebuild whenever camera, volume, march
    or light parameters change.  The scattering probability and the frame
    counter are per-frame inputs, not baked.  ``light_step``: the original
    step for the light term under the path_stride tier."""
    S = max_steps
    _check_steps(S)
    o_i, d_i = camera_rays_index(grid, params, config, row_start, num_rows)
    n_rays = o_i.shape[0]
    n_pad, tile = _tiling(n_rays, S, tile_bytes)
    o_i, d_i = _pad_rays(o_i, d_i, n_pad)
    real = torch.arange(n_pad, device=o_i.device) < n_rays
    lut = _make_lut(grid, params, config, shadow_lut_radius)
    parts = [
        _seg1_planes_ranked(grid, params, config, lut, S, o_i[a:a + tile],
                            d_i[a:a + tile], real[a:a + tile],
                            light_step=light_step)
        for a in range(0, n_pad, tile)
    ]
    tmin, tmax, live, rank_k, n_occ, rank_prefix, prefix_total = (
        torch.cat(c) for c in zip(*parts))
    return PathView(o_i, d_i, tmin, tmax, live, rank_k, n_occ, rank_prefix,
                    prefix_total)


def _finish(params, color, n_rays, rows, W):
    # The reference's walk condition `photonIntensity > 0.01`
    # (path_compute_color.comp:86) is constant per frame (PATH never
    # attenuates it): at or below it the frame is black.
    live_frame = float(np.float32(params.photon_initial_intensity)
                       > np.float32(0.01))
    return (live_frame * torch.clamp(color[..., :n_rays], 0.0, 1.0)
            ).reshape(*color.shape[:-1], rows, W)


def render_frame(
    grid: DenseGrid,
    params: RenderParams,
    frame_count: int,
    config: StaticConfig,
    max_steps: int,
    row_start: int = 0,
    num_rows: int | None = None,
    shadow_lut_radius: int = 0,
    cache: PathView | None = None,
    march_cell: int = 1,
    light_step=None,
    *,
    subblock: int = SUBBLOCK,
    tile_bytes: int = TILE_BYTES,
) -> torch.Tensor:
    """One PATH frame: (num_rows, W) radiance in [0, 1].

    ``shadow_lut_radius``: the exact shadow-probe LUT (radius >=
    ceil(step); 0 disables).  ``cache``: a PathView from ``bake_path_view``
    of the same rows; the camera segment then replays it instead of
    marching.  Identical results either way.

    Spans (utils.profiling): "path.replay" (the camera segment, replayed
    or marched), then per scatter segment "path.compact" (the alive count,
    and the sort or compaction) and "path.walk"; the host reads count as
    syncs at "path.compact" (one a segment) and "path.walk" (one a
    sub-block of a chunk)."""
    W = config.width
    rows = config.height if num_rows is None else num_rows
    n_rays = rows * W
    S = max_steps
    _check_steps(S)
    lut = _make_lut(grid, params, config, shadow_lut_radius)
    light_local = _light_local(grid, params)
    dev = grid.device
    profiling.count("sync", "path.upload")
    fcs = torch.tensor([int(frame_count)], dtype=torch.int64, device=dev)

    with profiling.span("path.replay"):
        if cache is None:
            o_i, d_i = camera_rays_index(grid, params, config, row_start,
                                         num_rows)
            n_pad, tile = _tiling(n_rays, S, tile_bytes)
            o_i, d_i = _pad_rays(o_i, d_i, n_pad)
            real = torch.arange(n_pad, device=dev) < n_rays
            spec = _SeedSpec(W, rows, row_start, fcs, n_pad)
            seeds = _chunk_seeds(torch.arange(n_pad, device=dev), spec)
            parts = []
            for a in range(0, n_pad, tile):
                b = a + tile
                tmin, tmax, live, site_rank, n_occ, prefix = _seg1_planes(
                    grid, params, config, lut, S, o_i[a:b], d_i[a:b],
                    real[a:b], light_step=light_step)
                parts.append((*_seg1_frame(params, o_i[a:b], d_i[a:b], tmin,
                                           live, site_rank, n_occ, prefix,
                                           seeds[a:b]), tmax))
            color, o2, d2, sd2, al2, tmax = (torch.cat(c)
                                             for c in zip(*parts))
        else:
            n_pad = cache.o_i.shape[0]
            spec = _SeedSpec(W, rows, row_start, fcs, n_pad)
            color, o2, d2, sd2, al2 = _replay(params, S, cache, spec,
                                              tile_bytes)
            tmax = cache.tmax

    if config.max_path_segments > 1:
        color = _scatter_segments(
            grid, params, config, lut, S, light_local,
            (color, o2, d2, sd2, tmax, al2), spec, march_cell=march_cell,
            light_step=light_step, subblock=subblock)
    return _finish(params, color, n_rays, rows, W)


def _replay(params, S, cache: PathView, spec: _SeedSpec, tile_bytes: int,
            frame: int = 0):
    """_seg1_frame_rank over the view in tiles, for frame ``frame`` of
    ``spec``: (color, origin2, dir2, seed_draws2, alive2)."""
    n_pad = cache.o_i.shape[0]
    tile = _tiling(n_pad, S, tile_bytes)[1]
    rows0 = frame * spec.n_pad_frame
    parts = []
    for a in range(0, n_pad, tile):
        b = min(a + tile, n_pad)
        seed0 = _chunk_seeds(
            torch.arange(rows0 + a, rows0 + b, device=cache.o_i.device), spec)
        parts.append(_seg1_frame_rank(
            params, S, cache.o_i[a:b], cache.d_i[a:b], cache.tmin[a:b],
            cache.n_occ[a:b], cache.rank_k[a:b], cache.rank_prefix[a:b],
            cache.prefix_total[a:b], seed0))
    return tuple(torch.cat(c) for c in zip(*parts))


def render_frames(
    grid: DenseGrid,
    params: RenderParams,
    frame_counts,
    config: StaticConfig,
    max_steps: int,
    cache: PathView,
    row_start: int = 0,
    num_rows: int | None = None,
    shadow_lut_radius: int = 0,
    march_cell: int = 1,
    light_step=None,
    *,
    subblock: int = SUBBLOCK,
    tile_bytes: int = TILE_BYTES,
) -> torch.Tensor:
    """``len(frame_counts)`` cached PATH frames with their scatter segments
    walked together: (F, rows, W).  Frames are independent seed streams,
    so their scatter states concatenate; the chunk width scales by F.
    Per-frame results are identical to ``render_frame``; the spans and
    counts are ``render_frame``'s, with one "path.replay" for the batch."""
    W = config.width
    rows = config.height if num_rows is None else num_rows
    n_rays = rows * W
    S = max_steps
    _check_steps(S)
    lut = _make_lut(grid, params, config, shadow_lut_radius)
    light_local = _light_local(grid, params)
    n_pad = cache.o_i.shape[0]
    profiling.count("sync", "path.upload")
    fcs = torch.as_tensor([int(fc) for fc in frame_counts],
                          dtype=torch.int64, device=grid.device)
    Fn = fcs.shape[0]
    spec = _SeedSpec(W, rows, row_start, fcs, n_pad)
    with profiling.span("path.replay"):
        per_frame = [_replay(params, S, cache, spec, tile_bytes, frame=i)
                     for i in range(Fn)]
        color, o2, d2, sd2, al2 = (torch.cat(c) for c in zip(*per_frame))
    if config.max_path_segments > 1:
        color = _scatter_segments(
            grid, params, config, lut, S, light_local,
            (color, o2, d2, sd2, cache.tmax.repeat(Fn), al2), spec,
            march_cell=march_cell, light_step=light_step, subblock=subblock)
    return _finish(params, color.reshape(Fn, n_pad), n_rays, rows, W)
