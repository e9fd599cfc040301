"""Color pass over a compact view (the parts of
volumerenderer_tpu.render.color on the cached main path).

  build (once per camera/volume/march-parameter change):
    camera rays -> occupancy counts (dilated brick table, no volume
    fetches) -> lanes sorted by descending count -> per band of lanes, the
    brick-skipping march at the band's own cap -> lane-major (C, Rc)
    world-space sample planes + gather weights + per-lane ``lane_need``.

  shade (every frame):
    a lane gather kernel sums w * (sum over lights) per lane: the point or
    sphere gather for Point/Sphere, and for Ray/Beam the segment gathers
    (``segment_mode`` "discrete" or "analytic") or the point/sphere gather
    over the compacted sub-light expansion ("discrete_expanded").  The
    per-ray colors are normalized by lightCount and clamped, and expand to
    the image through ``inv_map``.

The reference package marches each band at a power-of-two rung of cells
so XLA's shapes stay static; here each band's maximum count is read on
the host (one read per build) and the band marches at exactly that cap.
The planes may be narrower than the reference build's; ``inv_map``,
``src``, ``lane_need`` and every plane value within ``lane_need`` agree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..engine.params import Algorithm, RenderParams, StaticConfig
from ..grid.dense import DenseGrid
from ..ops import camera, gather as gather_ops, lights as lights_ops
from ..ops import march as march_ops
from ..ops.kernels.gather_lanes import TILE_L, lane_need_of
from ..ops.rng import norm3
from .photon import LightArray


def required_march_steps(grid: DenseGrid, step_size: float, cap: int) -> int:
    """Static trip-count bound: nothing happens past the bbox diagonal."""
    diag = math.sqrt(sum(float(s) ** 2 for s in grid.voxels.shape))
    return max(1, min(cap, int(math.ceil(diag / float(step_size))) + 2))


@dataclass
class PlaneBand:
    """One band of compacted lane planes (see CompactView)."""

    wx: torch.Tensor  # (C, Rc) world-space sample x, lane = ray
    wy: torch.Tensor  # (C, Rc)
    wz: torch.Tensor  # (C, Rc)
    weight: torch.Tensor  # (C, Rc) gather weights
    lane_need: torch.Tensor  # (Rc,) i32: samples each lane uses


@dataclass
class CompactView:
    """Ray-compacted baked march in lane-per-ray layout.  Lanes hold the
    rays sorted by descending occupancy count (misses last); ``bands``
    split the lanes so that no band materializes more than its own cap.
    Lane indices in ``inv_map``/``src`` are global across the bands."""

    bands: tuple  # tuple[PlaneBand, ...]
    inv_map: torch.Tensor  # (n_rays,) i32: lane of each ray; total = miss
    src: torch.Tensor  # (Rc_total,) i32: image ray of each lane (pad -> 0)
    n_rays: int
    rows: int
    host_syncs: int = 0  # host reads the build made


def expand_compact_colors(compact_colors: torch.Tensor, view: CompactView):
    """(Rc,) compact per-ray values -> (n_rays,) image values (misses 0)."""
    ext = torch.cat([compact_colors, compact_colors.new_zeros(1)])
    idx = torch.clamp(view.inv_map.to(torch.int64), 0, ext.shape[0] - 1)
    return ext[idx][: view.n_rays]


def camera_rays_index(grid: DenseGrid, params: RenderParams,
                      config: StaticConfig, row_start: int = 0,
                      num_rows: int | None = None):
    """Index-space camera ray origins/unit dirs for the view: (N, 3) each."""
    H, W = config.height, config.width
    rows = H if num_rows is None else num_rows
    dev = grid.device
    o_w, d_w = camera.camera_rays(
        W, H, params.fov, params.camera_pos,
        look_rotation=torch.as_tensor(params.camera_rotation, device=dev),
        row_start=row_start, num_rows=rows, device=dev,
    )
    o_i = grid.world_to_index(o_w.reshape(-1, 3))
    d_i = grid.world_to_index_dir(d_w.reshape(-1, 3))
    return o_i, d_i / norm3(d_i)


def _tiles(n: int, tile: int):
    for a in range(0, n, tile):
        yield a, min(a + tile, n)


def occupancy_counts_rays(grid, params, config, max_steps: int, o_i, d_i, *,
                          clip_box=None, march_cell: int = 8):
    """Per-ray occupied fine-sample bounds for an explicit ray set, (N,)
    i32, in tiles of ``config.probe_tile`` rays."""
    out = torch.empty(o_i.shape[0], dtype=torch.int32, device=o_i.device)
    for a, b in _tiles(o_i.shape[0], config.probe_tile):
        out[a:b] = march_ops.occupancy_counts(
            grid, o_i[a:b], d_i[a:b],
            ray_max_distance=params.ray_max_distance,
            step_size=params.ray_marching_step_size,
            max_steps=max_steps, clip_box=clip_box, cell=march_cell,
        )
    return out


def build_view_rays(grid, params, config, max_steps: int, o_i, d_i, *,
                    clip_box=None, occupied_cap: int | None = None,
                    march_cell: int = 8):
    """Bake the march for an explicit ray set, straight into lane-major
    planes: returns (wx, wy, wz, w), each (C, N)."""
    n_rays = o_i.shape[0]
    cap = occupied_cap if march_cell > 1 else None
    if cap is not None:
        n_cells = -(-max_steps // march_cell)
        kc = min(max(1, -(-min(cap, max_steps) // march_cell)), n_cells)
        C = kc * march_cell
    else:
        C = max_steps
    # Memory guard: march temporaries are ~40 B per (ray, sample).
    tile_mem_bound = max(1024, ((3 << 29) // max(C * 40, 1)) // 1024 * 1024)
    tile = max(1, min(config.build_tile, tile_mem_bound, n_rays))
    dev = o_i.device
    planes = torch.empty((4, C, n_rays), dtype=torch.float32, device=dev)
    mm = grid.map_mat
    mv = grid.map_vec
    for a, b in _tiles(n_rays, tile):
        o, d = o_i[a:b], d_i[a:b]
        m = march_ops.march(
            grid, o, d,
            ray_max_distance=params.ray_max_distance,
            step_size=params.ray_marching_step_size,
            absorption=params.absorption_coefficient,
            max_steps=max_steps, clip_box=clip_box, occupied_cap=cap,
            cell=march_cell,
        )
        t = m.t
        ix = o[:, 0:1] + d[:, 0:1] * t
        iy = o[:, 1:2] + d[:, 1:2] * t
        iz = o[:, 2:3] + d[:, 2:3] * t
        planes[0, :, a:b] = (mm[0, 0] * ix + mm[0, 1] * iy + mm[0, 2] * iz
                             + mv[0]).T
        planes[1, :, a:b] = (mm[1, 0] * ix + mm[1, 1] * iy + mm[1, 2] * iz
                             + mv[1]).T
        planes[2, :, a:b] = (mm[2, 0] * ix + mm[2, 1] * iy + mm[2, 2] * iz
                             + mv[2]).T
        planes[3, :, a:b] = m.weight.T
    return tuple(planes)


def build_compact_view_device(
    grid: DenseGrid,
    params: RenderParams,
    config: StaticConfig,
    steps: int,
    *,
    clip_box=None,
    row_start: int = 0,
    num_rows: int | None = None,
    march_cell: int = 8,
    band_lanes: int = 512 * 1024,
) -> CompactView:
    """Compact-view build on the device (occupancy lane order).

    Lanes are all rays padded to TILE_L, sorted by descending occupancy
    count (stable, so ties keep ray order); misses sink to the tail.  Each
    ``band_lanes``-wide band marches at the cap of its busiest lane, read on
    the host once for all bands.  Exact: every cap covers every lane's
    occupied count."""
    H, W = config.height, config.width
    rows = H if num_rows is None else num_rows
    n_rays = rows * W
    lanes_n = -(-n_rays // TILE_L) * TILE_L
    dev = grid.device
    if clip_box is not None:
        clip_box = tuple(
            torch.as_tensor(np.asarray(c, np.float32), device=dev)
            for c in clip_box
        )
    o_i, d_i = camera_rays_index(grid, params, config, row_start, num_rows)

    use_occ = march_cell > 1
    if use_occ:
        counts = occupancy_counts_rays(
            grid, params, config, steps, o_i, d_i,
            clip_box=clip_box, march_cell=march_cell,
        )
    else:
        counts = torch.full((n_rays,), steps, dtype=torch.int32, device=dev)

    ordr = torch.argsort(-counts, stable=True)
    pos = torch.empty(n_rays, dtype=torch.int64, device=dev)
    pos[ordr] = torch.arange(n_rays, device=dev)
    hit = counts > 0
    inv_map = torch.where(hit, pos, lanes_n).to(torch.int32)
    pad = lanes_n - n_rays
    order_p = torch.nn.functional.pad(ordr, (0, pad))
    lane_live = torch.nn.functional.pad(hit[ordr], (0, pad))
    src = torch.where(lane_live, order_p, 0).to(torch.int32)
    counts_sorted = torch.where(lane_live, counts[order_p], 0)

    starts = list(range(0, lanes_n, band_lanes))
    band_max = torch.stack(
        [counts_sorted[s:s + band_lanes].max() for s in starts]
    ).tolist()  # the one host read of the build

    bands = []
    for s, bmax in zip(starts, band_max):
        size = min(band_lanes, lanes_n - s)
        idx_b = order_p[s:s + size]
        live_b = lane_live[s:s + size]
        if use_occ and bmax == 0:
            # All-miss band: nothing to march.
            z = torch.zeros((0, size), dtype=torch.float32, device=dev)
            bands.append(PlaneBand(z, z, z, z, torch.zeros(
                size, dtype=torch.int32, device=dev)))
            continue
        wx, wy, wz, w = build_view_rays(
            grid, params, config, steps, o_i[idx_b], d_i[idx_b],
            clip_box=clip_box, occupied_cap=bmax if use_occ else steps,
            march_cell=march_cell,
        )
        w = torch.where(live_b[None, :], w, 0.0)
        bands.append(PlaneBand(wx=wx, wy=wy, wz=wz, weight=w,
                               lane_need=lane_need_of(w)))
    return CompactView(bands=tuple(bands), inv_map=inv_map, src=src,
                       n_rays=n_rays, rows=rows, host_syncs=1)


def _expanded_lights(lights: LightArray, params, algorithm: Algorithm,
                     config: StaticConfig, frame: int):
    """This frame's flat (pos, intensity, valid) light arrays: the photon
    lights for Point/Sphere; for Ray/Beam the sub-light expansion, compacted
    into ``expanded_light_capacity`` slots."""
    inten, valid = lights.intensity[frame], lights.valid[frame]
    if algorithm is Algorithm.POINT:
        return lights.pos_to[frame], inten, valid
    if algorithm is Algorithm.SPHERE:
        return lights.pos_from[frame], inten, valid
    pos, inten, valid = lights_ops.expand_segments(
        lights.pos_from[frame], lights.pos_to[frame], inten, valid,
        params.light_ray_step_size, config.max_points_per_segment,
    )
    pos, inten, valid, _dropped = lights_ops.compact_valid(
        pos, inten, valid, config.expanded_light_capacity)
    return pos, inten, valid


def _ray_radiance(view: CompactView, params, lights, algorithm, config,
                  frame: int):
    """(Rc_total,) weighted per-lane radiance sums, one kernel call per band."""
    segments = algorithm in (Algorithm.RAY, Algorithm.BEAM)
    mode = config.segment_mode if segments else None
    radius = params.beam_radius if algorithm is Algorithm.BEAM else None
    seg = (lights.pos_from[frame], lights.pos_to[frame],
           lights.intensity[frame], lights.valid[frame])
    seg_paired = config.segment_eval == "paired"
    if mode == "analytic":
        # The segment integral itself: closed form for Ray, quadrature for
        # Beam's sphere lights.
        def shade(b):
            return gather_ops.gather_segments(
                b.wx, b.wy, b.wz, b.weight, *seg, sphere_radius=radius,
                quad_nodes=config.beam_quadrature_nodes,
                quad_rule=config.beam_quadrature_rule, lane_need=b.lane_need,
                paired=seg_paired,
            )
    elif mode == "discrete":
        # The reference's sub-lights, walked in the kernel from the segment
        # table (ray_compute_color.comp:11-24 / beam_compute_color.comp:11-24).
        def shade(b):
            return gather_ops.gather_segments_discrete(
                b.wx, b.wy, b.wz, b.weight, *seg, params.light_ray_step_size,
                sphere_radius=radius, lane_need=b.lane_need,
                paired=seg_paired,
            )
    else:
        l_pos, l_int, l_valid = _expanded_lights(lights, params, algorithm,
                                                 config, frame)
        sphere = algorithm in (Algorithm.SPHERE, Algorithm.BEAM)

        def shade(b):
            return gather_ops.gather_planes(
                b.wx, b.wy, b.wz, b.weight, l_pos, l_int, l_valid,
                sphere=sphere, radius=params.beam_radius, layout="lanes",
                lane_need=b.lane_need, paired=config.gather_eval == "paired",
            )
    parts = [shade(b) for b in view.bands]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def shade_view_compact(grid, view: CompactView, params, lights: LightArray,
                       algorithm: Algorithm, config: StaticConfig,
                       frame: int = 0) -> torch.Tensor:
    """Per-frame compact shading: (Rc,) clipped normalized radiance of the
    lanes (frameColor = clamp(finalColor / lightCount); lightCount 0 -> 0)."""
    colors = _ray_radiance(view, params, lights, algorithm, config, frame)
    denom = torch.clamp(lights.count[frame], min=1).to(torch.float32)
    return torch.clamp(colors / denom, 0.0, 1.0)


def shade_view(grid, view: CompactView, params, lights: LightArray,
               algorithm: Algorithm, config: StaticConfig,
               frame: int = 0) -> torch.Tensor:
    """Shade a compact view with one frame's lights: (rows, W) radiance."""
    colors = _ray_radiance(view, params, lights, algorithm, config, frame)
    colors = expand_compact_colors(colors, view)
    denom = torch.clamp(lights.count[frame], min=1).to(torch.float32)
    return torch.clamp(colors / denom, 0.0, 1.0).reshape(view.rows,
                                                          config.width)
