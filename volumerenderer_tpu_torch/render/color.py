"""Color pass (the parts of volumerenderer_tpu.render.color on the ported
paths): the cached compact view, the uncached slots view, and the
interactive builds (identity-order drag views, row chunks of the settle,
gather decimation).

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
Views over the device budget, and top-k views, are built band by band
from the host's sort (``build_compact_view_host``); ``build_compact_view``
chooses between the two builds (``device_build_ok``), and both march
their band plans through one loop (``_march_bands``).

  top-k (``gather_samples`` C below the march's samples): each ray keeps
    its C largest weights and their march distances, in the order of a
    stable descending sort (equal weights, such as a short ray's zeros,
    keep ascending sample order, as ``jax.lax.top_k`` gives them).

  uncached (the plain ``render_frame``; ``compact_view=False``): every
    ray's full march straight into row-major (R, C) planes (a ViewCache),
    shaded by the slot kernels into (R, C) weighted per-sample sums, summed
    over samples here.

  the march kernel: on a CUDA device, a march with nearest sampling, no
    brick gate and every sample kept (the uncached frame, the slots view,
    cell-1 builds) is one launch of csrc/march_planes.cu from the clip to
    the planes (the rule: ops.kernels.march_planes.plan); every other
    march runs the plain march tile by tile (ops.kernels.march_planes).

Spans (utils.profiling): "color.march" (``build_view``: the uncached
frame's and the slots view's full march), "color.build" (each device
build and each host-banded build), "color.merge" (the settle's merge).
Counts (kind "march"): "color.march.kernel" and "color.march.ops", one a
``_march_planes`` call by its route.  Counts (kind "view"):
"color.build.host" once a host-banded build and "color.build.band" once a
band it builds; for each frame shaded over a compact view whose ``live``
the build read,
"color.shade.live" (the samples the gather reads) and "color.shade.held"
(the plane samples the view holds), host integers fixed at the build.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.params import Algorithm, RenderParams, StaticConfig
from ..grid.dense import DenseGrid
from ..ops import camera, gather as gather_ops, lights as lights_ops
from ..ops import march as march_ops
from ..ops.kernels import march_planes as march_planes_ops
from ..ops.kernels.gather_lanes import TILE_L, lane_need_of
from ..ops.march import sqrt
from ..ops.rng import norm3
from ..utils import profiling
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
    caps: tuple = ()  # each band's march cap K_b (the host-banded build)
    # The samples the gather reads, the sum of every band's ``lane_need``,
    # where the build read it (the host-banded build); None elsewhere.
    live: int | None = None
    # False where top-k dropped samples of some ray (the host-banded build
    # with ``gather_samples`` below the busiest ray's count).
    exact: bool = True

    @property
    def held(self) -> int:
        """The plane samples the bands hold (lanes x padded cap)."""
        return sum(b.weight.numel() for b in self.bands)


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
    profiling.count("sync", "color.rays")  # the rotation's copy to ``dev``
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


def occupancy_gated(config: StaticConfig, march_cell: int) -> bool:
    """Whether a build reads the brick occupancy: nearest sampling at a
    coarse cell above 1 (ops.kernels.march_planes.brick_gated).  Otherwise
    (trilinear, as in the reference package, or cell 1) no occupancy count
    or cap is taken: every ray is marched at the full step budget, and the
    occupancy order is the identity."""
    return march_planes_ops.brick_gated(config.interpolation, march_cell)


def occupancy_counts_rays(grid, params, config, max_steps: int, o_i, d_i, *,
                          clip_box=None, march_cell: int = 8):
    """Per-ray occupied fine-sample bounds for an explicit ray set, (N,)
    i32, in tiles of ``config.probe_tile`` rays.  Fed the rays that are
    marched later, so that probe and march see the same geometry.
    ``clip_box``: device tensors (``_clip_tensors``)."""
    out = torch.empty(o_i.shape[0], dtype=torch.int32, device=o_i.device)
    for a, b in _tiles(o_i.shape[0], config.probe_tile):
        out[a:b] = march_ops.occupancy_counts(
            grid, o_i[a:b], d_i[a:b],
            ray_max_distance=params.ray_max_distance,
            step_size=params.ray_marching_step_size,
            max_steps=max_steps, clip_box=clip_box, cell=march_cell,
        )
    return out


def _march_planes(grid, params, config, max_steps: int, o_i, d_i, *,
                  clip_box, occupied_cap, march_cell: int, lanes: bool,
                  gather_samples: int = 0):
    """Bake the march for an explicit ray set: (4, C, N) lane-major planes
    (``lanes``) or (4, N, C) row-major planes of (wx, wy, wz, w).  With
    ``gather_samples`` below the march's samples, C = ``gather_samples``
    (ops.kernels.march_planes.top_k_samples).  Each call counts its route,
    "color.march.kernel" or "color.march.ops" (kind "march")."""
    march = dict(ray_max_distance=params.ray_max_distance,
                 step_size=params.ray_marching_step_size,
                 absorption=params.absorption_coefficient,
                 max_steps=max_steps, lanes=lanes, clip_box=clip_box,
                 tile=config.build_tile)
    route = march_planes_ops.plan(config.interpolation, march_cell,
                                  occupied_cap, gather_samples, max_steps)
    if route.kernel and o_i.device.type == "cuda":
        profiling.count("march", "color.march.kernel")
        return march_planes_ops.march_planes(grid, o_i, d_i, **march)
    profiling.count("march", "color.march.ops")
    return march_planes_ops.march_planes_reference(
        grid, o_i, d_i, **march, interpolation=config.interpolation,
        occupied_cap=occupied_cap, cell=march_cell,
        gather_samples=gather_samples)


def build_view_rays(grid, params, config, max_steps: int, o_i, d_i, *,
                    gather_samples: int = 0, clip_box=None,
                    occupied_cap: int | None = None, march_cell: int = 8):
    """Bake the march for an explicit ray set, straight into lane-major
    planes: returns (wx, wy, wz, w), each (C, N) (the reference package
    returns them (N, C)).  The band unit of the host-banded build: each
    band marches at its own ``occupied_cap``; ``gather_samples``: top-k;
    ``clip_box``: device tensors (``_clip_tensors``)."""
    return tuple(_march_planes(
        grid, params, config, max_steps, o_i, d_i, clip_box=clip_box,
        occupied_cap=occupied_cap, march_cell=march_cell, lanes=True,
        gather_samples=gather_samples))


@dataclass
class ViewCache:
    """Baked march of every ray of a view in slots layout: row r holds ray
    r's samples (C = the march's trip count).  Shaded by the slot kernels;
    rows past ``n_rays`` (padding) carry zero weight."""

    wx: torch.Tensor  # (R, C) world-space sample x
    wy: torch.Tensor  # (R, C)
    wz: torch.Tensor  # (R, C)
    weight: torch.Tensor  # (R, C) gather weights T * val * dt
    n_rays: int
    rows: int


def _clip_tensors(clip_box, dev):
    """The occupied box's corners as f32 tensors on ``dev`` (from numpy
    arrays or tensors)."""
    if clip_box is None:
        return None
    copies = sum(1 for c in clip_box if not torch.is_tensor(c)
                 or c.device.type != torch.device(dev).type)
    if copies:
        profiling.count("sync", "color.clip", copies)
    return tuple(torch.as_tensor(c, dtype=torch.float32, device=dev)
                 for c in clip_box)


@profiling.spanned("color.march")
def build_view(grid: DenseGrid, params: RenderParams, config: StaticConfig,
               max_steps: int, row_start: int = 0,
               num_rows: int | None = None, clip_box=None,
               occupied_cap: int | None = None,
               march_cell: int = 8, *, gather_samples: int = 0) -> ViewCache:
    """Run the transmittance march for every ray of the view (rows
    ``row_start`` .. + ``num_rows``) and bake world-space sample planes and
    weights in slots layout.  ``clip_box``: the occupied-region corners
    (bit-identical results); ``occupied_cap`` with ``march_cell`` > 1:
    brick-skipping march at that per-ray cap; ``gather_samples``: C for
    top-k compaction (0 keeps every march sample)."""
    H, W = config.height, config.width
    rows = H if num_rows is None else num_rows
    o_i, d_i = camera_rays_index(grid, params, config, row_start, num_rows)
    wx, wy, wz, w = _march_planes(
        grid, params, config, max_steps, o_i, d_i,
        clip_box=_clip_tensors(clip_box, grid.device),
        occupied_cap=occupied_cap, march_cell=march_cell, lanes=False,
        gather_samples=gather_samples)
    return ViewCache(wx=wx, wy=wy, wz=wz, weight=w, n_rays=rows * W,
                     rows=rows)


def device_build_ok(config: StaticConfig, steps: int, march_cell: int,
                    budget_bytes: int) -> bool:
    """Whether the compact view of the image may be built on the device:
    never for ``compact_build="host"`` or with ``gather_samples``; always
    for "device"; for "auto" when the planes of every ray at the global
    cap (``steps`` rounded up to whole cells) fit ``budget_bytes``."""
    mode = config.compact_build
    if mode == "host" or config.gather_samples:
        return False
    if mode == "device":
        return True
    n_rays = config.height * config.width
    lanes_n = -(-n_rays // TILE_L) * TILE_L
    s_eff = -(-steps // march_cell) * march_cell if march_cell > 1 else steps
    return lanes_n * s_eff * 16 <= budget_bytes


def build_compact_view(grid: DenseGrid, params: RenderParams,
                       config: StaticConfig, steps: int, *, clip_box,
                       march_cell: int, device_budget_bytes: int,
                       band_budget_bytes: int) -> CompactView:
    """The compact view of the whole image: the device build where
    ``device_build_ok``, else the host-banded build with bands of at most
    ``band_budget_bytes``.  ``view.exact`` says whether it is exact."""
    if device_build_ok(config, steps, march_cell, device_budget_bytes):
        return build_compact_view_device(grid, params, config, steps,
                                         clip_box=clip_box,
                                         march_cell=march_cell)
    return build_compact_view_host(grid, params, config, steps,
                                   clip_box=clip_box, march_cell=march_cell,
                                   band_budget_bytes=band_budget_bytes)


@profiling.spanned("color.build")
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
    order: str = "occupancy",
) -> CompactView:
    """Compact-view build on the device.

    ``order="occupancy"``: lanes are all rays padded to TILE_L, sorted by
    descending occupancy count (stable, so ties keep ray order); misses sink
    to the tail.  Each ``band_lanes``-wide band marches at the cap of its
    busiest lane, read on the host once for all bands.  Exact: every cap
    covers every lane's occupied count.  Without the occupancy read
    (``occupancy_gated`` false: trilinear, or cell 1) every count is
    ``steps``, so the order is the identity and no host read is made.

    ``order="identity"``: lanes keep ray order and every band marches at
    ``steps`` (no occupancy pre-march, no sort, no host read): the build of
    a view shaded once, as a drag frame is.

    With ``config.gather_stride > 1`` the view is decimated
    (``decimate_view``)."""
    H, W = config.height, config.width
    rows = H if num_rows is None else num_rows
    n_rays = rows * W
    lanes_n = -(-n_rays // TILE_L) * TILE_L
    dev = grid.device
    clip_box = _clip_tensors(clip_box, dev)
    o_i, d_i = camera_rays_index(grid, params, config, row_start, num_rows)
    pad = lanes_n - n_rays
    starts = range(0, lanes_n, band_lanes)
    caps = [steps] * len(starts)
    use_occ = False
    if order == "identity":
        inv_map = torch.arange(n_rays, dtype=torch.int32, device=dev)
        lane_live = torch.arange(lanes_n, device=dev) < n_rays
        order_p = torch.where(lane_live, torch.arange(lanes_n, device=dev), 0)
        src = order_p.to(torch.int32)
    elif order != "occupancy":
        raise ValueError(f"unknown lane order: {order!r}")
    else:
        use_occ = occupancy_gated(config, march_cell)
        if use_occ:
            counts = occupancy_counts_rays(
                grid, params, config, steps, o_i, d_i,
                clip_box=clip_box, march_cell=march_cell,
            )
        else:
            counts = torch.full((n_rays,), steps, dtype=torch.int32,
                                device=dev)
        ordr = torch.argsort(-counts, stable=True)
        pos = torch.empty(n_rays, dtype=torch.int64, device=dev)
        pos[ordr] = torch.arange(n_rays, device=dev)
        hit = counts > 0
        inv_map = torch.where(hit, pos, lanes_n).to(torch.int32)
        order_p = torch.nn.functional.pad(ordr, (0, pad))
        lane_live = torch.nn.functional.pad(hit[ordr], (0, pad))
        src = torch.where(lane_live, order_p, 0).to(torch.int32)
        if use_occ:
            counts_sorted = torch.where(lane_live, counts[order_p], 0)
            profiling.count("sync", "color.build")
            caps = torch.stack(
                [counts_sorted[s:s + band_lanes].max() for s in starts]
            ).tolist()  # the one host read of the build
    # Fixed-width bands, every lane's samples kept.
    plan = [(s, min(band_lanes, lanes_n - s), cap, 0)
            for s, cap in zip(starts, caps)]
    view = _march_bands(
        grid, params, config, steps, o_i, d_i, order_p, lane_live, plan,
        clip_box=clip_box, march_cell=march_cell, skip_empty=use_occ,
        inv_map=inv_map, src=src, n_rays=n_rays, rows=rows)
    return decimate_view(view, int(config.gather_stride),
                         config.gather_fold)


@profiling.spanned("color.build")
def build_compact_view_host(grid: DenseGrid, params: RenderParams,
                            config: StaticConfig, steps: int, *,
                            clip_box=None, march_cell: int = 8,
                            band_budget_bytes: int) -> CompactView:
    """The host-banded compact build of the whole image:

    1. camera rays, computed once and fed to both passes below; per-ray
       occupancy counts from the dilated brick table at coarse cells
       (none under trilinear or at march cell 1: every ray at the full
       step budget);
    2. on the host (one read), rays sorted by descending count, stable:
       the lane order (``src``) and ``inv_map``, copied to the device in
       one copy;
    3. each band of sorted lanes marched at its own cap (``_host_bands``);
    4. one read of the lanes' live samples (``CompactView.live``).

    Lanes past the hit rays (misses, and ray 0 repeated on views
    narrower than TILE_L) are marched with the last band; ``inv_map``
    points at hit lanes only, so their sums are never read.  With top-k
    below the busiest ray's count the view is inexact (``exact``)."""
    H, W = config.height, config.width
    n_rays = H * W
    dev = grid.device
    o_i, d_i = camera_rays_index(grid, params, config)
    if occupancy_gated(config, march_cell):
        profiling.count("sync", "color.build")
        counts = occupancy_counts_rays(
            grid, params, config, steps, o_i, d_i, clip_box=clip_box,
            march_cell=march_cell).cpu().numpy()
    else:
        counts = np.full(n_rays, steps, np.int32)
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    hit_n = max(1, int((counts > 0).sum()))
    lanes_n = -(-hit_n // TILE_L) * TILE_L
    order_l = order[:lanes_n]
    if lanes_n > n_rays:  # lanes past the last ray hold ray 0
        order_l = np.pad(order_l, (0, lanes_n - n_rays))
    inv = np.full(n_rays, lanes_n, np.int32)
    inv[order_l[:hit_n]] = np.arange(hit_n, dtype=np.int32)
    # Both arrays in one copy to the device before the march, while the
    # stream is idle after the counts' read.
    profiling.count("sync", "color.build.upload")
    both = torch.as_tensor(np.concatenate([order_l, inv]), device=dev)
    src, inv_map = both[:lanes_n], both[lanes_n:]
    profiling.count("view", "color.build.host")
    gs = config.gather_samples
    plan = _host_bands(counts, order, lanes_n, steps, march_cell, gs,
                       band_budget_bytes)
    view = _march_bands(
        grid, params, config, steps, o_i, d_i, src.to(torch.int64), None,
        plan, clip_box=clip_box, march_cell=march_cell, skip_empty=False,
        inv_map=inv_map, src=src, n_rays=n_rays, rows=H,
        caps=tuple(cap for _, _, cap, _ in plan),
        exact=not gs or gs >= int(counts[order[0]]))
    profiling.count("view", "color.build.band", len(plan))
    view = decimate_view(view, int(config.gather_stride),
                         config.gather_fold)
    # The samples the gather will read.  With the one copy above, the
    # build still waits on the card three times: counts, copy, this.
    profiling.count("sync", "color.build.live")
    view.live = int(torch.stack([b.lane_need.sum()
                                 for b in view.bands]).sum())
    return view


def _host_bands(counts, order, lanes_n: int, steps: int, cell: int,
                gather_samples: int, budget_bytes: int) -> list:
    """The host-banded build's plan over ``lanes_n`` lanes, the rays
    ``order`` sorted by descending ``counts`` (host arrays): each band's
    cap K_b is its first lane's count rounded up to 16 steps, at least one
    cell, at most ``steps``; top-k to ``gather_samples`` below K_b; as many
    whole lane tiles as fit ``budget_bytes``.  A band starts below the
    hit count, so its first lane is a hit ray."""
    plan, s, gs = [], 0, gather_samples
    while s < lanes_n:
        kb = min(max(-(-max(int(counts[order[s]]), 1) // 16) * 16, cell),
                 steps)
        plane_c = min(gs, kb) if gs else kb
        max_lanes = max(TILE_L, (budget_bytes // (max(plane_c, 1) * 16))
                        // TILE_L * TILE_L)
        size = min(lanes_n - s, max_lanes)
        plan.append((s, size, kb, gs if gs and gs < kb else 0))
        s += size
    return plan


def _march_bands(grid, params, config, steps, o_i, d_i, order_p, lane_live,
                 plan, *, clip_box, march_cell, skip_empty,
                 **view_fields) -> CompactView:
    """March each band (start, width, cap, top-k) of ``plan``: the rays
    ``order_p[start:start + width]`` at the band's cap, top-k to its
    ``gather_samples`` (0 keeps every sample), lanes off ``lane_live`` at
    zero weight (None keeps every lane's weights), then
    ``band_from_planes``; with ``skip_empty`` a band of cap 0 (all misses)
    is not marched."""
    dev = o_i.device
    bands = []
    for s, size, cap, top_k in plan:
        idx_b = order_p[s:s + size]
        if skip_empty and cap == 0:
            z = torch.zeros((0, size), dtype=torch.float32, device=dev)
            bands.append(PlaneBand(z, z, z, z, torch.zeros(
                size, dtype=torch.int32, device=dev)))
            continue
        wx, wy, wz, w = build_view_rays(
            grid, params, config, steps, o_i[idx_b], d_i[idx_b],
            gather_samples=top_k, clip_box=clip_box, occupied_cap=cap,
            march_cell=march_cell,
        )
        if lane_live is not None:
            w = torch.where(lane_live[s:s + size][None, :], w, 0.0)
        bands.append(band_from_planes(wx, wy, wz, w))
    return CompactView(bands=tuple(bands), **view_fields)


def band_from_planes(wx, wy, wz, w) -> PlaneBand:
    """Lane-major (C, N) ray-band planes (``build_view_rays``) -> a
    PlaneBand: the sample axis zero-padded to a multiple of 8 (the
    reference package's band layout), and ``lane_need`` from the weights
    themselves (last nonzero + 1), which is tighter than the occupancy
    bound (no transmittance-cutoff tail, no dilation slack) and what the
    lane kernels' per-block bounds follow."""
    return PlaneBand(wx=pad8(wx), wy=pad8(wy), wz=pad8(wz), weight=pad8(w),
                     lane_need=lane_need_of(w))


def _runs(a: torch.Tensor, run: int) -> torch.Tensor:
    """(Cp, Rc) -> (ceil(Cp / run), run, Rc), zero-padded."""
    Cp, Rc = a.shape
    pad = (-Cp) % run
    if pad:
        a = F.pad(a, (0, 0, 0, pad))
    return a.reshape((Cp + pad) // run, run, Rc)


def pad8(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad the sample axis to a multiple of 8."""
    n = (-a.shape[0]) % 8
    return F.pad(a, (0, 0, 0, n)) if n else a


def _decimate_band(band: PlaneBand, stride: int) -> PlaneBand:
    """Centroid fold: each run of ``stride`` consecutive samples of a lane
    becomes one evaluation point at the run's weight centroid, carrying the
    run's summed weight (moments 0 and 1 of the run matched).  Zero-weight
    runs keep the run's first sample position."""
    w = _runs(band.weight, stride)
    ws = torch.sum(w, dim=1)
    inv = 1.0 / torch.clamp(ws, min=1e-30)
    live = ws > 0.0

    def centroid(a):
        r = _runs(a, stride)
        return torch.where(live, torch.sum(r * w, dim=1) * inv, r[:, 0, :])

    return PlaneBand(
        wx=pad8(centroid(band.wx)),
        wy=pad8(centroid(band.wy)),
        wz=pad8(centroid(band.wz)),
        weight=pad8(ws),
        lane_need=(band.lane_need + (stride - 1)) // stride,
    )


def _decimate_band_gauss2(band: PlaneBand, stride: int) -> PlaneBand:
    """Two-point Gauss fold: each run of ``2 * stride`` samples becomes two
    points at centroid -+ sigma along the ray, each with half the run's
    summed weight (moments 0, 1 and 2 matched).  A lane's samples are
    collinear, so sigma's direction comes from the covariance of the
    positions with the in-run slot index; positions are rebased to the
    run's first sample before squaring.  Zero-weight runs keep the run's
    first sample position twice, with weight 0."""
    R = 2 * stride
    Rc = band.weight.shape[1]
    w = _runs(band.weight, R)
    ws = torch.sum(w, dim=1)
    inv = 1.0 / torch.clamp(ws, min=1e-30)
    live = ws > 0.0
    idx = torch.arange(R, dtype=torch.float32, device=w.device)[None, :, None]
    i_bar = torch.sum(w * idx, dim=1) * inv

    var_sum = 0.0
    covs, mus, firsts = [], [], []
    for plane in (band.wx, band.wy, band.wz):
        r = _runs(plane, R)
        rel = r - r[:, :1, :]
        mu_rel = torch.sum(w * rel, dim=1) * inv
        var = torch.clamp(
            torch.sum(w * rel * rel, dim=1) * inv - mu_rel * mu_rel, min=0.0)
        cov = torch.sum(w * rel * idx, dim=1) * inv - mu_rel * i_bar
        var_sum = var_sum + var
        covs.append(cov)
        mus.append(r[:, 0, :] + mu_rel)
        firsts.append(r[:, 0, :])

    sigma = sqrt(var_sum)
    cnorm = sqrt(covs[0] * covs[0] + covs[1] * covs[1] + covs[2] * covs[2])
    scale = sigma / torch.clamp(cnorm, min=1e-30)
    C2 = 2 * ws.shape[0]

    def two_points(axis):
        off = covs[axis] * scale
        lo = torch.where(live, mus[axis] - off, firsts[axis])
        hi = torch.where(live, mus[axis] + off, firsts[axis])
        return pad8(torch.stack([lo, hi], dim=1).reshape(C2, Rc))

    wh = ws * 0.5
    return PlaneBand(
        wx=two_points(0),
        wy=two_points(1),
        wz=two_points(2),
        weight=pad8(torch.stack([wh, wh], dim=1).reshape(C2, Rc)),
        lane_need=((band.lane_need + R - 1) // R) * 2,
    )


def decimate_view(view: CompactView, stride: int,
                  fold: str = "centroid") -> CompactView:
    """Apply the ``fold`` ("centroid" or "gauss2") to every band of a
    CompactView; inv_map/src are per-ray and stay."""
    if stride <= 1:
        return view
    fold_fn = _decimate_band_gauss2 if fold == "gauss2" else _decimate_band
    return CompactView(
        bands=tuple(fold_fn(b, stride) for b in view.bands),
        inv_map=view.inv_map, src=view.src, n_rays=view.n_rays,
        rows=view.rows, caps=view.caps, exact=view.exact)


@profiling.spanned("color.merge")
def merge_row_views(views) -> CompactView:
    """Merge CompactViews built over consecutive, disjoint row ranges (in
    image order) into one full-image view: bands concatenate in lane order,
    ``src``/``inv_map`` reindex into the global lane and ray spaces, and
    each chunk's miss sentinel (its own lane count) becomes the merged lane
    count.  Used by the progressive settle."""
    total_lanes = sum(int(v.src.shape[0]) for v in views)
    bands, src_parts, inv_parts = [], [], []
    lane0 = ray0 = 0
    for v in views:
        bands.extend(v.bands)
        lanes_v = int(v.src.shape[0])
        src_parts.append(v.src + ray0)
        inv_parts.append(torch.where(v.inv_map >= lanes_v, total_lanes,
                                     v.inv_map + lane0).to(v.inv_map.dtype))
        lane0 += lanes_v
        ray0 += int(v.n_rays)
    return CompactView(
        bands=tuple(bands), inv_map=torch.cat(inv_parts),
        src=torch.cat(src_parts), n_rays=ray0,
        rows=sum(int(v.rows) for v in views))


def _expanded_lights(lights: LightArray, params, algorithm: Algorithm,
                     config: StaticConfig, frame: int):
    """This frame's flat (pos, intensity, valid) light arrays and the count
    of valid lights left out: the photon lights for Point/Sphere (none left
    out); for Ray/Beam the sub-light expansion, compacted into
    ``expanded_light_capacity`` slots (the overflow is dropped)."""
    inten, valid = lights.intensity[frame], lights.valid[frame]
    if algorithm is Algorithm.POINT:
        return lights.pos_to[frame], inten, valid, 0
    if algorithm is Algorithm.SPHERE:
        return lights.pos_from[frame], inten, valid, 0
    pos, inten, valid = lights_ops.expand_segments(
        lights.pos_from[frame], lights.pos_to[frame], inten, valid,
        params.light_ray_step_size, config.max_points_per_segment,
    )
    return lights_ops.compact_valid(pos, inten, valid,
                                    config.expanded_light_capacity)


def _shader(params, lights, algorithm, config, frame: int):
    """This frame's gather: shade(wx, wy, wz, w, layout, lane_need) ->
    (Rc,) per-lane sums ("lanes") or (R, C) weighted sums ("slots")."""
    segments = algorithm in (Algorithm.RAY, Algorithm.BEAM)
    mode = config.segment_mode if segments else None
    radius = params.beam_radius if algorithm is Algorithm.BEAM else None
    seg = (lights.pos_from[frame], lights.pos_to[frame],
           lights.intensity[frame], lights.valid[frame])
    seg_paired = config.segment_eval == "paired"
    if mode == "analytic":
        # The segment integral itself: closed form for Ray, quadrature for
        # Beam's sphere lights.
        def shade(wx, wy, wz, w, layout, lane_need):
            return gather_ops.gather_segments(
                wx, wy, wz, w, *seg, sphere_radius=radius,
                quad_nodes=config.beam_quadrature_nodes,
                quad_rule=config.beam_quadrature_rule, layout=layout,
                lane_need=lane_need, paired=seg_paired,
            )
    elif mode == "discrete":
        # The reference's sub-lights, walked in the kernel from the segment
        # table (ray_compute_color.comp:11-24 / beam_compute_color.comp:11-24).
        def shade(wx, wy, wz, w, layout, lane_need):
            return gather_ops.gather_segments_discrete(
                wx, wy, wz, w, *seg, params.light_ray_step_size,
                sphere_radius=radius, layout=layout, lane_need=lane_need,
                paired=seg_paired,
            )
    else:
        l_pos, l_int, l_valid, _dropped = _expanded_lights(
            lights, params, algorithm, config, frame)
        sphere = algorithm in (Algorithm.SPHERE, Algorithm.BEAM)

        def shade(wx, wy, wz, w, layout, lane_need):
            return gather_ops.gather_planes(
                wx, wy, wz, w, l_pos, l_int, l_valid,
                sphere=sphere, radius=params.beam_radius, layout=layout,
                lane_need=lane_need, paired=config.gather_eval == "paired",
            )
    return shade


def _ray_radiance(view, params, lights, algorithm, config, frame: int):
    """(R, C) weighted per-sample sums of a ViewCache (one slot-kernel
    call), or (Rc_total,) weighted per-lane sums of a CompactView (one
    lane-kernel call per band)."""
    shade = _shader(params, lights, algorithm, config, frame)
    if isinstance(view, ViewCache):
        return shade(view.wx, view.wy, view.wz, view.weight, "slots", None)
    if view.live is not None:
        profiling.count("view", "color.shade.live", view.live)
        profiling.count("view", "color.shade.held", view.held)
    parts = [shade(b.wx, b.wy, b.wz, b.weight, "lanes", b.lane_need)
             for b in view.bands]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def shade_view_compact(grid, view: CompactView, params, lights: LightArray,
                       algorithm: Algorithm, config: StaticConfig,
                       frame: int = 0) -> torch.Tensor:
    """Per-frame compact shading: (Rc,) clipped normalized radiance of the
    lanes (frameColor = clamp(finalColor / lightCount); lightCount 0 -> 0)."""
    colors = _ray_radiance(view, params, lights, algorithm, config, frame)
    denom = torch.clamp(lights.count[frame], min=1).to(torch.float32)
    return torch.clamp(colors / denom, 0.0, 1.0)


def shade_view(grid, view, params, lights: LightArray,
               algorithm: Algorithm, config: StaticConfig,
               frame: int = 0, normalize: bool = True) -> torch.Tensor:
    """Shade a CompactView or a ViewCache with one frame's lights:
    (rows, W) radiance.  ``normalize=False`` returns the raw radiance sums,
    before the division by lightCount and the clamp (light-axis sharding
    sums the partials of every rank first)."""
    out = _ray_radiance(view, params, lights, algorithm, config, frame)
    if isinstance(view, ViewCache):
        colors = torch.sum(out, dim=-1)[: view.n_rays]
    else:
        colors = expand_compact_colors(out, view)
    if not normalize:
        return colors.reshape(view.rows, config.width)
    denom = torch.clamp(lights.count[frame], min=1).to(torch.float32)
    return torch.clamp(colors / denom, 0.0, 1.0).reshape(view.rows,
                                                          config.width)


def render_frame(grid: DenseGrid, params: RenderParams, lights: LightArray,
                 algorithm: Algorithm, config: StaticConfig, max_steps: int,
                 row_start: int = 0, num_rows: int | None = None,
                 frame: int = 0, *, gather_samples: int = 0,
                 normalize: bool = True) -> torch.Tensor:
    """One uncached frame: the full march of every ray (``build_view``,
    top-k to ``gather_samples`` when given) shaded with frame ``frame`` of
    ``lights``; (rows, W) radiance (raw sums with ``normalize=False``)."""
    view = build_view(grid, params, config, max_steps, row_start, num_rows,
                      gather_samples=gather_samples)
    return shade_view(grid, view, params, lights, algorithm, config, frame,
                      normalize=normalize)
