"""Multi-device rendering with torch.distributed (twin of
volumerenderer_tpu.parallel.sharding).

One process per rank; the ranks form a 2-D ``DeviceMesh`` with the
dimensions ("rows", "lights"), rank = rows index x lights + lights index:

  * **Pixel-row data parallelism** ("rows"): each rank renders and
    accumulates its horizontal band of the shared pinhole projection, rows
    ``row0 = rows index x H / rows`` onward.  No collective in steady
    state: every rank walks the same photons (the walk is deterministic),
    so no light array is broadcast.
  * **Light-axis sharding** ("lights"): each rank of a row band gathers
    the radiance of its shard of the light slots; one ``all_reduce`` over
    the "lights" group sums the partials before the division by the full
    lightCount and the clamp.

The reference package drives every device from one process through
``shard_map``; here each rank owns its band: ``MeshRenderer.state.accum``
is the rank's (H / rows, W) band, and ``image()`` gathers the frame.  The
grid and the parameters are replicated by construction (each rank builds
or loads them).  NCCL runs the collectives on cards, gloo on the CPU; gloo
also takes CUDA tensors, for ranks that share a card.

Light shards and the sub-light expansion: under
``segment_mode="discrete_expanded"`` each rank packs only its shard's
sub-lights into ``expanded_light_capacity`` slots, so a frame whose whole
expansion overflows the capacity on one device may fit on each rank's
shard (the reference package shares this property).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..engine.params import Algorithm, RenderParams, StaticConfig
from ..engine.session import Renderer
from ..engine.state import RenderState, accumulate
from ..engine.step import _u8, expand_compact_batch
from ..grid.dense import DenseGrid, check_device
from ..ops.march import f32
from ..render import color as color_mod
from ..render import path as path_mod
from ..render import photon

MESH_DIMS = ("rows", "lights")


def make_mesh(lights_axis: int = 1, *, device="cuda"):
    """The ("rows", "lights") DeviceMesh of shape (world / lights_axis,
    lights_axis) over the initialised default process group.  With
    ``device="cuda"`` the rank first selects its card: LOCAL_RANK (else the
    rank) modulo the cards of the host, so ranks beyond the card count
    share cards, which gloo allows and NCCL does not."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = check_device(device, "make_mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise torch.distributed first "
                           "(init_process_group, or parallel.launch)")
    n = dist.get_world_size()
    if lights_axis < 1 or n % lights_axis:
        raise ValueError(
            f"{n} ranks not divisible by lights_axis={lights_axis}")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = dist.get_backend()
    return init_device_mesh(
        dev.type, (n // lights_axis, lights_axis), mesh_dim_names=MESH_DIMS,
        backend_override={d: backend for d in MESH_DIMS})


def mesh_device(mesh) -> torch.device:
    """The rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def row_band(mesh, config: StaticConfig):
    """(row0, rows) of this rank's band of the image."""
    n = mesh.shape[0]
    if config.height % n:
        raise ValueError(
            f"height {config.height} not divisible by mesh rows {n}")
    rows = config.height // n
    return mesh.get_local_rank("rows") * rows, rows


def replicate(mesh, grid: DenseGrid) -> DenseGrid:
    """The grid on this rank's device (every rank holds all of it)."""
    dev = mesh_device(mesh)
    return grid if grid.device == dev else grid.to(dev)


def shard_rows(mesh, array: torch.Tensor) -> torch.Tensor:
    """This rank's band of an (H, ...) array, on its device."""
    h = array.shape[0]
    n = mesh.shape[0]
    if h % n:
        raise ValueError(f"height {h} not divisible by mesh rows {n}")
    rows = h // n
    row0 = mesh.get_local_rank("rows") * rows
    return array[row0:row0 + rows].to(mesh_device(mesh))


def gather_rows(mesh, band: torch.Tensor) -> torch.Tensor:
    """The (H, ...) array of every rank's band, in row order.  A
    collective over the "rows" group: every rank calls it and every rank
    receives the whole array."""
    n = mesh.shape[0]
    if n == 1:
        return band
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(n)]
    dist.all_gather(parts, band, group=mesh.get_group("rows"))
    return torch.cat(parts)


def _light_shard(lights: photon.LightArray, mesh, config: StaticConfig):
    """The lights with ``valid`` cut to this rank's shard of the slots:
    ``light_capacity / lights`` consecutive slots each (``count`` stays the
    whole frame's)."""
    n = mesh.shape[1]
    if n == 1:
        return lights
    L = config.light_capacity
    if L % n:
        raise ValueError(
            f"light_capacity {L} not divisible by mesh lights {n}")
    li = mesh.get_local_rank("lights")
    slot = torch.arange(lights.valid.shape[-1], device=lights.valid.device)
    mine = (slot >= li * (L // n)) & (slot < (li + 1) * (L // n))
    return dataclasses.replace(lights, valid=lights.valid & mine)


def _light_total(raw: torch.Tensor, lights, frame: int, mesh) -> torch.Tensor:
    """Sum the ranks' raw radiance over "lights" (nothing to sum for a
    group of one), normalise by the whole frame's lightCount and clamp:
    with one light rank, the arithmetic of the single-device shading."""
    if mesh.shape[1] > 1:
        dist.all_reduce(raw, group=mesh.get_group("lights"))
    denom = torch.clamp(lights.count[frame], min=1).to(torch.float32)
    return torch.clamp(raw / denom, 0.0, 1.0)


def _accumulate(accum, frame, fc: int, config: StaticConfig):
    if fc == 1:
        accum = torch.zeros_like(accum)
    return accumulate(accum, frame, fc, _u8(config))


def sharded_render_step(grid: DenseGrid, params: RenderParams,
                        state: RenderState, *, algorithm: Algorithm,
                        config: StaticConfig, max_steps: int, mesh,
                        gather_samples: int = 0, shadow_lut_radius: int = 0,
                        march_cell: int = 1) -> RenderState:
    """One uncached frame of this rank's band (``state.accum`` is the band):
    the photon walk and the band's march and shade, or PATH's frame of the
    band.  The "lights" ranks of a band compute the same frame."""
    row0, rows = row_band(mesh, config)
    fc = state.frame_count + 1
    if algorithm is Algorithm.PATH:
        frame = path_mod.render_frame(
            grid, params, fc, config, max_steps, row_start=row0,
            num_rows=rows, shadow_lut_radius=shadow_lut_radius,
            march_cell=march_cell)
    else:
        lights = photon.generate_lights(grid, params, [fc], config,
                                        max_steps=max_steps)
        frame = color_mod.render_frame(
            grid, params, lights, algorithm, config, max_steps, row0, rows,
            gather_samples=gather_samples)
    return RenderState(_accumulate(state.accum, frame, fc, config), fc)


def light_sharded_radiance(grid: DenseGrid, params: RenderParams,
                           state: RenderState, *, algorithm: Algorithm,
                           config: StaticConfig, max_steps: int, mesh,
                           gather_samples: int = 0) -> torch.Tensor:
    """The next frame's radiance of this rank's band, (H / rows, W), with
    the light slots sharded over "lights": each rank gathers its shard's
    raw sums, one all_reduce adds them, then the division by the whole
    lightCount and the clamp.  Not accumulated."""
    row0, rows = row_band(mesh, config)
    lights = photon.generate_lights(grid, params, [state.frame_count + 1],
                                    config, max_steps=max_steps)
    raw = color_mod.render_frame(
        grid, params, _light_shard(lights, mesh, config), algorithm, config,
        max_steps, row0, rows, gather_samples=gather_samples,
        normalize=False)
    return _light_total(raw, lights, 0, mesh)


# ---------------------------------------------------------------------------
# Cached rendering: each rank's baked view of its band, shaded every frame.


def build_view_sharded(grid: DenseGrid, params: RenderParams, *,
                       config: StaticConfig, max_steps: int, mesh,
                       gather_samples: int = 0) -> color_mod.ViewCache:
    """This rank's band of the march in slots layout (render.color.
    build_view)."""
    row0, rows = row_band(mesh, config)
    return color_mod.build_view(grid, params, config, max_steps, row0, rows,
                                gather_samples=gather_samples)


def _frames_lights(grid, params, state, config, max_steps, n_frames):
    """The frame counters of the next ``n_frames`` frames and their photon
    lights, walked together."""
    fcs = [state.frame_count + 1 + i for i in range(n_frames)]
    return fcs, photon.generate_lights(grid, params, fcs, config,
                                       max_steps=max_steps)


def sharded_shade_step(grid: DenseGrid, params: RenderParams,
                       state: RenderState, view: color_mod.ViewCache, *,
                       algorithm: Algorithm, config: StaticConfig,
                       max_steps: int, mesh, n_frames: int = 1
                       ) -> RenderState:
    """``n_frames`` cached frames of this rank's band over its ViewCache, in
    image space; with a "lights" axis each frame gathers the rank's light
    shard and all-reduces the partials."""
    fcs, lights = _frames_lights(grid, params, state, config, max_steps,
                                 n_frames)
    mine = _light_shard(lights, mesh, config)
    accum = state.accum
    for i, fc in enumerate(fcs):
        raw = color_mod.shade_view(grid, view, params, mine, algorithm,
                                   config, frame=i, normalize=False)
        frame = _light_total(raw, lights, i, mesh)
        accum = _accumulate(accum, frame, fc, config)
    return RenderState(accum, fcs[-1])


def build_compact_view_sharded(grid: DenseGrid, params: RenderParams,
                               clip_box, *, config: StaticConfig, steps: int,
                               mesh, march_cell: int = 8
                               ) -> color_mod.CompactView:
    """This rank's band as a compact view (render.color.
    build_compact_view_device: the occupied-box clip, the brick-skipping
    march at ``steps``, lane compaction).  ``clip_box``: the occupied
    region's corners (the whole bbox when unknown: identical results)."""
    row0, rows = row_band(mesh, config)
    return color_mod.build_compact_view_device(
        grid, params, config, steps, clip_box=clip_box, row_start=row0,
        num_rows=rows, march_cell=march_cell)


def sharded_shade_compact_step(grid: DenseGrid, params: RenderParams,
                               state: RenderState,
                               view: color_mod.CompactView, *,
                               algorithm: Algorithm, config: StaticConfig,
                               max_steps: int, mesh, n_frames: int = 1
                               ) -> RenderState:
    """``n_frames`` cached frames of this rank's band over its CompactView,
    accumulated in compact space with one expansion to the band at the end
    (engine.step.render_steps_cached's batch); with a "lights" axis each
    frame all-reduces the lanes' partial sums.  Refuses uint8
    accumulation, which quantizes each frame in image space."""
    if _u8(config):
        raise ValueError("compact sharded shading needs float32 accumulation")
    fcs, lights = _frames_lights(grid, params, state, config, max_steps,
                                 n_frames)
    mine = _light_shard(lights, mesh, config)
    accum_c = state.accum.reshape(-1)[view.src.to(torch.int64)]
    for i, fc in enumerate(fcs):
        raw = color_mod._ray_radiance(view, params, mine, algorithm, config, i)
        frame_c = _light_total(raw, lights, i, mesh)
        accum_c = _accumulate(accum_c, frame_c, fc, config)
    return expand_compact_batch(state, accum_c, view, fcs[-1])


def bake_path_view_sharded(grid: DenseGrid, params: RenderParams, *,
                           config: StaticConfig, max_steps: int, mesh,
                           shadow_lut_radius: int = 0) -> path_mod.PathView:
    """This rank's band of PATH's baked camera segment (render.path.
    bake_path_view)."""
    row0, rows = row_band(mesh, config)
    return path_mod.bake_path_view(grid, params, config, max_steps, row0,
                                   rows, shadow_lut_radius=shadow_lut_radius)


def sharded_path_step_cached(grid: DenseGrid, params: RenderParams,
                             state: RenderState, cache: path_mod.PathView, *,
                             config: StaticConfig, max_steps: int, mesh,
                             shadow_lut_radius: int = 0, march_cell: int = 1
                             ) -> RenderState:
    """One PATH frame of this rank's band over its PathView; identical to
    the uncached frame."""
    row0, rows = row_band(mesh, config)
    fc = state.frame_count + 1
    frame = path_mod.render_frame(
        grid, params, fc, config, max_steps, row_start=row0, num_rows=rows,
        shadow_lut_radius=shadow_lut_radius, cache=cache,
        march_cell=march_cell)
    return RenderState(_accumulate(state.accum, frame, fc, config), fc)


class MeshRenderer:
    """The interactive session over a mesh, one object per rank: each rank
    bakes the view of its band once per camera/march parameters and shades
    cached frames in batches of ``frame_batch``; PATH bakes its band's
    PathView when it fits ``Renderer.path_cache_budget_bytes``, else renders
    uncached.  Parameter edits re-bake: the views take the single-device
    Renderer's keys, occupied clip and step bound (its methods, below).
    ``motion_mode="coarse"``: a drag frame renders through the uncached
    sharded step at ``motion_stride`` x the step, the settled camera
    re-bakes blocking; "truncated" is refused.

    ``state.accum`` is the rank's band; ``image()`` / ``image_u8()`` gather
    the whole frame and are collectives: every rank calls them and every
    rank receives the frame."""

    # Cached frames per call (one photon walk per batch).
    frame_batch: int = 8

    # The Renderer's derivations from the params, config and grid: the
    # march's step bound, the exact coarse cell, PATH's LUT radius and walk
    # cell, the occupied clip (copied to the device once per grid; None and
    # one step for a grid with no occupied brick, whose frames are black),
    # and the view and PathView keys.
    _max_steps = Renderer._max_steps
    _march_cell = Renderer._march_cell
    _shadow_lut_radius = Renderer._shadow_lut_radius
    _path_cell = Renderer._path_cell
    _occupied_clip = Renderer._occupied_clip
    _make_view_key = Renderer._make_view_key
    _make_path_view_key = Renderer._make_path_view_key

    def __init__(self, grid: DenseGrid, mesh, config: StaticConfig,
                 params: RenderParams, algorithm: Algorithm):
        if config.motion_mode not in ("off", "coarse"):
            raise ValueError(
                "MeshRenderer supports motion_mode 'off' or 'coarse' only; "
                "'truncated' is the single-device identity-order build "
                f"(got {config.motion_mode!r})")
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.grid = replicate(mesh, grid)
        self._grid_token = 0  # the grid is fixed for the session
        self.config = config
        self.params = params
        self.algorithm = Algorithm(algorithm)
        _, rows = row_band(mesh, config)
        self.state = RenderState.create(rows, config.width, self.device)
        self._view = None
        self._view_key = None
        self._path_view = None
        self._path_view_key = None
        self._last_step_key = None

    @property
    def _use_compact(self) -> bool:
        """The compact view (occupied clip, brick-skipping march, lane
        compaction, compact-space accumulation) takes every exact view with
        float32 accumulation."""
        return (self.config.compact_view and self.config.gather_samples == 0
                and not _u8(self.config))

    def _current_view(self, key):
        if self._view is None or key != self._view_key:
            self._view = None  # release the stale planes before the rebuild
            if self._use_compact:
                clip_box, view_steps = self._occupied_clip()
                self._view = build_compact_view_sharded(
                    self.grid, self.params, clip_box, config=self.config,
                    steps=min(self._max_steps, view_steps), mesh=self.mesh,
                    march_cell=self._march_cell())
            else:
                self._view = build_view_sharded(
                    self.grid, self.params, config=self.config,
                    max_steps=self._max_steps, mesh=self.mesh,
                    gather_samples=self.config.gather_samples)
            self._view_key = key
        return self._view

    def _current_path_view(self, key, lut_radius: int):
        if self._path_view is None or key != self._path_view_key:
            self._path_view = None
            self._path_view = bake_path_view_sharded(
                self.grid, self.params, config=self.config,
                max_steps=self._max_steps, mesh=self.mesh,
                shadow_lut_radius=lut_radius)
            self._path_view_key = key
        return self._path_view

    def _motion_steps(self, n: int) -> RenderState:
        """Drag frames: the uncached sharded step with the march (and the
        photon walk) at ``motion_stride`` x the step size, no view rebuild;
        equal to the single-device Renderer's coarse drag frames."""
        coarse = self.params.ray_marching_step_size * max(
            1, int(self.config.motion_stride))
        params = self.params.replace(ray_marching_step_size=f32(coarse))
        steps = color_mod.required_march_steps(self.grid, coarse,
                                               self.config.max_march_steps)
        kw = {}
        if self.algorithm is Algorithm.PATH:
            kw = dict(shadow_lut_radius=self._shadow_lut_radius(coarse),
                      march_cell=self._march_cell(coarse))
        for _ in range(n):
            self.state = sharded_render_step(
                self.grid, params, self.state, algorithm=self.algorithm,
                config=self.config, max_steps=steps, mesh=self.mesh,
                gather_samples=self.config.gather_samples, **kw)
        return self.state

    def _moving(self, key, cached_key) -> bool:
        """A drag frame: a march-relevant key that changed since the last
        bake and since the previous step() call."""
        return (self.config.motion_mode == "coarse"
                and cached_key is not None and key != cached_key
                and key != self._last_step_key)

    def step(self, n: int = 1) -> RenderState:
        if self.algorithm is Algorithm.PATH:
            return self._path_step(n)
        key = self._make_view_key(self._max_steps)
        moving = self._moving(key, self._view_key)
        self._last_step_key = key
        if moving:
            return self._motion_steps(n)
        view = self._current_view(key)
        shade = (sharded_shade_compact_step if self._use_compact
                 else sharded_shade_step)
        remaining = n
        while remaining > 0:
            k = self.frame_batch if remaining >= self.frame_batch else 1
            self.state = shade(
                self.grid, self.params, self.state, view,
                algorithm=self.algorithm, config=self.config,
                max_steps=self._max_steps, mesh=self.mesh, n_frames=k)
            remaining -= k
        return self.state

    def _path_step(self, n: int) -> RenderState:
        steps = self._max_steps
        lut_r = self._shadow_lut_radius()
        cell = self._path_cell(self.params.ray_marching_step_size)
        key = self._make_path_view_key(steps, lut_r, self.params)
        moving = self._moving(key, self._path_view_key)
        self._last_step_key = key
        if moving:
            return self._motion_steps(n)
        _, rows = row_band(self.mesh, self.config)
        n_rays = rows * self.config.width
        cache_bytes = path_mod.view_bytes(path_mod.padded_rays(n_rays, steps),
                                          steps)
        cache = (self._current_path_view(key, lut_r)
                 if cache_bytes <= Renderer.path_cache_budget_bytes else None)
        for _ in range(n):
            if cache is None:
                self.state = sharded_render_step(
                    self.grid, self.params, self.state,
                    algorithm=Algorithm.PATH, config=self.config,
                    max_steps=steps, mesh=self.mesh,
                    shadow_lut_radius=lut_r, march_cell=cell)
            else:
                self.state = sharded_path_step_cached(
                    self.grid, self.params, self.state, cache,
                    config=self.config, max_steps=steps, mesh=self.mesh,
                    shadow_lut_radius=lut_r, march_cell=cell)
        return self.state

    # ---- presentation (collectives over "rows") ----

    def _full_state(self) -> RenderState:
        return RenderState(gather_rows(self.mesh, self.state.accum),
                           self.state.frame_count)

    def image(self) -> np.ndarray:
        """The whole (H, W, 3) frame, on every rank."""
        return self._full_state().rgb().cpu().numpy()

    def image_u8(self) -> np.ndarray:
        """The whole (H, W, 3) uint8 frame, on every rank."""
        return self._full_state().rgb_u8().cpu().numpy()
