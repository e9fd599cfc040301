"""Interactive renderer session (twin of the gather-algorithm branches of
volumerenderer_tpu.engine.session.Renderer).

UI semantics (src/main.cpp:649-698):

  * ``set_algorithm`` — switches algorithm and resets accumulation;
  * ``set(**fields)`` — edits params; accumulation does not reset;
  * ``refresh``       — frameCount = 0;
  * ``resize``        — new buffers, frameCount = 0;
  * ``step(n)``       — n drawFrames;
  * ``image`` / ``image_u8`` — the presented accumulation buffer.

Everything runs on the session's ``device`` (the grid's unless given);
grid, view, lights and the accumulator live there.  The march is baked
once per camera/volume/march parameters into a compact view (or, with
``compact_view=False``, a slots ViewCache) and reused by every frame;
``use_view_cache=False`` marches every frame (the uncached step).

Interactive paths (``StaticConfig.motion_mode``): a frame whose camera or
march parameters differ from the previous frame's is a drag frame and
renders through the coarse uncached step or the truncated identity-order
build; the first frame of a settled camera rebuilds the exact view, in
``settle_chunks`` row chunks with coarse frames in between (coarse mode).
``first_frame_uncached``: a new session presents its first frame through
the uncached step before it builds the view (the viewer's setting).

PATH (``_path_step``) bakes its camera segment into a PathView keyed like
the view plus the light, and renders uncached when the view exceeds
``path_cache_budget_bytes``; a coarse drag skips the re-bake, and the
settled camera re-bakes blocking.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..grid.dense import DenseGrid, occupied_bbox
from ..ops.kernels.gather_lanes import TILE_L
from ..ops.march import f32
from ..render.color import (
    build_compact_view_device, merge_row_views, required_march_steps,
)
from ..render.path import padded_rays, view_bytes
from .params import (
    Algorithm, Fidelity, RenderParams, StaticConfig, check_algorithm,
)
from .state import RenderState
from .step import (
    bake_path_view_step, build_view_step, render_path_step_cached,
    render_path_steps_cached, render_step, render_step_cached,
    render_steps_cached,
)


def _resolve_device(device, grid: DenseGrid) -> torch.device:
    dev = torch.device(device) if device is not None else grid.device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Renderer(device={device!r}): CUDA is not available")
    return dev


class Renderer:
    # Cached frames run in batches of this size (one photon walk per batch).
    frame_batch: int = 8

    # Budget for the compact view's resident planes (all rays x global cap
    # x 16 B).  Larger views need the host-banded build, not ported yet.
    device_view_budget_bytes: int = 6 << 30

    # Budget for PATH's baked camera segment, every byte of it: the rank
    # planes (6 B per ray and step), the per-ray planes (39 B) and the
    # tile padding (render.path.view_bytes).  Above it PATH renders
    # uncached, with identical results.  Sized for the 80 GB H100: the
    # 1080p bench view (169 steps) takes 2.18 GB, over the reference
    # package's 2 GiB, which was sized for a TPU's HBM.
    path_cache_budget_bytes: int = 8 << 30

    # PATH frames per batch (engine.step.render_path_steps_cached, with
    # the scatter segments of the batch walked together; identical to
    # single frames).
    path_frame_batch: int = 1

    def __init__(
        self,
        grid: DenseGrid,
        config: StaticConfig | None = None,
        params: RenderParams | None = None,
        algorithm: Algorithm = Algorithm.RAY,  # default (src/main.cpp:119)
        device=None,
    ):
        self.device = _resolve_device(device, grid)
        self._grid_token = 0
        self.grid = grid
        self._suppress_motion_once = False  # set by resize and grid swaps
        self.config = config or StaticConfig()
        self.params = params or RenderParams.default()
        self.algorithm = check_algorithm(algorithm)
        self.state = RenderState.create(self.config.height, self.config.width,
                                        self.device)
        self.lights = None
        # False: every frame marches anew through the uncached step.
        self.use_view_cache = True
        self._view = None
        self._view_key = None
        self.view_exact = True
        self._settle = None  # the progressive settle in flight
        self._last_step_key = None  # the previous frame's view key
        self._path_view = None  # PATH's baked camera segment
        self._path_view_key = None
        self._last_path_step_key = None
        # Present a new session's first frame through the uncached step
        # (one march + shade) before building the view.  It differs from
        # the cached frame by the sum over samples: PyTorch sums the slot
        # kernel's (R, C) output, the lane kernel sums inside.
        self.first_frame_uncached = False
        self._ttff_done = False
        self._budget_checked = False
        # Host reads (device -> host syncs) made by frames and builds.
        self.host_syncs = 0

    # ---- volume ----

    @property
    def grid(self) -> DenseGrid:
        return self._grid

    @grid.setter
    def grid(self, new_grid: DenseGrid) -> None:
        self._grid = (new_grid if new_grid.device == self.device
                      else new_grid.to(self.device))
        # Caches key on this counter: a replaced grid never aliases a
        # stale view.
        self._grid_token += 1
        # A volume swap changes the view key but is not a camera drag.
        self._suppress_motion_once = True
        self._settle = None

    # ---- UI semantics ----

    def set_algorithm(self, algorithm: Algorithm) -> None:
        algorithm = check_algorithm(algorithm)
        if algorithm != self.algorithm:
            self.algorithm = algorithm
            self.state = self.state.refresh()
            self._budget_checked = False

    def set(self, **fields) -> None:
        """Edit RenderParams fields (slider semantics: no accumulation reset)."""
        self.params = self.params.replace(**fields)

    def refresh(self) -> None:
        self.state = self.state.refresh()
        self._budget_checked = False

    def resize(self, width: int, height: int) -> None:
        """Swapchain recreation: new buffers, frameCount = 0."""
        self.config = dataclasses.replace(self.config, width=width,
                                          height=height)
        self.state = RenderState.create(height, width, self.device)
        # Not a drag: frame 1 of the fresh accumulation must be exact.
        self._suppress_motion_once = True
        self._settle = None

    def _maybe_warn_light_truncation(self) -> None:
        """Once per accumulation: warn if max_events_per_photon truncated
        the light population below the reference's unbounded walk
        (PARITY #1).  One host read on the first frame after
        construction, refresh or algorithm switch."""
        if self._budget_checked:
            return
        self._budget_checked = True
        self.host_syncs += 1
        if bool(self.lights.truncated.any()):
            warnings.warn(
                "photon event budget saturated: some photon scattered "
                f"with all {self.config.max_events_per_photon} of its "
                "event slots full, so this frame's light population is "
                "truncated below the reference's unbounded walk (PARITY "
                "#1 scale caveat). Raise "
                "StaticConfig.max_events_per_photon (and light_capacity "
                "for headroom past params.max_lights) for "
                "reference-scale light populations.",
                RuntimeWarning,
                stacklevel=3,
            )

    # ---- view cache ----

    @property
    def _max_steps(self) -> int:
        return required_march_steps(
            self.grid, self.params.ray_marching_step_size,
            self.config.max_march_steps,
        )

    def _march_cell(self, step: float | None = None) -> int:
        """Largest exact coarse cell: cell * step <= one 8-voxel brick (the
        params' step unless given)."""
        if step is None:
            step = self.params.ray_marching_step_size
        return max(1, int(8.0 // max(float(step), 1e-6)))

    def _occupied_clip(self):
        """Occupied-brick bbox + step bound, cached per grid: marches clip
        to the occupied region with bit-identical results."""
        if getattr(self, "_occ_cache_id", None) != self._grid_token:
            self.host_syncs += 1
            self._occ_cache = occupied_bbox(self.grid)
            self._occ_cache_id = self._grid_token
        box = self._occ_cache
        if box is None:
            return None, 1
        diag = float(np.linalg.norm(box[1] - box[0]))
        steps = int(math.ceil(diag / self.params.ray_marching_step_size)) + 3
        return box, max(1, min(steps, self.config.max_march_steps))

    def _make_view_key(self, max_steps: int):
        p = self.params
        return (
            tuple(p.camera_pos.tolist()),
            tuple(p.camera_rotation.reshape(-1).tolist()),
            p.fov,
            p.ray_max_distance,
            p.ray_marching_step_size,
            p.absorption_coefficient,
            self.config.width,
            self.config.height,
            max_steps,
            self._grid_token,
        )

    def _device_build_ok(self, steps: int) -> bool:
        """Whether the compact view may be built on the device: always for
        ``compact_build="device"``; for "auto" when its planes fit the
        device budget."""
        if self.config.compact_build == "device":
            return True
        n_rays = self.config.height * self.config.width
        lanes_n = -(-n_rays // TILE_L) * TILE_L
        cell = self._march_cell()
        s_eff = -(-steps // cell) * cell if cell > 1 else steps
        return lanes_n * s_eff * 16 <= self.device_view_budget_bytes

    def _build_compact_view_device(self, clip_box, steps: int):
        self.view_exact = True
        view = build_compact_view_device(
            self.grid, self.params, self.config, steps, clip_box=clip_box,
            march_cell=self._march_cell(),
        )
        self.host_syncs += view.host_syncs
        return view

    def _current_view(self, max_steps: int):
        """The baked view for the current camera/volume/march params,
        rebuilt when any of them changes (light edits do not rebuild)."""
        key = self._make_view_key(max_steps)
        if key != self._view_key or self._view is None:
            self._view = None  # release the stale planes before the rebuild
            self._view_key = None
            clip_box, view_steps = self._occupied_clip()
            steps = min(max_steps, view_steps)
            if not self.config.compact_view:
                self.view_exact = True
                self._view = build_view_step(
                    self.grid, self.params, clip_box, config=self.config,
                    max_steps=steps)
            elif self._device_build_ok(steps):
                self._view = self._build_compact_view_device(clip_box, steps)
            else:
                raise NotImplementedError(
                    "compact view exceeds device_view_budget_bytes; the "
                    "host-banded build is not ported to PyTorch yet: "
                    "ROADMAP Queue 1 item 13"
                )
            self._view_key = key
        return self._view

    # ---- interactive paths ----

    def _motion_steps(self, n: int, max_steps: int) -> RenderState:
        """Drag frames.  "coarse": the uncached step with the march (and the
        photon walk) at ``motion_stride`` x the step size, so the coarser
        Riemann sum keeps the settled image's brightness.  "truncated": the
        first ``motion_cap`` occupied samples of each ray through an
        identity-order compact build, shaded once."""
        if self.config.motion_mode == "coarse":
            stride = max(1, int(self.config.motion_stride))
            coarse = float(self.params.ray_marching_step_size) * stride
            params = self.params.replace(ray_marching_step_size=f32(coarse))
            steps = required_march_steps(self.grid, coarse,
                                         self.config.max_march_steps)
            self.view_exact = stride == 1
            if self.algorithm is Algorithm.PATH:
                # PATH's LUT radius and march cell re-derived for the
                # coarse step (a radius over shadow_lut_max_radius turns
                # the LUT off).
                for _ in range(n):
                    self._path_uncached(params, steps,
                                        self._shadow_lut_radius(coarse),
                                        self._march_cell(coarse), None)
                return self.state
            for _ in range(n):
                self.state, lights = render_step(
                    self.grid, params, self.state, algorithm=self.algorithm,
                    config=self.config, max_steps=steps)
                self._took(lights, 1)
            return self.state
        clip_box, view_steps = self._occupied_clip()
        steps = min(self.config.motion_cap, view_steps, max_steps)
        self.view_exact = steps >= min(view_steps, max_steps)
        mv = build_compact_view_device(
            self.grid, self.params, self.config, steps, clip_box=clip_box,
            march_cell=self._march_cell(), order="identity")
        for _ in range(n):
            self.state, lights = render_step_cached(
                self.grid, self.params, self.state, mv,
                algorithm=self.algorithm, config=self.config,
                max_steps=max_steps)
            self._took(lights, 1)
        return self.state

    def _settle_step(self, key, max_steps: int, n: int) -> bool:
        """Advance the progressive settle: build one row chunk of the exact
        view for the settled camera, and render this tick's frames through
        the coarse path.  When the last of ``settle_chunks`` chunks lands
        they merge into the exact view (render.color.merge_row_views).

        Returns True when an exact view for ``key`` is installed, or when
        the progressive path does not apply (settle_chunks <= 1, a height
        not divisible by it, motion_mode other than "coarse", the slots
        view, a view over the device budget) and the caller rebuilds
        blocking."""
        K = int(self.config.settle_chunks)
        H = self.config.height
        if (K <= 1 or H % K or self.config.motion_mode != "coarse"
                or not self.config.compact_view):
            self._settle = None
            return True
        st = self._settle
        if st is not None and st["K"] != K:
            st = None  # settle_chunks changed mid-progress: restart
        if st is None or st["key"] != key:
            clip_box, view_steps = self._occupied_clip()
            steps = min(max_steps, view_steps)
            if not self._device_build_ok(steps):
                self._settle = None
                return True
            # Drop the stale view now (the chunks grow toward its size);
            # its key stays, the "camera away from the view" signal.
            self._view = None
            st = self._settle = {"key": key, "clip": clip_box,
                                 "steps": steps, "views": [], "K": K}
        i = len(st["views"])
        # Bands K x narrower inside a chunk keep the per-band caps as tight
        # as the full build's.
        band = max(TILE_L, (512 * 1024 // K) // TILE_L * TILE_L)
        view = build_compact_view_device(
            self.grid, self.params, self.config, st["steps"],
            clip_box=st["clip"], row_start=i * (H // K), num_rows=H // K,
            march_cell=self._march_cell(), band_lanes=band)
        self.host_syncs += view.host_syncs
        st["views"].append(view)
        if len(st["views"]) < K:
            self._motion_steps(n, max_steps)
            return False
        self._view = merge_row_views(st["views"])
        self._view_key = key
        self.view_exact = True
        self._settle = None
        return True

    # ---- frame loop ----

    def step(self, n: int = 1) -> RenderState:
        state = self._step(n)
        if self.lights is not None:
            self._maybe_warn_light_truncation()
        return state

    def _took(self, lights, k: int) -> None:
        """Book a step's lights: its walk's host reads, the last frame's."""
        self.host_syncs += lights.walk_syncs
        self.lights = lights.frame(k - 1)

    # ---- PATH ----

    def _shadow_lut_radius(self, step: float | None = None) -> int:
        """ceil(step) when PATH's shadow-probe LUT applies (REFERENCE
        fidelity, radius within config.shadow_lut_max_radius), else 0."""
        if self.config.fidelity is not Fidelity.REFERENCE:
            return 0
        if step is None:
            step = self.params.ray_marching_step_size
        r = math.ceil(float(step))
        return r if 0 < r <= self.config.shadow_lut_max_radius else 0

    def _path_cell(self, step: float) -> int:
        """The scatter walk's march cell: config.path_march_cell, or for 0
        the largest exact cell at ``step``."""
        return self.config.path_march_cell or self._march_cell(step)

    def _path_effective(self, max_steps: int):
        """The path_stride tier's (params, light_step, max_steps): the march
        step scales by the stride, the roll probability becomes
        1 - (1 - p)^stride (the expected scatter events per unit length of
        independent per-step rolls), and the light term keeps the original
        step.  Stride 1 returns the params untouched."""
        k = self.config.path_stride
        if k <= 1:
            return self.params, None, max_steps
        step0 = np.float32(self.params.ray_marching_step_size)
        q = np.float32(1.0) - np.float32(self.params.scattering_probability)
        # q**k by squaring, in f32, as the reference package's integer_pow.
        acc, y = None, k
        while y > 0:
            if y & 1:
                acc = q if acc is None else np.float32(acc * q)
            y >>= 1
            if y > 0:
                q = np.float32(q * q)
        params = self.params.replace(
            ray_marching_step_size=step0 * np.float32(k),
            scattering_probability=np.float32(1.0) - acc,
        )
        steps = required_march_steps(self.grid, float(step0) * k,
                                     self.config.max_march_steps)
        return params, float(step0), min(steps, max_steps)

    def _make_path_view_key(self, max_steps: int, lut_radius: int,
                            params: RenderParams):
        """The view key plus every field the contribution prefix bakes in
        (the light's position and intensity); the scattering probability
        and the frame counter stay per frame."""
        p = params
        return (
            tuple(p.camera_pos.tolist()),
            tuple(p.camera_rotation.reshape(-1).tolist()),
            p.fov,
            p.ray_max_distance,
            p.ray_marching_step_size,
            p.absorption_coefficient,
            tuple(p.light_source_world_pos.tolist()),
            p.photon_initial_intensity,
            self.config.width,
            self.config.height,
            max_steps,
            lut_radius,
            self.config.fidelity,
            self._grid_token,
        )

    def _current_path_view(self, max_steps: int, lut_radius: int,
                           params: RenderParams, light_step):
        key = self._make_path_view_key(max_steps, lut_radius, params)
        if key != self._path_view_key or self._path_view is None:
            self._path_view = None  # release the stale planes first
            self._path_view_key = None
            self._path_view = bake_path_view_step(
                self.grid, params, config=self.config, max_steps=max_steps,
                shadow_lut_radius=lut_radius, light_step=light_step)
            self._path_view_key = key
        return self._path_view

    def _took_path(self, out) -> None:
        self.state, self.lights, reads = out
        self.host_syncs += reads

    def _path_uncached(self, params, max_steps, lut_r, cell, light_step):
        self._took_path(render_step(
            self.grid, params, self.state, algorithm=Algorithm.PATH,
            config=self.config, max_steps=max_steps,
            shadow_lut_radius=lut_r, march_cell=cell,
            light_step=light_step))

    def _path_step(self, n: int, max_steps: int) -> RenderState:
        """PATH frames: over the baked PathView when it fits
        path_cache_budget_bytes (a drag in coarse motion mode skips the
        re-bake; the first frame of a new session may go uncached), else
        uncached."""
        p_eff, light_step, max_steps = self._path_effective(max_steps)
        lut_r = self._shadow_lut_radius()
        cell = self._path_cell(p_eff.ray_marching_step_size)
        n_rays = self.config.width * self.config.height
        cache_bytes = view_bytes(padded_rays(n_rays, max_steps), max_steps)
        self.view_exact = True
        if not (self.use_view_cache
                and cache_bytes <= self.path_cache_budget_bytes):
            for _ in range(n):
                self._path_uncached(p_eff, max_steps, lut_r, cell, light_step)
            return self.state
        key = self._make_path_view_key(max_steps, lut_r, p_eff)
        moving = (self.config.motion_mode == "coarse"
                  and self._path_view_key is not None
                  and key != self._path_view_key
                  and key != self._last_path_step_key
                  and not self._suppress_motion_once)
        self._suppress_motion_once = False
        self._last_path_step_key = key
        if moving:
            return self._motion_steps(n, max_steps)
        if (self.first_frame_uncached and not self._ttff_done
                and self._path_view is None and self._path_view_key is None):
            self._ttff_done = True
            self._path_uncached(p_eff, max_steps, lut_r, cell, light_step)
            n -= 1
            if n <= 0:
                return self.state
        cache = self._current_path_view(max_steps, lut_r, p_eff, light_step)
        remaining = n
        while remaining > 0:
            k = (self.path_frame_batch
                 if remaining >= self.path_frame_batch else 1)
            kw = dict(config=self.config, max_steps=max_steps,
                      shadow_lut_radius=lut_r, march_cell=cell,
                      light_step=light_step)
            if k == 1:
                self._took_path(render_path_step_cached(
                    self.grid, p_eff, self.state, cache, **kw))
            else:
                self._took_path(render_path_steps_cached(
                    self.grid, p_eff, self.state, cache, n_frames=k, **kw))
            remaining -= k
        return self.state

    def _step(self, n: int = 1) -> RenderState:
        max_steps = self._max_steps
        if self.algorithm is Algorithm.PATH:
            return self._path_step(n, max_steps)
        if not self.use_view_cache:
            for _ in range(n):
                self.state, lights = render_step(
                    self.grid, self.params, self.state,
                    algorithm=self.algorithm, config=self.config,
                    max_steps=max_steps)
                self._took(lights, 1)
            return self.state
        key = self._make_view_key(max_steps)
        suppress = self._suppress_motion_once
        moving = (self.config.motion_mode != "off"
                  and self._view_key is not None
                  and key != self._view_key
                  and key != self._last_step_key
                  and not suppress)
        self._suppress_motion_once = False
        self._last_step_key = key
        if moving:
            self._settle = None  # the camera moved again: drop progress
            return self._motion_steps(n, max_steps)
        if (not suppress and key != self._view_key
                and (self._view_key is not None or self._settle is not None)):
            # The camera settled on a stale view: rebuild progressively.
            if not self._settle_step(key, max_steps, n):
                return self.state
        if (self.first_frame_uncached and not self._ttff_done
                and self._view is None and self._view_key is None
                and self._settle is None):
            # A new session's first frame, before the view build.
            self._ttff_done = True
            self.state, lights = render_step(
                self.grid, self.params, self.state,
                algorithm=self.algorithm, config=self.config,
                max_steps=max_steps)
            self._took(lights, 1)
            n -= 1
            if n <= 0:
                return self.state
        view = self._current_view(max_steps)
        remaining = n
        while remaining > 0:
            k = self.frame_batch if remaining >= self.frame_batch else 1
            if k == 1:
                self.state, lights = render_step_cached(
                    self.grid, self.params, self.state, view,
                    algorithm=self.algorithm, config=self.config,
                    max_steps=max_steps,
                )
            else:
                self.state, lights = render_steps_cached(
                    self.grid, self.params, self.state, view,
                    algorithm=self.algorithm, config=self.config,
                    max_steps=max_steps, n_frames=k,
                )
            self._took(lights, k)
            remaining -= k
        return self.state

    # ---- presentation ----

    def image(self) -> np.ndarray:
        return self.state.rgb().cpu().numpy()

    def image_u8(self) -> np.ndarray:
        return self.state.rgb_u8().cpu().numpy()
