"""Interactive renderer session (twin of the cached branch of
volumerenderer_tpu.engine.session.Renderer).

UI semantics (src/main.cpp:649-698):

  * ``set_algorithm`` — switches algorithm and resets accumulation;
  * ``set(**fields)`` — edits params; accumulation does not reset;
  * ``refresh``       — frameCount = 0;
  * ``resize``        — new buffers, frameCount = 0;
  * ``step(n)``       — n drawFrames;
  * ``image`` / ``image_u8`` — the presented accumulation buffer.

Everything runs on the session's ``device``; grid, view, lights and the
accumulator live there.  The march is baked once per camera/volume/march
parameters into a compact view and reused by every frame.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..grid.dense import DenseGrid, occupied_bbox
from ..ops.kernels.gather_lanes import TILE_L
from ..render.color import build_compact_view_device, required_march_steps
from .params import Algorithm, RenderParams, StaticConfig, check_algorithm
from .state import RenderState
from .step import render_step_cached, render_steps_cached


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
        self.config = config or StaticConfig()
        self.params = params or RenderParams.default()
        self.algorithm = check_algorithm(algorithm)
        self.state = RenderState.create(self.config.height, self.config.width,
                                        self.device)
        self.lights = None
        self._view = None
        self._view_key = None
        self.view_exact = True
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

    def _march_cell(self) -> int:
        """Largest exact coarse cell: cell * step <= one 8-voxel brick."""
        return max(1, int(8.0 // max(self.params.ray_marching_step_size, 1e-6)))

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
        """Whether the compact view's planes fit the device budget."""
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
            if (self.config.compact_build == "auto"
                    and not self._device_build_ok(steps)):
                raise NotImplementedError(
                    "compact view exceeds device_view_budget_bytes; the "
                    "host-banded build is not ported to PyTorch yet: "
                    "ROADMAP Queue 1 item 13"
                )
            self._view = self._build_compact_view_device(clip_box, steps)
            self._view_key = key
        return self._view

    # ---- frame loop ----

    def step(self, n: int = 1) -> RenderState:
        state = self._step(n)
        if self.lights is not None:
            self._maybe_warn_light_truncation()
        return state

    def _step(self, n: int = 1) -> RenderState:
        max_steps = self._max_steps
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
            self.host_syncs += lights.walk_syncs
            self.lights = lights.frame(k - 1)
            remaining -= k
        return self.state

    # ---- presentation ----

    def image(self) -> np.ndarray:
        return self.state.rgb().cpu().numpy()

    def image_u8(self) -> np.ndarray:
        return self.state.rgb_u8().cpu().numpy()
