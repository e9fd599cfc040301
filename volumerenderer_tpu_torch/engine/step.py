"""Per-frame render steps (twin of volumerenderer_tpu.engine.step): the
uncached step, which marches every ray (and shades it in slots layout, or
path-traces it for PATH), and the steps over a baked view or PathView.

A frame is: frameCount++, clear on frame 1, photon-walk light generation
(none for PATH), shading, progressive accumulation.  Every step returns
(new_state, lights); PATH's lights are empty.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.dense import DenseGrid
from ..render import color as color_mod
from ..render import path as path_mod
from ..render import photon
from .params import Algorithm, RenderParams, StaticConfig
from .state import RenderState, accumulate


def _u8(config: StaticConfig) -> bool:
    """Whether each frame's average is quantized to 8 bits."""
    return config.accum_dtype == "uint8"


def render_step(grid: DenseGrid, params: RenderParams, state: RenderState,
                *, algorithm: Algorithm, config: StaticConfig,
                max_steps: int, gather_samples: int = 0,
                shadow_lut_radius: int = 0, march_cell: int = 1,
                light_step=None):
    """One uncached frame (march + shade, render_frame): returns
    (new_state, lights).

    ``gather_samples``: top-k compaction of the march (0 keeps every
    sample; PATH ignores it).  ``shadow_lut_radius``, ``march_cell`` and
    ``light_step`` are PATH's (render.path.render_frame)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    if algorithm is Algorithm.PATH:
        frame = path_mod.render_frame(
            grid, params, fc, config, max_steps,
            shadow_lut_radius=shadow_lut_radius, march_cell=march_cell,
            light_step=light_step)
        return (RenderState(accumulate(accum, frame, fc, _u8(config)), fc),
                photon.empty_lights(config, grid.device))
    lights = photon.generate_lights(grid, params, [fc], config,
                                    max_steps=max_steps)
    frame = color_mod.render_frame(grid, params, lights, algorithm, config,
                                   max_steps, gather_samples=gather_samples)
    return RenderState(accumulate(accum, frame, fc, _u8(config)), fc), lights


def build_view_step(grid: DenseGrid, params: RenderParams, clip_box=None,
                    row_start: int = 0, *, config: StaticConfig,
                    max_steps: int, gather_samples: int = 0,
                    num_rows: int | None = None,
                    occupied_cap: int | None = None, march_cell: int = 8):
    """Bake the per-view march in slots layout (render.color.build_view)
    once per camera/volume/step change; reused by every cached frame."""
    return color_mod.build_view(
        grid, params, config, max_steps, row_start, num_rows,
        clip_box=clip_box, occupied_cap=occupied_cap, march_cell=march_cell,
        gather_samples=gather_samples)


def render_step_cached(grid: DenseGrid, params: RenderParams,
                       state: RenderState, view, *,
                       algorithm: Algorithm, config: StaticConfig,
                       max_steps: int):
    """One frame over a baked CompactView or ViewCache, in image space:
    returns (new_state, lights)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    lights = photon.generate_lights(grid, params, [fc], config,
                                    max_steps=max_steps)
    frame = color_mod.shade_view(grid, view, params, lights, algorithm, config)
    return RenderState(accumulate(accum, frame, fc, _u8(config)), fc), lights


def render_steps_cached(grid: DenseGrid, params: RenderParams,
                        state: RenderState, view, *,
                        algorithm: Algorithm, config: StaticConfig,
                        max_steps: int, n_frames: int):
    """``n_frames`` frames over a baked view.

    The photon walks of all frames run first, as one walk of n_frames x 16
    photons.  Over a ViewCache, and with ``accum_dtype="uint8"`` (each
    frame quantized in image space), each frame then shades and accumulates
    in image space.  Otherwise over a CompactView each frame updates only
    the (Rc,) lane vector; one expansion to the image runs at the end,
    where the miss pixels' average over n all-zero frames collapses to a
    scale by m / (m + n)."""
    m = state.frame_count
    fcs = [m + 1 + i for i in range(n_frames)]
    lights = photon.generate_lights(grid, params, fcs, config,
                                    max_steps=max_steps)
    if isinstance(view, color_mod.ViewCache) or _u8(config):
        accum = state.accum
        for i, fc in enumerate(fcs):
            frame = color_mod.shade_view(grid, view, params, lights,
                                         algorithm, config, frame=i)
            if fc == 1:
                accum = torch.zeros_like(accum)
            accum = accumulate(accum, frame, fc, _u8(config))
        return RenderState(accum, m + n_frames), lights
    accum_flat = state.accum.reshape(-1)
    accum_c = accum_flat[view.src.to(torch.int64)]
    for i, fc in enumerate(fcs):
        frame_c = color_mod.shade_view_compact(
            grid, view, params, lights, algorithm, config, frame=i
        )
        if fc == 1:
            accum_c = torch.zeros_like(accum_c)
        accum_c = accumulate(accum_c, frame_c, fc)
    return expand_compact_batch(state, accum_c, view, m + n_frames), lights


def expand_compact_batch(state: RenderState, accum_c: torch.Tensor,
                         view, fc_end: int) -> RenderState:
    """The image state after frames ``state.frame_count + 1`` .. ``fc_end``
    accumulated in compact space: hit rays take their lane's ``accum_c``,
    and a miss pixel's average over the batch's all-zero frames is its old
    value scaled by m / fc_end."""
    m = state.frame_count
    factor = 0.0 if m == 0 else float(np.float32(m) / np.float32(fc_end))
    expanded = color_mod.expand_compact_colors(accum_c, view)
    hit = (view.inv_map < view.src.shape[0])[: view.n_rays]
    new_flat = torch.where(hit, expanded, state.accum.reshape(-1) * factor)
    return RenderState(new_flat.reshape(state.accum.shape), fc_end)


def bake_path_view_step(grid: DenseGrid, params: RenderParams, *,
                        config: StaticConfig, max_steps: int,
                        shadow_lut_radius: int = 0, light_step=None):
    """Bake PATH's frame-invariant camera segment (render.path.
    bake_path_view) once per camera/volume/light change."""
    return path_mod.bake_path_view(
        grid, params, config, max_steps,
        shadow_lut_radius=shadow_lut_radius, light_step=light_step)


def render_path_step_cached(grid: DenseGrid, params: RenderParams,
                            state: RenderState, cache, *,
                            config: StaticConfig, max_steps: int,
                            shadow_lut_radius: int = 0, march_cell: int = 1,
                            light_step=None):
    """One PATH frame over a baked PathView: the camera segment replays
    the view, then the scatter segments.  Identical to render_step.
    Returns (new_state, lights)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    frame = path_mod.render_frame(
        grid, params, fc, config, max_steps,
        shadow_lut_radius=shadow_lut_radius, cache=cache,
        march_cell=march_cell, light_step=light_step)
    return (RenderState(accumulate(accum, frame, fc, _u8(config)), fc),
            photon.empty_lights(config, grid.device))


def render_path_steps_cached(grid: DenseGrid, params: RenderParams,
                             state: RenderState, cache, *,
                             config: StaticConfig, max_steps: int,
                             n_frames: int, shadow_lut_radius: int = 0,
                             march_cell: int = 1, light_step=None):
    """``n_frames`` PATH frames over a baked PathView with their scatter
    segments walked together (render.path.render_frames), accumulated
    frame by frame in order: identical to n_frames single steps.
    Returns (new_state, lights)."""
    m = state.frame_count
    fcs = [m + 1 + i for i in range(n_frames)]
    frames = path_mod.render_frames(
        grid, params, fcs, config, max_steps, cache,
        shadow_lut_radius=shadow_lut_radius, march_cell=march_cell,
        light_step=light_step)
    accum = state.accum
    for i, fc in enumerate(fcs):
        if fc == 1:
            accum = torch.zeros_like(accum)
        accum = accumulate(accum, frames[i], fc, _u8(config))
    return (RenderState(accum, m + n_frames),
            photon.empty_lights(config, grid.device))
