"""Per-frame render steps (twin of volumerenderer_tpu.engine.step): the
uncached step, which marches every ray (and shades it in slots layout, or
path-traces it for PATH), and the steps over a baked view or PathView.

A frame is: frameCount++, clear on frame 1, photon-walk light generation
(none for PATH), shading, progressive accumulation.  The PATH steps return
(new_state, lights, host_reads): the lights are empty and the host reads
are the frame's alive counts and early exits (render.path.PathTrace).
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


def render_step(grid: DenseGrid, params: RenderParams, state: RenderState,
                *, algorithm: Algorithm, config: StaticConfig,
                max_steps: int, shadow_lut_radius: int = 0,
                march_cell: int = 1, light_step=None):
    """One uncached frame (march + shade, render_frame): returns
    (new_state, lights), and for PATH (new_state, lights, host_reads).

    ``shadow_lut_radius``, ``march_cell`` and ``light_step`` are PATH's
    (render.path.render_frame)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    if algorithm is Algorithm.PATH:
        trace = path_mod.PathTrace()
        frame = path_mod.render_frame(
            grid, params, fc, config, max_steps,
            shadow_lut_radius=shadow_lut_radius, march_cell=march_cell,
            light_step=light_step, trace=trace)
        return (RenderState(accumulate(accum, frame, fc), fc),
                photon.empty_lights(config, grid.device), trace.host_reads)
    lights = photon.generate_lights(grid, params, [fc], config,
                                    max_steps=max_steps)
    frame = color_mod.render_frame(grid, params, lights, algorithm, config,
                                   max_steps)
    return RenderState(accumulate(accum, frame, fc), fc), lights


def build_view_step(grid: DenseGrid, params: RenderParams, clip_box=None,
                    row_start: int = 0, *, config: StaticConfig,
                    max_steps: int, num_rows: int | None = None,
                    occupied_cap: int | None = None, march_cell: int = 8):
    """Bake the per-view march in slots layout (render.color.build_view)
    once per camera/volume/step change; reused by every cached frame."""
    return color_mod.build_view(
        grid, params, config, max_steps, row_start, num_rows,
        clip_box=clip_box, occupied_cap=occupied_cap, march_cell=march_cell)


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
    return RenderState(accumulate(accum, frame, fc), fc), lights


def render_steps_cached(grid: DenseGrid, params: RenderParams,
                        state: RenderState, view, *,
                        algorithm: Algorithm, config: StaticConfig,
                        max_steps: int, n_frames: int):
    """``n_frames`` frames over a baked view.

    The photon walks of all frames run first, as one walk of n_frames x 16
    photons.  Over a ViewCache each frame then shades and accumulates in
    image space.  Over a CompactView each frame updates only the (Rc,)
    lane vector; one expansion to the image runs at the end, where the miss pixels'
    average over n all-zero frames collapses to a scale by m / (m + n)."""
    m = state.frame_count
    fcs = [m + 1 + i for i in range(n_frames)]
    lights = photon.generate_lights(grid, params, fcs, config,
                                    max_steps=max_steps)
    if isinstance(view, color_mod.ViewCache):
        accum = state.accum
        for i, fc in enumerate(fcs):
            frame = color_mod.shade_view(grid, view, params, lights,
                                         algorithm, config, frame=i)
            if fc == 1:
                accum = torch.zeros_like(accum)
            accum = accumulate(accum, frame, fc)
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
    fc_end = m + n_frames
    factor = 0.0 if m == 0 else float(np.float32(m) / np.float32(fc_end))
    expanded = color_mod.expand_compact_colors(accum_c, view)
    hit = (view.inv_map < view.src.shape[0])[: view.n_rays]
    new_flat = torch.where(hit, expanded, accum_flat * factor)
    return RenderState(new_flat.reshape(state.accum.shape), fc_end), lights


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
    Returns (new_state, lights, host_reads)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    trace = path_mod.PathTrace()
    frame = path_mod.render_frame(
        grid, params, fc, config, max_steps,
        shadow_lut_radius=shadow_lut_radius, cache=cache,
        march_cell=march_cell, light_step=light_step, trace=trace)
    return (RenderState(accumulate(accum, frame, fc), fc),
            photon.empty_lights(config, grid.device), trace.host_reads)


def render_path_steps_cached(grid: DenseGrid, params: RenderParams,
                             state: RenderState, cache, *,
                             config: StaticConfig, max_steps: int,
                             n_frames: int, shadow_lut_radius: int = 0,
                             march_cell: int = 1, light_step=None):
    """``n_frames`` PATH frames over a baked PathView with their scatter
    segments walked together (render.path.render_frames), accumulated
    frame by frame in order: identical to n_frames single steps.
    Returns (new_state, lights, host_reads)."""
    m = state.frame_count
    fcs = [m + 1 + i for i in range(n_frames)]
    trace = path_mod.PathTrace()
    frames = path_mod.render_frames(
        grid, params, fcs, config, max_steps, cache,
        shadow_lut_radius=shadow_lut_radius, march_cell=march_cell,
        light_step=light_step, trace=trace)
    accum = state.accum
    for i, fc in enumerate(fcs):
        if fc == 1:
            accum = torch.zeros_like(accum)
        accum = accumulate(accum, frames[i], fc)
    return (RenderState(accum, m + n_frames),
            photon.empty_lights(config, grid.device), trace.host_reads)
