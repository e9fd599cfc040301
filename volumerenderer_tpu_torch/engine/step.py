"""Per-frame render steps over a cached compact view (twin of the cached
steps of volumerenderer_tpu.engine.step).

A frame is: frameCount++, clear on frame 1, photon-walk light generation,
shading of the baked view, progressive accumulation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.dense import DenseGrid
from ..render import color as color_mod
from ..render import photon
from .params import Algorithm, RenderParams, StaticConfig
from .state import RenderState, accumulate


def render_step_cached(grid: DenseGrid, params: RenderParams,
                       state: RenderState, view: color_mod.CompactView, *,
                       algorithm: Algorithm, config: StaticConfig,
                       max_steps: int):
    """One frame in image space: returns (new_state, lights)."""
    fc = state.frame_count + 1
    accum = torch.zeros_like(state.accum) if fc == 1 else state.accum
    lights = photon.generate_lights(grid, params, [fc], config,
                                    max_steps=max_steps)
    frame = color_mod.shade_view(grid, view, params, lights, algorithm, config)
    return RenderState(accumulate(accum, frame, fc), fc), lights


def render_steps_cached(grid: DenseGrid, params: RenderParams,
                        state: RenderState, view: color_mod.CompactView, *,
                        algorithm: Algorithm, config: StaticConfig,
                        max_steps: int, n_frames: int):
    """``n_frames`` frames accumulated in compact space.

    The photon walks of all frames run first, as one walk of n_frames x 16
    photons.  Each frame then updates only the (Rc,) lane vector; one
    expansion to the image runs at the end, where the miss pixels'
    average over n all-zero frames collapses to a scale by m / (m + n)."""
    m = state.frame_count
    fcs = [m + 1 + i for i in range(n_frames)]
    lights = photon.generate_lights(grid, params, fcs, config,
                                    max_steps=max_steps)
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
