"""Checkpoint and resume of render sessions (twin of
volumerenderer_tpu.io.checkpoint, same .npz keys, so a checkpoint written
by either package loads in the other).

The reference has none: its accumulated image lives on the GPU and is lost
on resize (src/main.cpp:936-937).  Saving the accumulation buffer, frame
counter, algorithm and parameters lets a progressive render continue where
it stopped, bit for bit: the photon RNG is a pure function of the frame
counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import params_from_numpy
from ..engine.params import Algorithm, RenderParams
from ..engine.session import Renderer
from ..engine.state import RenderState


def _param_array(v) -> np.ndarray:
    """A parameter as the reference package stores it: f32 arrays, and
    ``max_lights`` as int32."""
    if isinstance(v, int):
        return np.int32(v)
    return np.asarray(v, np.float32)


def save(renderer: Renderer, path: str) -> None:
    """Save the session's state to ``path`` (.npz)."""
    params = {f"param_{f.name}": _param_array(getattr(renderer.params, f.name))
              for f in dataclasses.fields(RenderParams)}
    np.savez_compressed(
        path,
        accum=renderer.state.accum.cpu().numpy(),
        frame_count=np.int32(renderer.state.frame_count),
        algorithm=np.int32(int(renderer.algorithm)),
        **params,
    )


def load(renderer: Renderer, path: str) -> Renderer:
    """Restore the state, parameters and algorithm into an existing
    session whose image size matches the checkpoint's (else ValueError)."""
    with np.load(path) as z:
        accum = z["accum"]
        if accum.shape != (renderer.config.height, renderer.config.width):
            raise ValueError(
                f"checkpoint image {accum.shape} != config "
                f"{(renderer.config.height, renderer.config.width)}")
        renderer.state = RenderState(
            accum=torch.as_tensor(np.asarray(accum, np.float32),
                                  device=renderer.device),
            frame_count=int(z["frame_count"]))
        renderer.algorithm = Algorithm(int(z["algorithm"]))
        renderer.params = params_from_numpy(
            {k[len("param_"):]: z[k] for k in z.files
             if k.startswith("param_")})
    return renderer
