"""volumerenderer_tpu_torch — the PyTorch/CUDA port of volumerenderer_tpu.

It covers the progressive Point/VPL and Sphere/VSL path with the cached
compact view: procedural grid -> camera rays -> occupancy-sorted lanes ->
brick-skipping march -> per frame, the photon walk and the lane gather (a
hand-written CUDA kernel on the GPU, its plain PyTorch version on the CPU)
-> accumulation in compact space.

    from volumerenderer_tpu_torch import Renderer, Algorithm, StaticConfig, grid

    g = grid.procedural.cloud(n=96, device="cuda")
    r = Renderer(g, StaticConfig(width=512, height=512),
                 algorithm=Algorithm.POINT, device="cuda")
    r.step(16)
    r.image()           # (H, W, 3) float in [0, 1]

This package imports PyTorch and never JAX.
"""

from . import grid
from .engine.params import Algorithm, RenderParams, StaticConfig
from .engine.session import Renderer

__all__ = ["Algorithm", "RenderParams", "Renderer", "StaticConfig", "grid"]
