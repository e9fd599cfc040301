"""volumerenderer_tpu_torch — the PyTorch/CUDA port of volumerenderer_tpu.

It covers the progressive Point/VPL, Sphere/VSL, Ray/VRL and Beam/VBL
paths: the cached compact view (procedural grid -> camera rays ->
occupancy-sorted lanes -> brick-skipping march -> per frame, the photon
walk and a lane gather -> accumulation in compact space), the uncached
slots view (every ray's march, shaded per sample by the slot gathers), and
the interactive drag, settle and decimation paths.  The gathers are
hand-written CUDA kernels on the GPU and their plain PyTorch versions on
the CPU.

    from volumerenderer_tpu_torch import Renderer, Algorithm, StaticConfig, grid

    g = grid.procedural.cloud(n=96)      # on the GPU; device="cpu" to opt out
    r = Renderer(g, StaticConfig(width=512, height=512))
    r.step(16)          # Algorithm.RAY, the default
    r.image()           # (H, W, 3) float in [0, 1]

This package imports PyTorch and never JAX.
"""

import torch as _torch

# PyTorch's CPU kernels for exp, sqrt, atan, cos and the other
# transcendentals call MKL's vector math library.  When the first such call
# of a process runs on several threads at once, some threads can return
# results good to ~12 bits (measured: 3e-4 relative on a Xeon with AVX-512,
# PyTorch 2.13 for the CPU); later calls are exact to an ulp.  One call on
# one element initializes the library on this thread first.
_torch.exp(_torch.zeros(1))

from . import grid  # noqa: E402
from .engine.params import Algorithm, RenderParams, StaticConfig  # noqa: E402
from .engine.session import Renderer  # noqa: E402

__all__ = ["Algorithm", "RenderParams", "Renderer", "StaticConfig", "grid"]
