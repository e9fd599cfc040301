"""Shared set-up of the benchmark's CPU tests: the harness's modules on the
path, one CPU thread, and the cells shrunk to a size a CPU run holds (the
image and the volume made small), run from the repository root."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# Several test processes share the CPU: one thread each keeps the many
# small operations of a walk from waiting on each other's threads.
torch.set_num_threads(1)

CELLS = ("bunny-ray-converge", "cloud96-point-converge", "cloud96-ray-drag",
         "cloud96-path-converge")
SEED = 2**31 + 12345


def small(cell: str, width: int = 64, height: int = 64) -> dict:
    """Overrides that shrink a cell's configuration for the CPU."""
    ov = {"width": width, "height": height}
    if cell.startswith("bunny"):
        ov["volume"] = {"shape": [40, 36, 32], "bbox_min": [-20, -18, -16],
                        "voxel_size": 1.0}
    else:
        ov["volume"] = {"n": 40}
    return ov


def run_small(cell: str, seed: int = SEED, seconds: float = 0.5,
              traced: bool = False, **kw):
    import harness

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return harness.run_cell(cell, seed, seconds, traced, device="cpu",
                                overrides=small(cell, **kw),
                                log=lambda s: None)
    finally:
        os.chdir(cwd)
