"""The benchmark's own volume generators, frozen: each makes a density array
from a seed.  The program's procedural module may change; these do not.

A configuration's ``volume.generator`` names a module of this package,
``volumes/<generator>.py``, whose ``generate(spec, seed, device)`` returns a
float32 array on ``device`` (a numpy array or a torch tensor), which the
harness hands to the program and to the reference alike.
"""

from __future__ import annotations

import importlib

import numpy as np


def rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(int(seed) & 0xFFFFFFFF)


def generate(spec: dict, seed: int, device):
    mod = importlib.import_module(f"volumes.{spec['generator']}")
    return mod.generate(spec, seed, device)
