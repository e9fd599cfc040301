"""Carry state across from the reference package without importing it.

``grid_from_numpy`` and ``params_from_numpy`` take the fields of the
reference package's ``DenseGrid`` and ``RenderParams`` — as an object with
those attributes (the reference objects themselves work, their arrays
convert through ``np.asarray``) or as a dict — and build the port's
objects on ``device``, so that both packages compute the same frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.params import RenderParams
from .grid.dense import DenseGrid

_GRID_DTYPES = {
    "voxels": np.float32,
    "bbox_min": np.int64,
    "bbox_max": np.int64,
    "map_mat": np.float32,
    "map_inv": np.float32,
    "map_vec": np.float32,
    "brick_occ": np.bool_,
    "brick_max": np.float32,
    "brick_occ_dil": np.bool_,
}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def grid_from_numpy(src, device="cpu") -> DenseGrid:
    """DenseGrid on ``device`` from the reference grid's fields."""
    return DenseGrid(**{
        name: torch.as_tensor(
            np.array(_get(src, name), dtype),
            device=device,
        )
        for name, dtype in _GRID_DTYPES.items()
    })


def params_from_numpy(src) -> RenderParams:
    """RenderParams from the reference params' fields (host values: the
    port's parameters live on the host and reach the device as scalars)."""
    return RenderParams(**{
        f.name: np.asarray(_get(src, f.name))
        for f in dataclasses.fields(RenderParams)
    })
