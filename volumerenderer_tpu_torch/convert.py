"""Carry state across from the reference package without importing it.

``grid_from_numpy``, ``params_from_numpy``, ``lights_from_numpy``,
``view_cache_from_numpy``, ``compact_view_from_numpy`` and
``path_view_from_numpy`` take the fields of the reference package's
``DenseGrid``, ``RenderParams``, ``LightArray``, ``ViewCache``,
``CompactView`` and ``PathView`` — as an object with those attributes (the
reference objects themselves work, their arrays convert through
``np.asarray``) or as a dict — and build the port's objects on ``device``
(the CPU unless asked), so that both packages compute the same frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.params import RenderParams
from .grid.dense import DenseGrid
from .render.color import CompactView, PlaneBand, ViewCache
from .render.path import PathView
from .render.photon import LightArray

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


_LIGHT_DTYPES = {
    "pos_from": np.float32,
    "pos_to": np.float32,
    "intensity": np.float32,
    "valid": np.bool_,
    "count": np.int32,
    "truncated": np.bool_,
}


def lights_from_numpy(src, device="cpu") -> LightArray:
    """LightArray on ``device`` from the reference lights' fields.  One
    frame's lights (``count`` a scalar) gain the port's leading frame axis;
    a batch (leading axis F) keeps it."""
    arrays = {name: np.array(_get(src, name), dtype)
              for name, dtype in _LIGHT_DTYPES.items()}
    if arrays["count"].ndim == 0:
        arrays = {name: a[None] for name, a in arrays.items()}
    return LightArray(**{name: torch.as_tensor(a, device=device)
                         for name, a in arrays.items()})


def _f32(src, name, device):
    return torch.as_tensor(np.array(_get(src, name), np.float32),
                           device=device)


def view_cache_from_numpy(src, device="cpu") -> ViewCache:
    """ViewCache (slots layout) from the reference view's (R, C) planes."""
    return ViewCache(
        **{n: _f32(src, n, device) for n in ("wx", "wy", "wz", "weight")},
        n_rays=int(_get(src, "n_rays")), rows=int(_get(src, "rows")))


def compact_view_from_numpy(src, device="cpu") -> CompactView:
    """CompactView from the reference view's bands and index maps."""
    bands = tuple(
        PlaneBand(**{n: _f32(b, n, device)
                     for n in ("wx", "wy", "wz", "weight")},
                  lane_need=torch.as_tensor(
                      np.array(_get(b, "lane_need"), np.int32),
                      device=device))
        for b in _get(src, "bands"))
    idx = {n: torch.as_tensor(np.array(_get(src, n), np.int32),
                              device=device) for n in ("inv_map", "src")}
    return CompactView(bands=bands, n_rays=int(_get(src, "n_rays")),
                       rows=int(_get(src, "rows")), **idx)


_PATH_VIEW_DTYPES = {
    "o_i": np.float32,
    "d_i": np.float32,
    "tmin": np.float32,
    "tmax": np.float32,
    "live": np.bool_,
    "rank_k": np.int16,
    "n_occ": np.int16,
    "rank_prefix": np.float32,
    "prefix_total": np.float32,
}


def path_view_from_numpy(src, device="cpu") -> PathView:
    """PathView from the reference view's planes (its uint16 sample
    indices and roll-site counts, at most 2,500, become int16)."""
    return PathView(**{
        name: torch.as_tensor(np.array(_get(src, name)).astype(dtype),
                              device=device)
        for name, dtype in _PATH_VIEW_DTYPES.items()
    })
