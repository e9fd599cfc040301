"""World <-> index affine transforms (twin of volumerenderer_tpu.grid.transforms).

The transform is a (3, 3) matrix plus a translation, with the NanoVDB map
semantics: ``index_to_world(p) = mat @ p + vec`` and
``world_to_index(p) = inv @ (p - vec)``.
"""

from __future__ import annotations

import torch


def _matvec3(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(3, 3) @ (..., 3) as explicit elementwise multiply-adds.

    Kept elementwise (no matmul) so every product and sum rounds once in
    f32, in the same order as the reference package."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        dim=-1,
    )


def index_to_world(mat, vec, p):
    """p: (..., 3) index-space position -> world space."""
    return _matvec3(mat, p) + vec


def world_to_index(inv_mat, vec, p):
    """p: (..., 3) world-space position -> index space."""
    return _matvec3(inv_mat, p - vec)


def world_to_index_dir(inv_mat, d):
    """d: (..., 3) world-space direction -> index space (unnormalized)."""
    return _matvec3(inv_mat, d)
