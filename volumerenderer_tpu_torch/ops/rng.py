"""Counter-based spatial-hash RNG, bit-exact with volumerenderer_tpu.ops.rng.

The reference hashes a ``uvec3`` seed with uint32 wraparound arithmetic.
PyTorch's uint32 support is partial, so values live in int64 tensors and
every add and multiply is masked back to 32 bits.  Products stay below
2**59 (a value under 2**32 times a constant under 2**27), so int64 never
overflows.  The hash -> f32 conversion converts the exact integer with
round-to-nearest-even, as numpy's and XLA's uint32 -> f32 do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling

_MASK = 0xFFFFFFFF

# f32 constant the shader uses: 1.0 / 4294967295.0 evaluated in float32.
_INV_U32_MAX = float(np.float32(1.0) / np.float32(4294967295.0))

_HX = 73856093
_HY = 19349663
_HZ = 83492791
_HM = 0x45D9F3B


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor/array/int -> int64 tensor holding uint32 values
    (on ``device``, when given, a copy from the host)."""
    if not isinstance(x, torch.Tensor):
        if device is not None:
            profiling.count("sync", "rng.upload")
        x = torch.as_tensor(np.asarray(x, np.int64), device=device)
    return x.to(torch.int64) & _MASK


def hash_uvec3(x, y, z) -> torch.Tensor:
    """Spatial hash + double xorshift-multiply; returns uint32 values in
    an int64 tensor."""
    x, y, z = as_u32(x), as_u32(y), as_u32(z)
    h = ((x * _HX) & _MASK) ^ ((y * _HY) & _MASK) ^ ((z * _HZ) & _MASK)
    h = ((h ^ (h >> 16)) * _HM) & _MASK
    h = ((h ^ (h >> 16)) * _HM) & _MASK
    return h ^ (h >> 16)


def randf(x, y, z) -> torch.Tensor:
    """float in [0, 1]: float(hash(seed)) / 4294967295."""
    return hash_uvec3(x, y, z).to(torch.float32) * _INV_U32_MAX


def randf_at(seed: torch.Tensor, k) -> torch.Tensor:
    """The value ``randf_inc`` returns on its ``k``-th call (1-indexed):
    call ``k`` hashes ``seed + (k, k, k)``.  ``seed`` is (..., 3)."""
    k = as_u32(k, seed.device)
    return randf(
        (seed[..., 0] + k) & _MASK,
        (seed[..., 1] + k) & _MASK,
        (seed[..., 2] + k) & _MASK,
    )


def make_seed(gid_x, gid_y, gid_z, frame_count) -> torch.Tensor:
    """Per-thread seed ``uvec3(gid) * frameCount`` with uint32 wraparound;
    broadcasts ``frame_count`` against the gids.  Returns (..., 3) int64."""
    fc = as_u32(frame_count)
    return torch.stack(
        [
            (as_u32(gid_x) * fc) & _MASK,
            (as_u32(gid_y) * fc) & _MASK,
            (as_u32(gid_z) * fc) & _MASK,
        ],
        dim=-1,
    )


def random_dir(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the sphere: theta = acos(1 - 2 r1),
    phi = 2 pi r2; returns (..., 3) float32, normalized like the reference."""
    theta = torch.arccos(torch.clamp(1.0 - 2.0 * r1, -1.0, 1.0))
    phi = float(np.float32(2.0 * math.pi)) * r2
    st = torch.sin(theta)
    d = torch.stack(
        [st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1
    )
    return d / norm3(d)


def norm3(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the trailing axis, keepdim."""
    return torch.linalg.vector_norm(d, dim=-1, keepdim=True)
