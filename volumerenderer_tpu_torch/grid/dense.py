"""Bricked dense density volume (twin of volumerenderer_tpu.grid.dense).

  * ``voxels``        (nx, ny, nz) f32 covering the bbox, padded up to the
                      brick size; voxel (i, j, k) in index space lives at
                      ``voxels[i - bx, j - by, k - bz]``.
  * ``brick_occ``     (nx/8, ny/8, nz/8) bool: any voxel in the brick > 0.
  * ``brick_max``     per-brick max density.
  * ``brick_occ_dil`` the 3^3 dilation of ``brick_occ``.
  * affine map        (3, 3) matrix + translation (NanoVDB map semantics).

Out-of-bbox lookups return 0.0.  On a GPU a plain indexed load does what
the reference package's fetch formulations do, so ``sample_nearest`` is
one flat load, ``sample_trilinear`` eight, and the brick tables are plain
bool-table indexes.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..utils import profiling
from . import transforms

BRICK = 8


@dataclass
class DenseGrid:
    voxels: torch.Tensor  # (nx, ny, nz) f32, padded to multiples of BRICK
    bbox_min: torch.Tensor  # (3,) i64, inclusive, index space
    bbox_max: torch.Tensor  # (3,) i64, inclusive, index space
    map_mat: torch.Tensor  # (3, 3) f32 index -> world
    map_inv: torch.Tensor  # (3, 3) f32 world -> index
    map_vec: torch.Tensor  # (3,) f32 translation
    brick_occ: torch.Tensor  # (nbx, nby, nbz) bool
    brick_max: torch.Tensor  # (nbx, nby, nbz) f32
    brick_occ_dil: torch.Tensor  # (nbx, nby, nbz) bool, 3^3 dilation of occ

    @property
    def device(self) -> torch.device:
        return self.voxels.device

    def world_to_index(self, p):
        return transforms.world_to_index(self.map_inv, self.map_vec, p)

    def index_to_world(self, p):
        return transforms.index_to_world(self.map_mat, self.map_vec, p)

    def world_to_index_dir(self, d):
        return transforms.world_to_index_dir(self.map_inv, d)

    # bbox corners as floats, reference convention boxMax = max + 1
    @property
    def box_min_f(self):
        return self.bbox_min.to(torch.float32)

    @property
    def box_max_f(self):
        return (self.bbox_max + 1).to(torch.float32)

    def _rel(self, pos):
        """floor(pos) relative to the bbox corner, (..., 3) int64."""
        return torch.floor(pos).to(torch.int64) - self.bbox_min

    def _inside(self, rel, margin: int = 0):
        """(...) bool: rel within the volume grown by ``margin`` per side."""
        ok = torch.all(rel >= -margin, dim=-1)
        for a, n in enumerate(self.voxels.shape):
            ok = ok & (rel[..., a] < n + margin)
        return ok

    def _clamp(self, rel):
        return torch.stack(
            [torch.clamp(rel[..., a], 0, n - 1)
             for a, n in enumerate(self.voxels.shape)], dim=-1,
        )

    def _fetch(self, rel):
        """Voxel values at ``rel`` (..., 3) int64 relative to the bbox
        corner; 0 outside the volume."""
        relc = self._clamp(rel)
        _, ny, nz = self.voxels.shape
        lin = (relc[..., 0] * ny + relc[..., 1]) * nz + relc[..., 2]
        return torch.where(self._inside(rel), self.voxels.reshape(-1)[lin], 0.0)

    def sample_nearest(self, pos):
        """Nearest-voxel fetch at floor(pos) for float index-space
        positions (..., 3); out-of-bbox returns 0."""
        return self._fetch(self._rel(pos))

    def sample_trilinear(self, pos):
        """Trilinear interpolation at float index-space positions (..., 3),
        voxel centres at integer + 0.5: 8 nearest fetches, 0 outside the
        bbox.  The taps, the weight products and the sum run in the
        reference package's order (dx, dy, dz), so the sums round alike."""
        p = pos - 0.5
        p0 = torch.floor(p)
        f = p - p0
        rel0 = p0.to(torch.int64) - self.bbox_min
        # Tap k's offset (dx, dy, dz) = the bits of k, made on the device (a
        # tensor from a host list would be a blocking copy per tap).
        k = torch.arange(8, device=pos.device)
        offs = torch.stack([k >> 2, (k >> 1) & 1, k & 1], dim=-1)
        acc = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = ((f[..., 0] if dx else 1.0 - f[..., 0])
                         * (f[..., 1] if dy else 1.0 - f[..., 1])
                         * (f[..., 2] if dz else 1.0 - f[..., 2]))
                    off = offs[4 * dx + 2 * dy + dz]
                    acc = acc + w * self._fetch(rel0 + off)
        return acc

    def brick_occupancy_dilated_at(self, pos):
        """1-brick-dilated occupancy at float index positions (..., 3).

        True iff floor(pos)'s brick or any 3^3 neighbour is occupied.
        Out-of-volume positions within one brick of the volume read the
        nearest boundary brick (a conservative superset)."""
        rel = self._rel(pos)
        relb = self._clamp(rel) // BRICK
        occ = self.brick_occ_dil[relb[..., 0], relb[..., 1], relb[..., 2]]
        return occ & self._inside(rel, BRICK)

    def to(self, device) -> "DenseGrid":
        return DenseGrid(**{
            f.name: getattr(self, f.name).to(device) for f in fields(self)
        })


def occupied_bbox(grid: DenseGrid):
    """Index-space AABB of the occupied bricks (host-side): (min corner,
    max corner exclusive) as f32 numpy arrays, or None for an empty volume.
    Marches clipped to it are bit-identical to full-bbox marches."""
    profiling.count("sync", "grid.occupied")
    occ = grid.brick_occ.cpu().numpy()
    if not occ.any():
        return None
    idx = np.argwhere(occ)
    lo = idx.min(axis=0) * BRICK
    hi = (idx.max(axis=0) + 1) * BRICK
    profiling.count("sync", "grid.occupied")
    bmin = grid.bbox_min.cpu().numpy()
    return (bmin + lo).astype(np.float32), (bmin + hi).astype(np.float32)


def _pad_to_brick(a: np.ndarray) -> np.ndarray:
    pads = [(0, (-s) % BRICK) for s in a.shape]
    if any(p[1] for p in pads):
        a = np.pad(a, pads)
    return a


def brick_tables(padded: np.ndarray):
    """(brick_max, occ, 3^3-dilated occ) of a brick-padded volume."""
    nb = tuple(s // BRICK for s in padded.shape)
    bricks = padded.reshape(nb[0], BRICK, nb[1], BRICK, nb[2], BRICK)
    brick_max = bricks.max(axis=(1, 3, 5)).astype(np.float32)
    occ = brick_max > 0.0
    dil = occ.copy()
    for axis in range(3):
        shifted_f = np.zeros_like(dil)
        shifted_b = np.zeros_like(dil)
        sl = [slice(None)] * 3
        sf = [slice(None)] * 3
        sl[axis], sf[axis] = slice(1, None), slice(None, -1)
        shifted_f[tuple(sl)] = dil[tuple(sf)]
        shifted_b[tuple(sf)] = dil[tuple(sl)]
        dil = dil | shifted_f | shifted_b
    return brick_max, occ, dil


def check_device(device, caller: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises
    naming ``caller``'s ``device`` argument (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}(device={device!r}): CUDA is not available; pass "
            "device='cpu' to build on the CPU")
    return dev


def from_dense(
    values: np.ndarray,
    bbox_min=(0, 0, 0),
    voxel_size: float = 1.0,
    translation=(0.0, 0.0, 0.0),
    map_mat: np.ndarray | None = None,
    *,
    device="cuda",
) -> DenseGrid:
    """Build a DenseGrid on ``device`` (the GPU unless asked for the CPU)
    from a dense numpy density array.

    ``values[i, j, k]`` is the density at index ``bbox_min + (i, j, k)``.
    The map defaults to uniform ``voxel_size`` scaling plus
    ``translation``."""
    device = check_device(device, "from_dense")
    return upload(bricked(values, bbox_min, voxel_size, translation,
                          map_mat), device)


def bricked(values: np.ndarray, bbox_min=(0, 0, 0), voxel_size: float = 1.0,
            translation=(0.0, 0.0, 0.0),
            map_mat: np.ndarray | None = None) -> dict:
    """``from_dense``'s host half: every field of the DenseGrid as a numpy
    array (the voxels padded to bricks, the brick tables, the map)."""
    values = np.ascontiguousarray(values, np.float32)
    if values.ndim != 3:
        raise ValueError(f"expected 3-D density array, got shape {values.shape}")
    bbox_min = np.asarray(bbox_min, np.int64)
    bbox_max = bbox_min + np.asarray(values.shape, np.int64) - 1
    padded = _pad_to_brick(values)
    brick_max, occ, dil = brick_tables(padded)
    if map_mat is None:
        map_mat = np.eye(3, dtype=np.float32) * np.float32(voxel_size)
    map_mat = np.asarray(map_mat, np.float32)
    return dict(
        voxels=padded, bbox_min=bbox_min, bbox_max=bbox_max,
        map_mat=map_mat, map_inv=np.linalg.inv(map_mat).astype(np.float32),
        map_vec=np.asarray(translation, np.float32), brick_occ=occ,
        brick_max=brick_max, brick_occ_dil=dil)


def upload(host: dict, device) -> DenseGrid:
    """``from_dense``'s copies: ``bricked``'s arrays to ``device``."""
    return DenseGrid(**{k: torch.as_tensor(np.ascontiguousarray(a),
                                           device=device)
                        for k, a in host.items()})
