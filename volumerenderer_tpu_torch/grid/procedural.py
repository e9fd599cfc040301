"""Procedural test volumes (twin of volumerenderer_tpu.grid.procedural).

The numpy builders are copied so the port needs no JAX; the voxels are
bit-identical to the reference package's for the same arguments.  The
grids live on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from .dense import DenseGrid, check_device, from_dense


def fog_sphere(
    n: int = 64,
    radius_frac: float = 0.4,
    center_world=(0.0, 20.0, 20.0),
    world_extent: float = 60.0,
    max_density: float = 1.0,
    *,
    device="cuda",
) -> DenseGrid:
    """Soft-edged density sphere, akin to nanovdb's createFogVolumeSphere."""
    device = check_device(device, "fog_sphere")
    voxel = world_extent / n
    ax = (np.arange(n) + 0.5) / n - 0.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    d = np.clip((radius_frac - r) / (0.15 * radius_frac), 0.0, 1.0) * max_density
    translation = np.asarray(center_world, np.float64) - world_extent / 2.0
    return from_dense(
        d.astype(np.float32), voxel_size=voxel, translation=translation,
        device=device,
    )


def cloud(
    n: int = 96,
    seed: int = 7,
    center_world=(0.0, 20.0, 20.0),
    world_extent: float = 70.0,
    max_density: float = 1.0,
    octaves: int = 4,
    *,
    device="cuda",
) -> DenseGrid:
    """Puffy value-noise cloud: ellipsoid falloff x multi-octave noise,
    deterministic in ``seed``."""
    device = check_device(device, "cloud")
    from scipy.ndimage import zoom

    rng = np.random.RandomState(seed)
    ax = (np.arange(n) + 0.5) / n - 0.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt((x / 0.45) ** 2 + (y / 0.32) ** 2 + (z / 0.40) ** 2)
    base = np.clip(1.0 - r, 0.0, 1.0)

    noise = np.zeros((n, n, n), np.float32)
    amp, freq = 1.0, 4
    for _ in range(octaves):
        lattice = rng.rand(freq, freq, freq).astype(np.float32)
        up = zoom(lattice, n / freq, order=1, mode="nearest")[:n, :n, :n]
        noise += amp * up
        amp *= 0.5
        freq *= 2
    noise /= noise.max()
    d = np.clip(base * (noise * 1.4 - 0.25), 0.0, 1.0)
    d = (d / max(d.max(), 1e-6)) * max_density
    voxel = world_extent / n
    translation = np.asarray(center_world, np.float64) - world_extent / 2.0
    return from_dense(
        d.astype(np.float32), voxel_size=voxel, translation=translation,
        device=device,
    )
