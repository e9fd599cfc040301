"""``cloud``: the puffy value-noise cloud of the port's
``grid.procedural.cloud`` (ellipsoid falloff times four octaves of
trilinearly upsampled lattice noise), on the host."""

from __future__ import annotations

import numpy as np

from volumes import rng as _rng


def generate(spec: dict, seed: int, device) -> np.ndarray:
    from scipy.ndimage import zoom

    n = int(spec["n"])
    octaves = int(spec.get("octaves", 4))
    rng = _rng(seed)
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
    d = d / max(d.max(), 1e-6) * float(spec.get("max_density", 1.0))
    return d.astype(np.float32)
