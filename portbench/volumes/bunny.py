"""``bunny``: the bunny-class fog of ``scripts/make_asset.py`` (a union of
soft ellipsoids, a thin shell, three octaves of value noise, densities
under 0.02 cut to 0), computed on the card in slabs."""

from __future__ import annotations

import numpy as np
import torch

from volumes import rng as _rng

_BLOBS = ((0, -0.25, 0, 0.62, 0.5, 0.55), (0.05, 0.32, 0.12, 0.34, 0.3, 0.3),
          (-0.12, 0.72, 0.1, 0.1, 0.32, 0.12), (0.2, 0.74, 0.1, 0.1, 0.34, 0.12))


def generate(spec: dict, seed: int, device) -> torch.Tensor:
    shape = tuple(int(s) for s in spec["shape"])
    rng = _rng(seed)
    scales = [6 * 2 ** o for o in range(3)]
    tables = [torch.as_tensor(rng.rand(s + 1, s + 1, s + 1).astype(np.float32),
                              device=device) for s in scales]
    f32 = torch.float32
    lx, ly, lz = (torch.linspace(-1, 1, k, dtype=f32, device=device)
                  for k in shape)
    slab = max(1, (1 << 23) // (shape[1] * shape[2]))

    def slab_parts(i0, i1):
        x, y, z = torch.meshgrid(lx[i0:i1], ly, lz, indexing="ij")
        d = torch.full(x.shape, 1e9, dtype=f32, device=device)
        for cx, cy, cz, rx, ry, rz in _BLOBS:
            d = torch.minimum(d, torch.sqrt(((x - cx) / rx) ** 2
                                            + ((y - cy) / ry) ** 2
                                            + ((z - cz) / rz) ** 2) - 1.0)
        noise = torch.zeros_like(x)
        for octave, (s, g) in enumerate(zip(scales, tables)):
            xi = torch.clamp((x * 0.5 + 0.5) * s, 0, s - 1e-3)
            yi = torch.clamp((y * 0.5 + 0.5) * s, 0, s - 1e-3)
            zi = torch.clamp((z * 0.5 + 0.5) * s, 0, s - 1e-3)
            x0, y0, z0 = xi.long(), yi.long(), zi.long()
            fx, fy, fz = xi - x0, yi - y0, zi - z0
            v = torch.zeros_like(x)
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                             * (fz if dz else 1 - fz))
                        v = v + w * g[x0 + dx, y0 + dy, z0 + dz]
            noise = noise + v / 2 ** octave
        return d, noise

    parts = [slab_parts(i, min(shape[0], i + slab))
             for i in range(0, shape[0], slab)]
    peak = max(float(nz.max()) for _, nz in parts)
    out = torch.empty(shape, dtype=f32, device=device)
    i = 0
    for d, noise in parts:
        shell = torch.exp(-d.abs() * 6.0) * (d < 0.15)
        dense = shell * (0.25 + 0.75 * (noise / peak))
        out[i:i + d.shape[0]] = torch.where(dense < 0.02, 0.0, dense)
        i += d.shape[0]
    return out
