"""``cumulus``: a cumulus-class density field, computed on the device in
x-slabs.  A union of seeded spherical billows (a fixed central one, a main
body, towers on it, and small surface billows) over a flattened base, eroded
by four octaves of value noise at the billow scale, with a smooth falloff at
the edge and a dense core; densities normalised to a maximum of 1.0, values
under 0.02 set to 0.

Every step is elementwise (adds, multiplies, divisions, minima and maxima,
table lookups: no transcendental function), so a voxel's value does not
depend on the slab it is computed in.  Coordinates are in units of half the
box's height, centred on the box, so the cloud's shape and its share of the
box hold at any resolution of the same aspect."""

from __future__ import annotations

import numpy as np
import torch

from volumes import rng as _rng

F32 = torch.float32
BASE = -0.72  # the flat base's height
MARGIN = 0.03  # every billow stays this far inside the box
CENTRAL = (0.0, -0.16, 0.0, 0.78)  # x, y, z, radius
MAIN, TOWERS, DETAIL = 16, 16, 40
LAYOUT = 20  # the seed of the main body's and the towers' layout
OCTAVES, FREQ = 4, 3.0  # noise cells per unit at the first octave
EROSION = 0.10  # the noise's reach into a billow, in units
EDGE = 0.05  # the falloff's width at the edge
CORE = (0.02, 0.30)  # the depths over which the core's density ramps up
CUT = 0.02


def _half(shape):
    """The box's half extents in units of half its height."""
    ny = float(shape[1])
    return np.array([shape[0] / ny, 1.0, shape[2] / ny])


def _inside(c, r, half):
    lim = np.maximum(half - r - MARGIN, 0.0)
    return np.clip(c, -lim, lim)


def _axis_clear(c, r, front):
    """Whether a billow leaves the camera axis (x = y = 0, looking at +z)
    in front of ``front`` alone, so the central billow sets the surface the
    camera axis meets."""
    off = c[0] ** 2 + c[1] ** 2
    return off >= r * r or c[2] - np.sqrt(r * r - off) >= front


def billows(shape, seed: int) -> np.ndarray:
    """(n, 4) float64 rows of (x, y, z, radius).  The cloud's mass (the main
    body and its towers) is one fixed layout, as a production asset is one
    cloud; the seed places the small surface billows."""
    rng = _rng(LAYOUT)
    half = _half(shape)
    cx, cy, cz, cr = CENTRAL
    front = cz - np.sqrt(cr * cr - cx * cx - cy * cy)
    out = [np.array(CENTRAL)]

    def place(draw):
        while True:
            c, r = draw()
            c = _inside(c, r, half)
            if _axis_clear(c, r, front):
                out.append(np.array([*c, r]))
                return

    for _ in range(MAIN):
        place(lambda: (np.array([rng.uniform(-0.8, 0.8) * half[0],
                                 rng.uniform(-0.45, -0.12),
                                 rng.uniform(-0.7, 0.7) * half[2]]),
                       rng.uniform(0.55, 0.8)))
    body = list(out)
    for _ in range(TOWERS):
        def tower():
            p = body[rng.randint(len(body))]
            u = rng.normal(size=3)
            u[1] = abs(u[1]) + 0.8
            u /= np.linalg.norm(u)
            return p[:3] + u * p[3] * rng.uniform(0.45, 0.85), \
                rng.uniform(0.3, 0.5)
        place(tower)
    parents = list(out)
    rng = _rng(seed)
    for _ in range(DETAIL):
        def detail():
            p = parents[rng.randint(len(parents))]
            u = rng.normal(size=3)
            u[1] = abs(u[1]) * 0.7
            u /= np.linalg.norm(u)
            return p[:3] + u * p[3] * rng.uniform(0.8, 1.0), \
                rng.uniform(0.08, 0.18)
        place(detail)
    return np.stack(out)


def noise_tables(shape, seed: int):
    """One lattice of uniform values a noise octave, each covering the box."""
    rng = _rng(int(seed) ^ 0x5EED)
    half = _half(shape)
    tables = []
    for o in range(OCTAVES):
        f = FREQ * 2 ** o
        dims = tuple(int(np.ceil(2 * h * f)) + 2 for h in half)
        tables.append((f, rng.rand(*dims).astype(np.float32)))
    return tables


def _fade(t):
    return t * t * (3.0 - 2.0 * t)


def _noise(x, y, z, half, tables):
    """Four octaves of smoothed value noise, in [0, 1]."""
    total = torch.zeros_like(x)
    weight = 0.0
    for o, (f, g) in enumerate(tables):
        a = 0.5 ** o
        u = [(c + float(h)) * float(f) for c, h in zip((x, y, z), half)]
        i = [torch.floor(c) for c in u]
        t = [_fade(c - k) for c, k in zip(u, i)]
        ix = [k.long() for k in i]
        _, gy, gz = g.shape
        flat = g.reshape(-1)
        v = torch.zeros_like(x)
        for dx in (0, 1):
            wx = t[0] if dx else 1.0 - t[0]
            for dy in (0, 1):
                wy = t[1] if dy else 1.0 - t[1]
                for dz in (0, 1):
                    wz = t[2] if dz else 1.0 - t[2]
                    idx = ((ix[0] + dx) * gy + (ix[1] + dy)) * gz + ix[2] + dz
                    v = v + (wx * wy) * wz * flat[idx]
        total = total + a * v
        weight += a
    return total * float(1.0 / weight)


def _smooth(t):
    return _fade(torch.clamp(t, 0.0, 1.0))


def _slab(i0, i1, shape, half, balls, tables, device):
    """The unnormalised field of x-planes i0 .. i1."""
    ny = float(shape[1])
    ax = [(torch.arange(a, b, dtype=F32, device=device) + 0.5 - n / 2.0)
          / (ny / 2.0) for a, b, n in ((i0, i1, shape[0]), (0, shape[1],
                                                            shape[1]),
                                       (0, shape[2], shape[2]))]
    x, y, z = torch.meshgrid(*ax, indexing="ij")
    lo, hi = ((i + 0.5 - shape[0] / 2.0) / (ny / 2.0) for i in (i0, i1 - 1))
    depth = torch.full(x.shape, -1e9, dtype=F32, device=device)
    for bx, by, bz, r in balls:
        gap = max(lo - bx, bx - hi, 0.0)
        if gap > r + 1e-3:
            continue  # this billow reaches no voxel of the slab
        dx, dy, dz = x - float(bx), y - float(by), z - float(bz)
        d2 = dx * dx + dy * dy + dz * dz
        # (r^2 - d^2) / 2r: the depth below the billow's surface to first
        # order, with no square root.
        depth = torch.maximum(depth, (float(r * r) - d2) * float(0.5 / r))
    depth = torch.minimum(depth, y - BASE)
    n = _noise(x, y, z, half, tables)
    eroded = depth - EROSION * n
    core = 0.25 + 0.75 * _smooth((eroded - CORE[0]) / (CORE[1] - CORE[0]))
    return _smooth(eroded / EDGE) * core * (0.8 + 0.2 * n)


def generate(spec: dict, seed: int, device, slab_voxels: int = 1 << 23):
    shape = tuple(int(s) for s in spec["shape"])
    half = _half(shape)
    balls = billows(shape, seed)
    tables = [(f, torch.as_tensor(g, device=device))
              for f, g in noise_tables(shape, seed)]
    out = torch.empty(shape, dtype=F32, device=device)
    step = max(1, slab_voxels // (shape[1] * shape[2]))
    for i in range(0, shape[0], step):
        j = min(shape[0], i + step)
        out[i:j] = _slab(i, j, shape, half, balls, tables, device)
    out /= out.max()
    return out.masked_fill_(out < CUT, 0.0)
