"""Baked march planes: CUDA kernel wrapper and plain version.

A ray set (index-space origins and unit directions, (N, 3) each) is
marched (ops.march) and baked into four f32 planes of world-space sample
positions and gather weights (wx, wy, wz, w): (4, C, N) lane-major
(``lanes``) or (4, N, C) row-major (the slots layout).

``march_planes_reference`` is the plain version: ``ops.march.march`` tile
by tile, each tile's positions taken to world space and written into its
columns (lanes) or rows (slots) of the planes, so that no transposed copy
is made.  Besides the kernel's march it serves every march the kernel does
not take: the brick-skipping march (``occupied_cap``), trilinear sampling,
and top-k compaction to ``gather_samples`` (``top_k_samples``).

``plan`` is the one rule for which march a call is: brick-gated or not,
the samples marched and kept, and whether the kernel takes it.
``march_planes`` takes the kernel's subset: nearest sampling, no brick
gate, every sample kept (C = ``max_steps``).  For CUDA tensors it launches
csrc/march_planes.cu, one launch for every ray, and counts it in
``launches["march"]``; for CPU tensors it runs the plain version.  It never
sends a CUDA tensor to the plain version.  The kernel keeps the plain
version's rounding term for term but for the transmittance, a running
product where the plain version takes torch.cumprod (another association).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import march as march_ops

launches = {"march": 0}  # kernel launches made by march_planes


def top_k_samples(weight: torch.Tensor, t: torch.Tensor, k: int):
    """Each row's ``k`` largest weights and the march distances that go
    with them, (N, k) each, in the order of a stable descending sort:
    equal weights keep ascending sample order, as ``jax.lax.top_k``."""
    w, idx = torch.sort(weight, dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    return w[:, :k], torch.gather(t, -1, idx)


def brick_gated(interpolation: str, cell: int) -> bool:
    """Whether a march at ``cell`` reads the brick occupancy: nearest
    sampling at a coarse cell above 1."""
    return interpolation == "nearest" and cell > 1


class MarchPlan(NamedTuple):
    """Which march a call is: ``gated`` (the brick-skipping march),
    ``samples`` marched a ray (S), ``kept`` a ray in the planes (C), and
    ``kernel``: the kernel's subset (nearest, not gated, C = S)."""

    gated: bool
    samples: int
    kept: int
    kernel: bool


def plan(interpolation: str, cell: int, occupied_cap: int | None,
         gather_samples: int, max_steps: int) -> MarchPlan:
    """The march of a call: brick-gated with an ``occupied_cap`` where
    ``brick_gated``, at whole cells of samples; top-k to
    ``gather_samples`` where that is below the samples marched."""
    gated = occupied_cap is not None and brick_gated(interpolation, cell)
    if gated:
        n_cells = -(-max_steps // cell)
        kc = min(max(1, -(-min(occupied_cap, max_steps) // cell)), n_cells)
        S = kc * cell
    else:
        S = max_steps
    C = gather_samples if gather_samples and gather_samples < S else S
    return MarchPlan(gated, S, C,
                     interpolation == "nearest" and not gated and C == S)


def march_planes_reference(grid, o_i, d_i, *, ray_max_distance: float,
                           step_size: float, absorption: float,
                           max_steps: int, lanes: bool, clip_box=None,
                           interpolation: str = "nearest",
                           occupied_cap: int | None = None, cell: int = 8,
                           gather_samples: int = 0,
                           tile: int = 65536) -> torch.Tensor:
    """The plain version: (4, C, N) planes (``lanes``) or (4, N, C), in
    tiles of at most ``tile`` rays.  ``occupied_cap`` (with nearest
    sampling and ``cell`` > 1) marches the brick-skipping march at that
    cap; ``gather_samples`` below the march's samples keeps each ray's
    largest weights (``top_k_samples``), C = ``gather_samples``."""
    n_rays = o_i.shape[0]
    gated, S, C, _ = plan(interpolation, cell, occupied_cap, gather_samples,
                          max_steps)
    # Memory guard: march temporaries are ~40 B per (ray, sample).
    tile_mem_bound = max(1024, ((3 << 29) // max(S * 40, 1)) // 1024 * 1024)
    tile = max(1, min(tile, tile_mem_bound, n_rays))
    dev = o_i.device
    shape = (4, C, n_rays) if lanes else (4, n_rays, C)
    planes = torch.empty(shape, dtype=torch.float32, device=dev)
    mm = grid.map_mat
    mv = grid.map_vec
    for a in range(0, n_rays, tile):
        b = min(a + tile, n_rays)
        o, d = o_i[a:b], d_i[a:b]
        m = march_ops.march(
            grid, o, d, ray_max_distance=ray_max_distance,
            step_size=step_size, absorption=absorption, max_steps=max_steps,
            interpolation=interpolation, clip_box=clip_box,
            occupied_cap=occupied_cap if gated else None, cell=cell,
        )
        w, t = m.weight, m.t
        if C < S:
            w, t = top_k_samples(w, t, C)
        ix = o[:, 0:1] + d[:, 0:1] * t
        iy = o[:, 1:2] + d[:, 1:2] * t
        iz = o[:, 2:3] + d[:, 2:3] * t
        for i in range(3):
            v = mm[i, 0] * ix + mm[i, 1] * iy + mm[i, 2] * iz + mv[i]
            if lanes:
                planes[i, :, a:b] = v.T
            else:
                planes[i, a:b] = v
        if lanes:
            planes[3, :, a:b] = w.T
        else:
            planes[3, a:b] = w
    return planes


def _check(grid, o_i, d_i, clip_box):
    """Validate what the kernel takes."""
    dev = o_i.device
    n = o_i.shape[0] if o_i.dim() == 2 else -1
    need = [("o_i", o_i, (n, 3), torch.float32),
            ("d_i", d_i, (n, 3), torch.float32),
            ("voxels", grid.voxels, tuple(grid.voxels.shape), torch.float32),
            ("bbox_min", grid.bbox_min, (3,), torch.int64),
            ("bbox_max", grid.bbox_max, (3,), torch.int64),
            ("map_mat", grid.map_mat, (3, 3), torch.float32),
            ("map_vec", grid.map_vec, (3,), torch.float32)]
    if clip_box is not None:
        need += [("clip_box[0]", clip_box[0], (3,), torch.float32),
                 ("clip_box[1]", clip_box[1], (3,), torch.float32)]
    for name, t, want, dtype in need:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if grid.voxels.dim() != 3:
        raise ValueError("voxels must be (nx, ny, nz)")
    if dev.type == "cuda":
        for name, t in (("o_i", o_i), ("d_i", d_i)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned (the "
                                 "kernel stages rays with 16-byte loads)")
    if max(grid.voxels.shape) >= 2**31:
        raise ValueError("march_planes: a volume axis exceeds int32")


def _lib():
    from ._build import library

    lib = library("march_planes")
    if not getattr(lib, "_vr_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vr_march_planes.argtypes = ([p] * 9 + [i, i, i, f, f, f, f, i,
                                                   ctypes.c_longlong, i, p, p])
        lib.vr_march_planes.restype = i
        lib.vr_march_error_string.argtypes = [i]
        lib.vr_march_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def march_planes(grid, o_i, d_i, *, ray_max_distance: float,
                 step_size: float, absorption: float, max_steps: int,
                 lanes: bool, clip_box=None, tile: int = 65536
                 ) -> torch.Tensor:
    """The ungated nearest march of every ray, every sample kept: (4, S, N)
    planes (``lanes``) or (4, N, S), S = ``max_steps``.  ``clip_box``:
    (lo, hi) f32 tensors on the rays' device; ``tile``: the plain
    version's rays a tile (CPU)."""
    _check(grid, o_i, d_i, clip_box)
    if o_i.device.type == "cpu":
        return march_planes_reference(
            grid, o_i, d_i, ray_max_distance=ray_max_distance,
            step_size=step_size, absorption=absorption, max_steps=max_steps,
            lanes=lanes, clip_box=clip_box, tile=tile)
    if o_i.device.type != "cuda":
        raise ValueError(f"march_planes: unsupported device {o_i.device}")
    if not 1 <= max_steps < 2**31:
        raise ValueError(f"march_planes: max_steps {max_steps} out of range")
    dev = o_i.device
    n = o_i.shape[0]
    shape = (4, max_steps, n) if lanes else (4, n, max_steps)
    planes = torch.empty(shape, dtype=torch.float32, device=dev)
    if not n:
        return planes
    if planes.data_ptr() % 16:
        raise ValueError("march_planes: the planes are not 16-byte aligned")
    lo, hi = clip_box if clip_box is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    nx, ny, nz = grid.voxels.shape
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_march_planes(
            o_i.data_ptr(), d_i.data_ptr(), grid.voxels.data_ptr(),
            grid.bbox_min.data_ptr(), grid.bbox_max.data_ptr(),
            grid.map_mat.data_ptr(), grid.map_vec.data_ptr(), ptr(lo),
            ptr(hi), nx, ny, nz, ray_max_distance, step_size, absorption,
            march_ops.f32mul(march_ops.ENTRY_EPS, step_size), max_steps, n,
            0 if lanes else 1, planes.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.vr_march_error_string(err).decode()
        raise RuntimeError(f"march_planes kernel launch failed: {msg} ({err})")
    launches["march"] += 1
    return planes
