"""Many-light point/sphere gather: CUDA kernel wrapper and plain version.

Twin of volumerenderer_tpu.ops.pallas.gather_kernel.gather_mxu, the gather
the reference package takes above SMEM_LIGHT_LIMIT light slots.  The planes
are any C-contiguous f32 arrays of one shape, read as one flat array of
samples; the lights are (L, 3) positions, (L,) intensities and an (L,)
per-slot validity (any pattern, not only a contiguous range).  The result
is the planes' shape of weighted per-sample sums

    out = w * sum_{valid k, in slot order} term_k
    term = li_k / max(d2e, 1e-4), 0 when d2e < 1e-4 (spheres: also at the
           centre), li = I / (4 pi)

with d^2 by direct differences (the TPU kernel's matmul expansion of d^2
and its ~1e-4 error, PARITY #8, are not ported).  A sample whose weight is 0
gets 0 without its sum.

``gather_many`` launches csrc/gather_many.cu for CUDA tensors and counts
each launch in ``launches["many"]``; for CPU tensors it runs
``gather_many_reference``, the same function in plain PyTorch, term for
term.  It never sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..lights import GUARD
from ..march import f32
from .gather_lanes import _INV_FOUR_PI, _add_columns, _d2e_bad, aligned
from .gather_vpu import _live_samples, _weighted

TILE_L = 256  # light slots per tile flag (gather_kernel.TILE_L)
launches = {"many": 0}  # kernel launches made by gather_many


def gather_many_reference(px, py, pz, w, l_pos, l_int, l_valid, *,
                          sphere: bool, radius=0.0,
                          max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in its term order: one running
    sum per live sample over the valid slots in slot order (an invalid slot
    adds exactly 0 in the kernel, so it is left out here), chunked over
    lights so that the (samples, lights) temporaries stay under
    ``max_elems`` elements."""
    rad = f32(radius) if sphere else None
    idx, x, y, z, wv = _live_samples(px, py, pz, w)
    acc = torch.zeros_like(x)
    k = torch.nonzero(l_valid).reshape(-1)
    li = l_int[k] * _INV_FOUR_PI
    lx, ly, lz = l_pos[k, 0], l_pos[k, 1], l_pos[k, 2]
    x, y, z = x[:, None], y[:, None], z[:, None]
    per = max(1, max_elems // max(x.shape[0], 1))
    for a in range(0, k.shape[0] if x.shape[0] else 0, per):
        b = min(a + per, k.shape[0])
        d2e, bad = _d2e_bad(x, y, z, lx[a:b], ly[a:b], lz[a:b], rad)
        acc = _add_columns(acc, torch.where(
            bad, 0.0, li[a:b] / torch.clamp(d2e, min=GUARD)))
    return _weighted(w, idx, wv, acc)


def _check(px, py, pz, w, l_pos, l_int, l_valid):
    """Validate what the kernel takes; returns L."""
    if l_pos.dim() != 2:
        raise ValueError(f"expected (L, 3) lights, got {tuple(l_pos.shape)}")
    L = l_pos.shape[0]
    shape = tuple(px.shape)
    for name, t, want, dtype in (
        ("px", px, shape, torch.float32),
        ("py", py, shape, torch.float32),
        ("pz", pz, shape, torch.float32),
        ("w", w, shape, torch.float32),
        ("l_pos", l_pos, (L, 3), torch.float32),
        ("l_int", l_int, (L,), torch.float32),
        ("l_valid", l_valid, (L,), torch.bool),
    ):
        if t.device != px.device:
            raise ValueError(f"{name} is on {t.device}, planes on {px.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if px.numel() >= 2**31 or 3 * L >= 2**31:
        raise ValueError("gather_many: a dimension exceeds the kernel's range")
    return L


def tile_flags(l_valid: torch.Tensor) -> torch.Tensor:
    """(ceil(L / 256),) i32: 1 where a 256-slot tile holds a valid slot,
    computed on the device (no host sync)."""
    pad = (-l_valid.shape[0]) % TILE_L
    return F.pad(l_valid, (0, pad)).view(-1, TILE_L).any(1).to(torch.int32)


def _lib():
    from ._build import library

    lib = library("gather_many")
    if not getattr(lib, "_vr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vr_gather_many.argtypes = [p] * 8 + [i, i, ctypes.c_float, i,
                                                 p, p, p]
        lib.vr_gather_many.restype = i
        lib.vr_many_error_string.argtypes = [i]
        lib.vr_many_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def gather_many(px, py, pz, w, l_pos, l_int, l_valid, *, sphere: bool,
                radius=0.0) -> torch.Tensor:
    """Point/sphere gather over any number of light slots: planes of any
    shape -> the same shape of f32 weighted sums ``w * sum_lights``."""
    L = _check(px, py, pz, w, l_pos, l_int, l_valid)
    if px.device.type == "cpu":
        return gather_many_reference(px, py, pz, w, l_pos, l_int, l_valid,
                                     sphere=sphere, radius=radius)
    if px.device.type != "cuda":
        raise ValueError(f"gather_many: unsupported device {px.device}")
    dev = px.device
    out = torch.empty_like(px)
    if not out.numel():
        return out
    li = l_int * _INV_FOUR_PI
    active = tile_flags(l_valid)
    w = aligned(w)
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_gather_many(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), w.data_ptr(),
            l_pos.data_ptr(), li.data_ptr(), l_valid.data_ptr(),
            active.data_ptr(), L, px.numel(), f32(radius), int(sphere),
            next_span.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.vr_many_error_string(err).decode()
        raise RuntimeError(f"gather_many kernel launch failed: {msg} ({err})")
    launches["many"] += 1
    return out
