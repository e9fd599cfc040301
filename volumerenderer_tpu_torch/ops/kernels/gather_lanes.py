"""Lane-per-ray point/sphere gather: CUDA kernel wrapper and plain version.

Twin of volumerenderer_tpu.ops.pallas.gather_lanes.gather_lanes.  Planes
are (Cp, Rc): each column one ray (lane), each row one march sample.  The
result is the (Rc,) per-ray weighted radiance sum

    out[r] = sum_{j < lane_need[r]} w[j, r] * sum_{k in [start, start+count)} term
    term   = li_k / max(d2e, 1e-4), 0 when d2e < 1e-4 (spheres: also at the
             centre), li = I / (4 pi)

``paired=True`` sums groups of 4 lights with one divide (guarded and
overrun terms are (n = 0, q = 1)): a reassociation of the same sum,
<= 3e-5 relative.

``gather_lanes`` launches csrc/gather_lanes.cu for CUDA tensors and counts
each launch in ``launches``; for CPU tensors it runs
``gather_lanes_reference``, the same function in plain PyTorch, term for
term.  It never sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..lights import FOUR_PI, GUARD
from ..march import f32, sqrt

TILE_L = 1024  # lane padding quantum of a CompactView
launches = 0  # kernel launches made by gather_lanes

_INV_FOUR_PI = f32(1.0 / FOUR_PI)


def lane_need_of(wm: torch.Tensor) -> torch.Tensor:
    """Samples each lane uses: index of its last nonzero weight + 1, (Rc,) i32."""
    Cp = wm.shape[0]
    nz = wm != 0.0
    last = torch.argmax(nz.flip(0).to(torch.int8), dim=0)
    return torch.where(nz.any(dim=0), Cp - last, torch.zeros_like(last)).to(
        torch.int32
    )


def _light_range(start, count, L):
    start = max(int(start), 0)
    return start, max(min(int(count), L - start), 0)


def gather_lanes_reference(px, py, pz, wm, l_pos, l_int, start, count, *,
                           sphere: bool, radius=0.0, lane_need=None,
                           paired: bool = False,
                           max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the kernel, chunked over lanes so that
    the (Cp, chunk, L) temporaries stay under ``max_elems`` elements."""
    Cp, Rc = px.shape
    dev = px.device
    L = l_pos.shape[0]
    if lane_need is None:
        lane_need = lane_need_of(wm)
    start, count = _light_range(start, count, L)
    radius = f32(radius)
    li = l_int * _INV_FOUR_PI
    if paired:
        # Whole groups of 4 from start; overrun slots read light L-1 and
        # are flagged bad.
        k = start + torch.arange(-(-count // 4) * 4, device=dev)
        overrun = k >= start + count
        k = torch.clamp(k, max=max(L - 1, 0))
    else:
        k = torch.arange(start, start + count, device=dev)
        overrun = torch.zeros(k.shape, dtype=torch.bool, device=dev)
    lx, ly, lz, lv = l_pos[k, 0], l_pos[k, 1], l_pos[k, 2], li[k]
    out = torch.zeros(Rc, dtype=torch.float32, device=dev)
    nk = max(k.shape[0], 1)
    chunk = max(1, max_elems // max(Cp * nk, 1))
    rows = torch.arange(Cp, device=dev)[:, None]
    for a in range(0, Rc, chunk):
        b = min(a + chunk, Rc)
        dx = px[:, a:b, None] - lx
        dy = py[:, a:b, None] - ly
        dz = pz[:, a:b, None] - lz
        d2 = dx * dx + dy * dy + dz * dz
        del dx, dy, dz
        if sphere:
            dist = sqrt(d2)
            dd = dist - radius
            d2e = dd * dd
            bad = (d2e < GUARD) | (dist == 0.0)
            del dist, dd
        else:
            d2e = d2
            bad = d2e < GUARD
        if paired:
            bad = bad | overrun
            n = torch.where(bad, 0.0, lv)
            q = torch.where(bad, 1.0, d2e)
            n = n.unflatten(-1, (-1, 4))
            q = q.unflatten(-1, (-1, 4))
            q12 = q[..., 0] * q[..., 1]
            q34 = q[..., 2] * q[..., 3]
            n12 = n[..., 0] * q[..., 1] + n[..., 1] * q[..., 0]
            n34 = n[..., 2] * q[..., 3] + n[..., 3] * q[..., 2]
            acc = ((n12 * q34 + n34 * q12) / (q12 * q34)).sum(dim=-1)
        else:
            term = lv / torch.clamp(d2e, min=GUARD)
            acc = torch.where(bad, 0.0, term).sum(dim=-1)
        use = rows < lane_need[a:b].to(torch.int64)[None, :]
        out[a:b] = torch.where(use, wm[:, a:b] * acc, 0.0).sum(dim=0)
    return out


def _check(px, py, pz, wm, l_pos, l_int, lane_need):
    """Validate what the kernel takes; returns (Cp, Rc, L)."""
    if px.dim() != 2 or l_pos.dim() != 2:
        raise ValueError(f"expected (Cp, Rc) planes and (L, 3) lights, got "
                         f"{tuple(px.shape)} and {tuple(l_pos.shape)}")
    (Cp, Rc), L = px.shape, l_pos.shape[0]
    for name, t, shape, dtype in (
        ("px", px, (Cp, Rc), torch.float32),
        ("py", py, (Cp, Rc), torch.float32),
        ("pz", pz, (Cp, Rc), torch.float32),
        ("wm", wm, (Cp, Rc), torch.float32),
        ("l_pos", l_pos, (L, 3), torch.float32),
        ("l_int", l_int, (L,), torch.float32),
        ("lane_need", lane_need, (Rc,), torch.int32),
    ):
        if t.device != px.device:
            raise ValueError(f"{name} is on {t.device}, planes on {px.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(Cp, Rc, 3 * L) >= 2**31:
        raise ValueError("gather_lanes: a dimension exceeds int32")
    return Cp, Rc, L


def _lib():
    from ._build import library

    lib = library("gather_lanes")
    if not getattr(lib, "_vr_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vr_gather_lanes.argtypes = [p] * 8 + [i, i, i, ctypes.c_float,
                                                  i, i, p, p]
        lib.vr_gather_lanes.restype = i
        lib.vr_cuda_error_string.argtypes = [i]
        lib.vr_cuda_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def _meta(start, count, dev):
    """(start, count) as an int32[2] device tensor, built without a sync."""
    parts = [
        v.reshape(()).to(device=dev, dtype=torch.int32)
        if isinstance(v, torch.Tensor)
        else torch.full((), int(v), dtype=torch.int32, device=dev)
        for v in (start, count)
    ]
    return torch.stack(parts)


def gather_lanes(px, py, pz, wm, l_pos, l_int, start, count, *,
                 sphere: bool, radius=0.0, lane_need=None,
                 paired: bool = False) -> torch.Tensor:
    """Point/sphere gather over lane planes (Cp, Rc) -> (Rc,) f32.

    ``start``/``count``: the valid light range, ints or device scalars
    (the kernel reads them on the device).  ``lane_need``: (Rc,) i32
    samples per lane, None to derive it from ``wm``."""
    global launches
    if lane_need is None:
        lane_need = lane_need_of(wm)
    Cp, Rc, L = _check(px, py, pz, wm, l_pos, l_int, lane_need)
    if px.device.type == "cpu":
        return gather_lanes_reference(
            px, py, pz, wm, l_pos, l_int, start, count, sphere=sphere,
            radius=radius, lane_need=lane_need, paired=paired,
        )
    if px.device.type != "cuda":
        raise ValueError(f"gather_lanes: unsupported device {px.device}")
    dev = px.device
    out = torch.empty(Rc, dtype=torch.float32, device=dev)
    if Rc == 0:
        return out
    meta = _meta(start, count, dev)
    li = l_int * _INV_FOUR_PI
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_gather_lanes(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), wm.data_ptr(),
            lane_need.data_ptr(), l_pos.data_ptr(), li.data_ptr(),
            meta.data_ptr(), L, Cp, Rc, f32(radius), int(sphere),
            int(paired), out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.vr_cuda_error_string(err).decode()
        raise RuntimeError(f"gather_lanes kernel launch failed: {msg} ({err})")
    launches += 1
    return out
