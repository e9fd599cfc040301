"""Lane-per-ray point/sphere gather: CUDA kernel wrapper and plain version.

Twin of volumerenderer_tpu.ops.pallas.gather_lanes.gather_lanes.  Planes
are (Cp, Rc): each column one ray (lane), each row one march sample.  The
result is the (Rc,) per-ray weighted radiance sum

    out[r] = sum_{j < lane_need[r]} w[j, r] * sum_{k in [start, start+count)} term
    term   = li_k / max(d2e, 1e-4), 0 when d2e < 1e-4 (spheres: also at the
             centre), li = I / (4 pi)

``paired=True`` sums groups of 4 lights with one divide (guarded and
overrun terms are (n = 0, q = 1)): a reassociation of the same sum,
<= 3e-5 relative.  The plain version sums in the kernel's order (each
sample's lights in table order, then a lane's samples in row order), so
the kernel against it reads only the kernel's instruction forms (an FMA,
an approximate reciprocal).

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


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned address: the live-sample
    kernels fetch their weights and zero their outputs several samples at
    a time and take only 16-byte aligned planes (a contiguous view can
    start mid-allocation, e.g. the last of several planes of one
    tensor)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _active_samples(px, py, pz, lane_need):
    """The samples each lane uses (row j < lane_need), flattened."""
    Cp = px.shape[0]
    use = (torch.arange(Cp, device=px.device)[:, None]
           < lane_need.to(torch.int64)[None, :])
    return use, px[use], py[use], pz[use]


def _lane_sums(use, wm, rad):
    """sum_j w[j] * rad[j] per lane, rad given on the used samples, added in
    row order (the kernels' running sum over a lane's samples)."""
    full = torch.zeros_like(wm)
    full[use] = rad
    terms = torch.where(use, wm * full, 0.0)
    out = wm.new_zeros(wm.shape[1])
    for j in range(terms.shape[0]):
        out = out + terms[j]
    return out


def _add_columns(acc, terms):
    """acc + terms[:, 0] + terms[:, 1] + ..., one column at a time (the
    kernels' running sum over the lights or segments)."""
    for t in range(terms.shape[1]):
        acc = acc + terms[:, t]
    return acc


def _d2e_bad(x, y, z, lx, ly, lz, radius):
    """d2e = |p - l|^2 (``radius`` None) or (|p - l| - r)^2 and its guard."""
    dx = x - lx
    dy = y - ly
    dz = z - lz
    d2 = dx * dx + dy * dy + dz * dz
    if radius is None:
        return d2, d2 < GUARD
    dist = sqrt(d2)
    dd = dist - radius
    d2e = dd * dd
    return d2e, (d2e < GUARD) | (dist == 0.0)


def point_sums(x, y, z, l_pos, l_int, start, count, *, sphere: bool,
               radius=0.0, paired: bool = False,
               max_elems: int = 1 << 24) -> torch.Tensor:
    """Each sample's (N,) sum over lights [start, start + count) in the
    kernels' order: one running sum over the lights in table order, or, for
    ``paired``, over whole groups of 4 from ``start`` (overrun slots read
    light L - 1 and, like guarded terms, are (n = 0, q = 1)).  Chunked over
    lights so that the (samples, lights) temporaries stay under
    ``max_elems`` elements."""
    L = l_pos.shape[0]
    rad = f32(radius) if sphere else None
    li = l_int * _INV_FOUR_PI
    acc = torch.zeros_like(x)
    span = -(-count // 4) * 4 if paired else count
    x, y, z = x[:, None], y[:, None], z[:, None]
    per = max(4, max_elems // max(x.shape[0], 1) // 4 * 4)
    for a in range(0, span if x.shape[0] else 0, per):
        k = start + torch.arange(a, min(a + per, span), device=x.device)
        kc = torch.clamp(k, max=L - 1)
        d2e, bad = _d2e_bad(x, y, z, l_pos[kc, 0], l_pos[kc, 1],
                            l_pos[kc, 2], rad)
        if paired:
            bad = bad | (k >= start + count)
            n = torch.where(bad, 0.0, li[kc]).unflatten(-1, (-1, 4))
            q = torch.where(bad, 1.0, d2e).unflatten(-1, (-1, 4))
            q12 = q[..., 0] * q[..., 1]
            q34 = q[..., 2] * q[..., 3]
            n12 = n[..., 0] * q[..., 1] + n[..., 1] * q[..., 0]
            n34 = n[..., 2] * q[..., 3] + n[..., 3] * q[..., 2]
            terms = (n12 * q34 + n34 * q12) / (q12 * q34)
        else:
            terms = torch.where(bad, 0.0,
                                li[kc] / torch.clamp(d2e, min=GUARD))
        acc = _add_columns(acc, terms)
    return acc


def gather_lanes_reference(px, py, pz, wm, l_pos, l_int, start, count, *,
                           sphere: bool, radius=0.0, lane_need=None,
                           paired: bool = False,
                           max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in its summation order: one
    running sum per used sample (row j < lane_need) over the lights
    (``point_sums``), then each lane's w * sum in row order."""
    if lane_need is None:
        lane_need = lane_need_of(wm)
    start, count = _light_range(start, count, l_pos.shape[0])
    use, x, y, z = _active_samples(px, py, pz, lane_need)
    acc = point_sums(x, y, z, l_pos, l_int, start, count, sphere=sphere,
                     radius=radius, paired=paired, max_elems=max_elems)
    return _lane_sums(use, wm, acc)


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
