"""Slot-layout gathers: CUDA kernel wrappers and plain versions.

Twins of volumerenderer_tpu.ops.pallas.gather_vpu ``gather_vpu``,
``gather_segments_discrete`` and ``gather_segments_analytic``.  The planes
are the (R, C) planes of a ViewCache (any 2-D C-contiguous shape, read as
one flat array of samples); the result is the same-shaped array of
weighted per-sample sums

    out = w * sum_{k in [start, start+count)} term_k

with the terms of the lane gathers (gather_lanes.py, gather_segments.py) in
the TPU kernel's own order: one running sum per sample across every light,
every sub-light of every segment, or every segment (two per step for the
paired closed-form VRL and closed-rule VBL).  The TPU kernel's (M, 128)
blocks and per-block skip flags are a TPU layout and are not ported: a
sample whose weight is 0 gets 0 without its sum being evaluated, which
equals the TPU's ``w * sum`` wherever the sum is finite (the guards make
it so).

Each wrapper launches csrc/gather_vpu.cu for CUDA tensors and counts the
launch in ``launches``; for CPU tensors it runs its ``*_reference``, the
same function in plain PyTorch.  It never sends a CUDA tensor to the plain
version.  Every kernel takes only live samples through a loop that indexes
samples in int32, so the wrappers refuse planes of 2^31 samples or more
(the 1080p ViewCache holds 298,598,400; a 4K one at a march cap of 144,
1.19e9).
"""

from __future__ import annotations

import ctypes

import torch

from ..lights import GUARD
from ..march import f32
from . import segment_math as sm
from .gather_lanes import (
    _INV_FOUR_PI, _add_columns, _d2e_bad, _light_range, _meta, aligned,
    point_sums,
)
from .gather_segments import (
    MAX_NODES, PAIR_BIG, _VARIANTS, _analytic_terms, _chunks,
    _sublight_table, _table, analytic_cols, discrete_cols, node_table,
    sublight_prefix,
)

# Kernel launches made by each wrapper (one key per TPU kernel body).
launches = {"vpu": 0, "segment_discrete": 0, "segment_analytic": 0,
            "segment_sphere": 0}


# ---- plain versions ----


def _live_samples(px, py, pz, wm):
    """The samples with a nonzero weight: (flat index, x, y, z, w)."""
    w = wm.reshape(-1)
    idx = torch.nonzero(w != 0.0).reshape(-1)
    return (idx, px.reshape(-1)[idx], py.reshape(-1)[idx],
            pz.reshape(-1)[idx], w[idx])


def _weighted(wm, idx, w, acc):
    """(R, C) output: w * acc on the live samples, 0 elsewhere."""
    out = torch.zeros_like(wm)
    out.view(-1)[idx] = w * acc
    return out


def gather_vpu_reference(px, py, pz, wm, l_pos, l_int, start, count, *,
                         sphere: bool, radius=0.0, paired: bool = False,
                         max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the point/sphere slot kernel: each live
    sample's ``point_sums``, in the kernel's order."""
    start, count = _light_range(start, count, l_pos.shape[0])
    idx, x, y, z, w = _live_samples(px, py, pz, wm)
    acc = point_sums(x, y, z, l_pos, l_int, start, count, sphere=sphere,
                     radius=radius, paired=paired, max_elems=max_elems)
    return _weighted(wm, idx, w, acc)


def gather_segments_discrete_reference(
        px, py, pz, wm, pos_from, pos_to, intensity, valid,
        light_ray_step_size, *, sphere_radius=None, paired: bool = False,
        max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the discrete slot kernel, chunked over
    sub-lights so that the (samples, sub-lights) temporaries stay under
    ``max_elems`` elements."""
    L = pos_from.shape[0]
    u, ns, ii, start, count = discrete_cols(pos_from, pos_to, intensity,
                                            valid, light_ray_step_size)
    start, count = _light_range(start, count, L)
    radius = None if sphere_radius is None else f32(sphere_radius)
    idx, x, y, z, w = _live_samples(px, py, pz, wm)
    acc = torch.zeros_like(x)
    lx, ly, lz, lii, overrun, seg = _sublight_table(
        pos_from, u, ns, ii, start, count, f32(light_ray_step_size), paired)
    x, y, z = x[:, None], y[:, None], z[:, None]
    S = lx.shape[0] if x.shape[0] else 0
    per = max(4, max_elems // max(x.shape[0], 1) // 4 * 4)
    if paired:
        # One part per segment, its groups summed in order, then
        # acc + ii * part (segments without sub-lights add ii * 0 = 0).
        seg_g = seg[::4].tolist()
        part = None
    for a in range(0, S, per):
        b = min(a + per, S)
        d2e, bad = _d2e_bad(x, y, z, lx[a:b], ly[a:b], lz[a:b], radius)
        if not paired:
            acc = _add_columns(acc, torch.where(
                bad, 0.0, lii[a:b] / torch.clamp(d2e, min=GUARD)))
            continue
        q = torch.where(bad | overrun[a:b], PAIR_BIG,
                        d2e).unflatten(-1, (-1, 4))
        q12 = q[..., 0] * q[..., 1]
        q34 = q[..., 2] * q[..., 3]
        s12 = q[..., 0] + q[..., 1]
        s34 = q[..., 2] + q[..., 3]
        grp = (s12 * q34 + s34 * q12) / (q12 * q34)
        for g in range(grp.shape[1]):
            gi = a // 4 + g
            part = grp[:, g] if part is None else part + grp[:, g]
            if gi + 1 == len(seg_g) or seg_g[gi + 1] != seg_g[gi]:
                acc = acc + ii[start + seg_g[gi]] * part
                part = None
    return _weighted(wm, idx, w, acc)


def gather_segments_analytic_reference(
        px, py, pz, wm, pos_from, pos_to, intensity, valid, *,
        sphere_radius=None, quad_nodes: int = 16, quad_rule: str = "midpoint",
        paired: bool = False, max_elems: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version of the analytic slot kernels (closed-form VRL,
    or the VBL quadrature under ``quad_rule``), chunked over samples so
    that each (samples, segments) temporary stays under ``max_elems``."""
    L = pos_from.shape[0]
    u, length, ii, start, count = analytic_cols(pos_from, pos_to, intensity,
                                                valid)
    start, count = _light_range(start, count, L)
    radius = None if sphere_radius is None else f32(sphere_radius)
    nodes = (None if radius is None
             else sm.effective_quad_nodes(quad_rule, quad_nodes))
    idx, x, y, z, w = _live_samples(px, py, pz, wm)
    acc = torch.zeros_like(x)
    if count:
        cols = (pos_from, u, length, ii)
        for a, b in _chunks(x.shape[0], count, max_elems):
            terms = _analytic_terms(x[a:b, None], y[a:b, None], z[a:b, None],
                                    cols, start, count, radius, nodes,
                                    quad_rule, paired)
            acc[a:b] = _add_columns(acc[a:b], terms)
    return _weighted(wm, idx, w, acc)


# ---- kernels ----


def _check(px, py, pz, wm, cols):
    """Validate what the kernels take: (R, C) planes and the named light or
    segment columns ``(name, tensor, shape, dtype)``."""
    if px.dim() != 2:
        raise ValueError(f"expected (R, C) planes, got {tuple(px.shape)}")
    planes = [(n, t, tuple(px.shape), torch.float32)
              for n, t in (("px", px), ("py", py), ("pz", pz), ("wm", wm))]
    for name, t, shape, dtype in planes + cols:
        if t.device != px.device:
            raise ValueError(f"{name} is on {t.device}, planes on {px.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 8 * cols[0][1].shape[0] >= 2**31:
        raise ValueError("gather_vpu: a dimension exceeds the kernels' range")


def _check_live_loop(px, what: str):
    """The live-sample kernels (all four) index samples in int32 (the
    wrappers hand them a 16-byte aligned weight plane, ``aligned``)."""
    if px.numel() >= 2**31:
        raise ValueError(f"{what}: {px.numel()} samples; the kernel takes "
                         f"fewer than 2^31")


def _segment_cols(pos_from, pos_to, intensity, valid):
    L = pos_from.shape[0]
    return [("pos_from", pos_from, (L, 3), torch.float32),
            ("pos_to", pos_to, (L, 3), torch.float32),
            ("intensity", intensity, (L,), torch.float32),
            ("valid", valid, (L,), torch.bool)]


def _lib():
    from ._build import library

    lib = library("gather_vpu")
    if not getattr(lib, "_vr_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vr_gather_vpu.argtypes = [p] * 7 + [i, i, f, i, i, p, p, p]
        lib.vr_gather_vpu_discrete.argtypes = (
            [p] * 7 + [i, i, f, f, i, i, p, p, p])
        lib.vr_gather_vpu_vrl.argtypes = [p] * 6 + [i, i, i, p, p, p]
        lib.vr_gather_vpu_sphere.argtypes = (
            [p] * 7 + [i, i, i, f, i, i, p, p, p])
        for fn in ("vr_gather_vpu", "vr_gather_vpu_discrete",
                   "vr_gather_vpu_vrl", "vr_gather_vpu_sphere"):
            getattr(lib, fn).restype = i
        lib.vr_vpu_error_string.argtypes = [i]
        lib.vr_vpu_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def _run(fn: str, dev, *args) -> None:
    """Launch entry point ``fn`` on the current stream of ``dev``; tensors
    pass as device pointers.  Raises if the launch was refused."""
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*(a.data_ptr() if isinstance(a, torch.Tensor)
                                 else a for a in args), stream)
    if err != 0:
        msg = lib.vr_vpu_error_string(err).decode()
        raise RuntimeError(f"{fn} kernel launch failed: {msg} ({err})")


def _require_cuda(px, what: str):
    if px.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {px.device}")


def gather_vpu(px, py, pz, wm, l_pos, l_int, start, count, *, sphere: bool,
               radius=0.0, paired: bool = False) -> torch.Tensor:
    """Point/sphere gather over (R, C) planes of fewer than 2^31 samples ->
    (R, C) f32 weighted sums.  ``start``/``count``: the valid light range,
    ints or device scalars (the kernel reads them on the device)."""
    L = l_pos.shape[0]
    _check(px, py, pz, wm, [("l_pos", l_pos, (L, 3), torch.float32),
                            ("l_int", l_int, (L,), torch.float32)])
    _check_live_loop(px, "gather_vpu")
    if px.device.type == "cpu":
        return gather_vpu_reference(px, py, pz, wm, l_pos, l_int, start,
                                    count, sphere=sphere, radius=radius,
                                    paired=paired)
    _require_cuda(px, "gather_vpu")
    out = torch.empty_like(px)
    if out.numel():
        next_span = torch.zeros(1, dtype=torch.int32, device=px.device)
        _run("vr_gather_vpu", px.device, px, py, pz, aligned(wm), l_pos,
             l_int * _INV_FOUR_PI, _meta(start, count, px.device), L,
             px.numel(), f32(radius), int(sphere), int(paired), next_span,
             out)
        launches["vpu"] += 1
    return out


def gather_segments_discrete(px, py, pz, wm, pos_from, pos_to, intensity,
                             valid, light_ray_step_size, *,
                             sphere_radius=None,
                             paired: bool = False) -> torch.Tensor:
    """Discrete (uncapped) Ray/VRL or Beam/VBL sub-light gather over (R, C)
    planes of fewer than 2^31 samples -> (R, C) f32 weighted sums."""
    _check(px, py, pz, wm, _segment_cols(pos_from, pos_to, intensity, valid))
    _check_live_loop(px, "gather_segments_discrete")
    if px.device.type == "cpu":
        return gather_segments_discrete_reference(
            px, py, pz, wm, pos_from, pos_to, intensity, valid,
            light_ray_step_size, sphere_radius=sphere_radius, paired=paired)
    _require_cuda(px, "gather_segments_discrete")
    dev = px.device
    out = torch.empty_like(px)
    if not out.numel():
        return out
    u, ns, ii, start, count = discrete_cols(pos_from, pos_to, intensity,
                                            valid, light_ray_step_size)
    table = _table(pos_from, u, ns.view(torch.float32), ii)
    first, meta = sublight_prefix(ns, start, count, paired)
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    _run("vr_gather_vpu_discrete", dev, px, py, pz, aligned(wm), table,
         first, meta, pos_from.shape[0], px.numel(), f32(light_ray_step_size),
         f32(0.0 if sphere_radius is None else sphere_radius),
         int(sphere_radius is not None), int(paired), next_span, out)
    launches["segment_discrete"] += 1
    return out


def gather_segments_analytic(px, py, pz, wm, pos_from, pos_to, intensity,
                             valid, *, sphere_radius=None,
                             quad_nodes: int = 16,
                             quad_rule: str = "midpoint",
                             paired: bool = False) -> torch.Tensor:
    """Closed-form VRL (``sphere_radius=None``) or VBL quadrature gather
    over (R, C) planes of fewer than 2^31 samples -> (R, C) f32 weighted
    sums."""
    if quad_rule not in ("midpoint", "tangent", "closed"):
        raise ValueError(f"unknown quadrature rule: {quad_rule!r}")
    _check(px, py, pz, wm, _segment_cols(pos_from, pos_to, intensity, valid))
    _check_live_loop(px, "gather_segments_analytic")
    if px.device.type == "cpu":
        return gather_segments_analytic_reference(
            px, py, pz, wm, pos_from, pos_to, intensity, valid,
            sphere_radius=sphere_radius, quad_nodes=quad_nodes,
            quad_rule=quad_rule, paired=paired)
    _require_cuda(px, "gather_segments_analytic")
    rule = None if sphere_radius is None else quad_rule
    nodes = 0 if rule is None else sm.effective_quad_nodes(rule, quad_nodes)
    if not 0 <= nodes <= MAX_NODES:
        raise ValueError(f"gather_segments_analytic: {nodes} quadrature "
                         f"nodes, the kernel takes 1..{MAX_NODES}")
    out = torch.empty_like(px)
    if not out.numel():
        return out
    dev = px.device
    u, length, ii, start, count = analytic_cols(pos_from, pos_to, intensity,
                                                valid)
    table = _table(pos_from, u, length, ii)
    meta = _meta(start, count, dev)
    L, N = pos_from.shape[0], px.numel()
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    if rule is None:
        _run("vr_gather_vpu_vrl", dev, px, py, pz, aligned(wm), table, meta,
             L, N, int(paired), next_span, out)
        launches["segment_analytic"] += 1
    else:
        _run("vr_gather_vpu_sphere", dev, px, py, pz, aligned(wm), table,
             node_table(rule, nodes, dev), meta, L, N, nodes,
             f32(sphere_radius), _VARIANTS[rule], int(paired), next_span,
             out)
        launches["segment_sphere"] += 1
    return out
