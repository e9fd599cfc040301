"""Lane-per-ray segment gathers (Ray/VRL, Beam/VBL): CUDA kernel wrappers
and plain versions.

Twins of volumerenderer_tpu.ops.pallas.gather_lanes
``gather_segments_discrete_lanes`` and ``gather_segments_analytic_lanes``.
Planes are (Cp, Rc) as in gather_lanes; the result is the (Rc,) per-ray sum
``sum_{j < lane_need} w[j] * sum_{segments k in [start, start+count)} term``.

  discrete  each segment k holds ns_k = floor(len_k / step) sub-lights at
            from + (s * step) * u of intensity I / ns / (4 pi): point lights
            (Ray) or ``sphere_radius`` sphere lights (Beam), uncapped.
            ``paired``: one divide per 4 sub-lights, guarded and overrun
            terms at q = PAIR_BIG.
  analytic  the segment integral itself: the closed-form VRL line integral
            (``sphere_radius=None``) or the VBL quadrature under
            ``quad_rule`` (midpoint, tangent, closed).  ``paired``: one
            divide per 4 nodes, or, for the closed-form VRL and the
            closed-rule VBL, two segments per trip sharing their divides.

Each wrapper launches csrc/gather_segments.cu for CUDA tensors and counts
the launch in ``launches``; for CPU tensors it runs its ``*_reference``,
the same function in plain PyTorch (segment_math holds the shared terms).
It never sends a CUDA tensor to the plain version.  The segment columns
(``segment_cols``, ns, ii) are computed on the device in the reference
package's order and are shared by the kernel and the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..lights import FOUR_PI, GUARD
from ..march import f32
from . import segment_math as sm
from .gather_lanes import (
    _active_samples, _add_columns, _d2e_bad, _lane_sums, _light_range, _meta,
    aligned, lane_need_of,
)

PAIR_BIG = 1e9  # the paired discrete tier's "discarded" q
MAX_NODES = 1024  # quadrature nodes the kernel stages in shared memory
# Kernel launches made by each wrapper.
launches = {"discrete": 0, "analytic": 0}

_INV_FOUR_PI = f32(1.0 / FOUR_PI)
_VARIANTS = {None: 0, "midpoint": 1, "tangent": 2, "closed": 3}
# Inputs the kernels read in place (the segment table is built anew).
_PLANES = ("px", "py", "pz", "wm", "lane_need")


def segment_cols(pos_from, pos_to, intensity, valid):
    """(u, length, safe_length, start, count) of a segment table (L,).
    ``vector_norm`` and the divide round as the reference package's
    ``jnp.linalg.norm`` and ``seg / safe`` do on the CPU, bit for bit, so
    ns = floor(length / step) flips where the reference flips."""
    seg = pos_to - pos_from
    length = torch.linalg.vector_norm(seg, dim=-1)
    safe = torch.where(length > 0, length, 1.0)
    u = seg / safe[:, None]
    valid_i = valid.to(torch.int32)
    return u, length, safe, torch.argmax(valid_i), valid_i.sum()


def discrete_cols(pos_from, pos_to, intensity, valid, light_ray_step_size):
    """(u, ns, ii, start, count): sub-light counts (L,) i32 and per-sub-light
    intensities I / ns / (4 pi) (L,), zero for dead segments."""
    u, length, _safe, start, count = segment_cols(pos_from, pos_to,
                                                  intensity, valid)
    steps = (length / f32(light_ray_step_size)).to(torch.int32)
    live = valid & (steps > 0)
    ns = torch.where(live, steps, 0)
    ii = intensity / torch.clamp(steps, min=1).to(torch.float32)
    ii = ii * _INV_FOUR_PI
    return u, ns, torch.where(live, ii, 0.0), start, count


def sublight_prefix(ns, start, count, paired: bool):
    """(first, meta) of the discrete kernel's sub-light table, computed on
    ns's device without a host sync.  Segment k of the clamped range
    [start, start+count) owns table entries [first[k], first[k] + slots_k)
    with slots_k = ns_k (exact) or ns_k rounded up to a multiple of 4
    (paired): the order of ``_sublight_table``.  first: (L,) i32, an
    exclusive prefix sum (0-slot segments outside the range); meta:
    int32[3] = (start, count, total entries)."""
    L = ns.shape[0]
    dev = ns.device
    start = torch.clamp(torch.as_tensor(start, device=dev).reshape(()),
                        min=0).to(torch.int32)
    count = torch.clamp(torch.minimum(
        torch.as_tensor(count, device=dev).reshape(()).to(torch.int32),
        L - start), min=0)
    k = torch.arange(L, device=dev, dtype=torch.int32)
    slots = torch.where((k >= start) & (k < start + count), ns, 0).to(
        torch.int32)
    if paired:
        slots = (slots + 3) // 4 * 4
    ends = torch.cumsum(slots, 0, dtype=torch.int32)
    return ends - slots, torch.stack([start, count, slots.sum(
        dtype=torch.int32)])


def analytic_cols(pos_from, pos_to, intensity, valid):
    """(u, length, ii, start, count) with ii = I / (4 pi L)."""
    u, length, safe, start, count = segment_cols(pos_from, pos_to,
                                                 intensity, valid)
    ii = torch.where(valid & (length > 0),
                     intensity / (f32(FOUR_PI) * safe), 0.0)
    return u, length, ii, start, count


# ---- plain versions ----


def _chunks(n: int, per: int, max_elems: int):
    step = max(1, max_elems // max(per, 1))
    for a in range(0, n, step):
        yield a, min(a + step, n)


def _sublight_table(pos_from, u, ns, ii, start, count, step, paired):
    """The sub-lights of segments [start, start+count) in the kernel's
    order: (lx, ly, lz, lii, bad_slot, seg) — for ``paired``, whole groups
    of 4 per segment, overrun slots flagged in ``bad_slot``; ``seg`` is each
    slot's segment (relative to start)."""
    dev = pos_from.device
    k = torch.arange(start, start + count, device=dev)
    ns_k = ns[k].to(torch.int64)
    slots = (ns_k + 3) // 4 * 4 if paired else ns_k
    total = int(slots.sum())  # host read: the plain version sizes its table
    seg = torch.repeat_interleave(torch.arange(count, device=dev), slots,
                                  output_size=total)
    first = torch.cumsum(slots, 0) - slots
    s = torch.arange(total, device=dev) - first[seg]
    kk = k[seg]
    sf = s.to(torch.float32) * step
    lx = pos_from[kk, 0] + sf * u[kk, 0]
    ly = pos_from[kk, 1] + sf * u[kk, 1]
    lz = pos_from[kk, 2] + sf * u[kk, 2]
    return lx, ly, lz, ii[kk], s >= ns_k[seg], seg


def gather_segments_discrete_lanes_reference(
        px, py, pz, wm, pos_from, pos_to, intensity, valid,
        light_ray_step_size, *, sphere_radius=None, lane_need=None,
        paired: bool = False, max_elems: int = 1 << 24) -> torch.Tensor:
    """Plain PyTorch version of the discrete kernel, in its summation order:
    one running sum per sample over the sub-light table in table order (the
    paired tier: over its groups, each segment's part scaled by its ii when
    the segment ends), then each lane's samples in row order.  Chunked over
    sub-lights so that the (samples, sub-lights) temporaries stay under
    ``max_elems`` elements."""
    if lane_need is None:
        lane_need = lane_need_of(wm)
    L = pos_from.shape[0]
    u, ns, ii, start, count = discrete_cols(pos_from, pos_to, intensity,
                                            valid, light_ray_step_size)
    start, count = _light_range(start, count, L)
    radius = None if sphere_radius is None else f32(sphere_radius)
    lx, ly, lz, lii, overrun, seg = _sublight_table(
        pos_from, u, ns, ii, start, count, f32(light_ray_step_size), paired)
    use, x, y, z = _active_samples(px, py, pz, lane_need)
    acc = torch.zeros_like(x)
    part = torch.zeros_like(x)
    S = lx.shape[0]
    if paired:  # per group: its segment's ii, and whether it ends the segment
        gseg = seg[::4]
        gii = ii[start + gseg]
        ends = torch.ones_like(gseg, dtype=torch.bool)
        ends[:-1] = gseg[1:] != gseg[:-1]
        ends = ends.tolist()  # host read: the plain version walks the groups
    per = max(4, max_elems // max(x.shape[0], 1) // 4 * 4)
    x, y, z = x[:, None], y[:, None], z[:, None]
    for a in range(0, S if x.shape[0] else 0, per):
        b = min(a + per, S)
        d2e, bad = _d2e_bad(x, y, z, lx[a:b], ly[a:b], lz[a:b], radius)
        if paired:
            q = torch.where(bad | overrun[a:b], PAIR_BIG, d2e).unflatten(
                -1, (-1, 4))
            q12 = q[..., 0] * q[..., 1]
            q34 = q[..., 2] * q[..., 3]
            s12 = q[..., 0] + q[..., 1]
            s34 = q[..., 2] + q[..., 3]
            grp = (s12 * q34 + s34 * q12) / (q12 * q34)
            for g in range(grp.shape[1]):
                part = part + grp[:, g]
                if ends[a // 4 + g]:
                    acc = acc + gii[a // 4 + g] * part
                    part = torch.zeros_like(part)
        else:
            term = torch.where(bad, 0.0, lii[a:b] / torch.clamp(d2e, min=GUARD))
            for t in range(term.shape[1]):
                acc = acc + term[:, t]
    return _lane_sums(use, wm, acc)


def _analytic_terms(x, y, z, cols, start, count, radius, nodes, rule,
                    paired):
    """(N, T) per-sample terms of the analytic kernel, in its summation
    order (T: one per segment, or 2 / 3 per segment pair)."""
    pos_from, u, length, ii = cols
    if paired and (radius is None or rule == "closed"):
        # Two segments per trip; the odd tail repeats the last segment
        # with zero intensity.
        k0 = torch.arange(start, start + count, 2, device=x.device)
        k1 = torch.clamp(k0 + 1, max=start + count - 1)
        ii_b = torch.where(k0 + 1 < start + count, ii[k1], 0.0)

        def geom(k):
            d = (x - pos_from[k, 0], y - pos_from[k, 1], z - pos_from[k, 2])
            uk = (u[k, 0], u[k, 1], u[k, 2])
            b = d[0] * uk[0] + d[1] * uk[1] + d[2] * uk[2]
            return d, uk, b, length[k]

        da, ua, ba, la = geom(k0)
        db, ub, bb, lb = geom(k1)
        if radius is None:
            num_a, den_a, iq_a = sm.vrl_parts(da, ua, ba, la)
            num_b, den_b, iq_b = sm.vrl_parts(db, ub, bb, lb)
            ang_a, ang_b = sm.paired_pos_ratio_atans(num_a, den_a, num_b,
                                                     den_b)
            parts = (ii[k0] * (ang_a * iq_a), ii_b * (ang_b * iq_b))
        else:
            parts = sm.closed_pair_term(da, ua, ba, la, ii[k0], db, ub, bb,
                                        lb, ii_b, radius)
        return torch.stack(parts, dim=-1).flatten(-2)
    k = slice(start, start + count)
    d = (x - pos_from[k, 0], y - pos_from[k, 1], z - pos_from[k, 2])
    uk = (u[k, 0], u[k, 1], u[k, 2])
    b = d[0] * uk[0] + d[1] * uk[1] + d[2] * uk[2]
    ll = length[k]
    if radius is None:
        q2 = sm.cross_q2(d, uk)
        iq = sm.rsqrt(q2)
        return ii[k] * (sm.subtended_angle(b, q2, q2 * iq, ll) * iq)
    node_nq, scale = sm.quad_nodes_nq(rule, nodes, d, uk, b, ll, radius)
    return ii[k] * scale * sm.node_sum(node_nq, nodes, paired)


def gather_segments_analytic_lanes_reference(
        px, py, pz, wm, pos_from, pos_to, intensity, valid, *,
        sphere_radius=None, quad_nodes: int = 16, quad_rule: str = "midpoint",
        lane_need=None, paired: bool = False,
        max_elems: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch version of the analytic kernel, in its summation
    order: one running sum per sample over the terms in segment order, then
    each lane's samples in row order.  Chunked over samples so that each
    (samples, segments) temporary stays under ``max_elems`` elements."""
    if lane_need is None:
        lane_need = lane_need_of(wm)
    L = pos_from.shape[0]
    u, length, ii, start, count = analytic_cols(pos_from, pos_to, intensity,
                                                valid)
    start, count = _light_range(start, count, L)
    radius = None if sphere_radius is None else f32(sphere_radius)
    nodes = (None if radius is None
             else sm.effective_quad_nodes(quad_rule, quad_nodes))
    use, x, y, z = _active_samples(px, py, pz, lane_need)
    rad = torch.zeros_like(x)
    if count:
        cols = (pos_from, u, length, ii)
        for a, b in _chunks(x.shape[0], count, max_elems):
            terms = _analytic_terms(x[a:b, None], y[a:b, None], z[a:b, None],
                                    cols, start, count, radius, nodes,
                                    quad_rule, paired)
            rad[a:b] = _add_columns(rad[a:b], terms)
    return _lane_sums(use, wm, rad)


# ---- kernels ----


def _check(px, py, pz, wm, pos_from, pos_to, intensity, valid, lane_need):
    """Validate what the kernels take; returns (Cp, Rc, L)."""
    if px.dim() != 2 or pos_from.dim() != 2:
        raise ValueError(f"expected (Cp, Rc) planes and (L, 3) segments, got "
                         f"{tuple(px.shape)} and {tuple(pos_from.shape)}")
    (Cp, Rc), L = px.shape, pos_from.shape[0]
    for name, t, shape, dtype in (
        ("px", px, (Cp, Rc), torch.float32),
        ("py", py, (Cp, Rc), torch.float32),
        ("pz", pz, (Cp, Rc), torch.float32),
        ("wm", wm, (Cp, Rc), torch.float32),
        ("pos_from", pos_from, (L, 3), torch.float32),
        ("pos_to", pos_to, (L, 3), torch.float32),
        ("intensity", intensity, (L,), torch.float32),
        ("valid", valid, (L,), torch.bool),
        ("lane_need", lane_need, (Rc,), torch.int32),
    ):
        if t.device != px.device:
            raise ValueError(f"{name} is on {t.device}, planes on {px.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, "
                             f"got {tuple(t.shape)}")
        if name in _PLANES and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(Cp, Rc, 8 * L) >= 2**31:
        raise ValueError("gather_segments: a dimension exceeds int32")
    return Cp, Rc, L


def _lib():
    from ._build import library

    lib = library("gather_segments")
    if not getattr(lib, "_vr_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vr_gather_segments_discrete.argtypes = (
            [p] * 8 + [i, i, i, f, f, i, i, p, p, p, p])
        lib.vr_gather_segments_analytic.argtypes = (
            [p] * 8 + [i, i, i, i, f, i, i, p, p, p, p])
        lib.vr_gather_segments_discrete.restype = i
        lib.vr_gather_segments_analytic.restype = i
        lib.vr_segments_error_string.argtypes = [i]
        lib.vr_segments_error_string.restype = ctypes.c_char_p
        lib._vr_typed = True
    return lib


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.vr_segments_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _table(pos_from, u, col6, ii):
    """(L, 8) f32 segment table: ax, ay, az, ux, uy, uz, col6, ii (32 B a
    segment, staged by the kernel as two float4)."""
    return torch.stack([pos_from[:, 0], pos_from[:, 1], pos_from[:, 2],
                        u[:, 0], u[:, 1], u[:, 2], col6, ii], dim=1)


_node_tables: dict = {}


def node_table(rule: str | None, nodes: int, device) -> torch.Tensor:
    """(2, max(nodes, 1)) f32 node fractions and weights of ``rule``: the
    midpoint fractions (j + 0.5) / nodes, or the Gauss-Legendre nodes and
    weights on [0, 1].  Built with numpy once per (rule, nodes, device)."""
    import numpy as np

    key = (rule, nodes, str(device))
    if key not in _node_tables:
        tab = np.zeros((2, max(nodes, 1)), np.float32)
        if rule == "midpoint":
            tab[0, :nodes] = [(j + 0.5) / nodes for j in range(nodes)]
        elif rule == "tangent":
            tab[0, :nodes], tab[1, :nodes] = sm.gauss01(nodes)
        _node_tables[key] = torch.as_tensor(tab, device=device)
    return _node_tables[key]


def _launch_args(px, py, pz, wm, lane_need):
    return [t.data_ptr() for t in (px, py, pz, wm, lane_need)]


def gather_segments_discrete_lanes(
        px, py, pz, wm, pos_from, pos_to, intensity, valid,
        light_ray_step_size, *, sphere_radius=None, lane_need=None,
        paired: bool = False) -> torch.Tensor:
    """Discrete (uncapped) sub-light gather over lane planes -> (Rc,) f32."""
    if lane_need is None:
        lane_need = lane_need_of(wm)
    Cp, Rc, L = _check(px, py, pz, wm, pos_from, pos_to, intensity, valid,
                       lane_need)
    if px.device.type == "cpu":
        return gather_segments_discrete_lanes_reference(
            px, py, pz, wm, pos_from, pos_to, intensity, valid,
            light_ray_step_size, sphere_radius=sphere_radius,
            lane_need=lane_need, paired=paired)
    if px.device.type != "cuda":
        raise ValueError(f"gather_segments: unsupported device {px.device}")
    if Cp * Rc >= 2**31:
        raise ValueError("gather_segments_discrete: Cp * Rc exceeds int32")
    dev = px.device
    out = torch.empty(Rc, dtype=torch.float32, device=dev)
    if Rc == 0:
        return out
    u, ns, ii, start, count = discrete_cols(pos_from, pos_to, intensity,
                                            valid, light_ray_step_size)
    table = _table(pos_from, u, ns.view(torch.float32), ii)
    first, meta = sublight_prefix(ns, start, count, paired)
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    terms = torch.empty((Cp, Rc), dtype=torch.float32, device=dev)
    wm = aligned(wm)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_gather_segments_discrete(
            *_launch_args(px, py, pz, wm, lane_need), table.data_ptr(),
            first.data_ptr(), meta.data_ptr(), L, Cp, Rc,
            f32(light_ray_step_size),
            f32(0.0 if sphere_radius is None else sphere_radius),
            int(sphere_radius is not None), int(paired), next_span.data_ptr(),
            terms.data_ptr(), out.data_ptr(), stream)
    _raise_on(lib, err, "gather_segments_discrete")
    launches["discrete"] += 1
    return out


def gather_segments_analytic_lanes(
        px, py, pz, wm, pos_from, pos_to, intensity, valid, *,
        sphere_radius=None, quad_nodes: int = 16, quad_rule: str = "midpoint",
        lane_need=None, paired: bool = False) -> torch.Tensor:
    """Analytic VRL / quadrature VBL gather over lane planes of fewer than
    2^31 samples -> (Rc,) f32."""
    if quad_rule not in ("midpoint", "tangent", "closed"):
        raise ValueError(f"unknown quadrature rule: {quad_rule!r}")
    if lane_need is None:
        lane_need = lane_need_of(wm)
    Cp, Rc, L = _check(px, py, pz, wm, pos_from, pos_to, intensity, valid,
                       lane_need)
    if px.device.type == "cpu":
        return gather_segments_analytic_lanes_reference(
            px, py, pz, wm, pos_from, pos_to, intensity, valid,
            sphere_radius=sphere_radius, quad_nodes=quad_nodes,
            quad_rule=quad_rule, lane_need=lane_need, paired=paired)
    if Cp * Rc >= 2**31:
        raise ValueError(f"gather_segments_analytic: {Cp} x {Rc} samples; "
                         f"the kernel takes fewer than 2^31")
    if px.device.type != "cuda":
        raise ValueError(f"gather_segments: unsupported device {px.device}")
    rule = None if sphere_radius is None else quad_rule
    nodes = 0 if rule is None else sm.effective_quad_nodes(rule, quad_nodes)
    if not 0 <= nodes <= MAX_NODES:
        raise ValueError(f"gather_segments_analytic: {nodes} quadrature "
                         f"nodes, the kernel takes 1..{MAX_NODES}")
    dev = px.device
    out = torch.empty(Rc, dtype=torch.float32, device=dev)
    if Rc == 0:
        return out
    u, length, ii, start, count = analytic_cols(pos_from, pos_to, intensity,
                                                valid)
    table = _table(pos_from, u, length, ii)
    meta = _meta(start, count, dev)
    nodes_t = node_table(rule, nodes, dev)
    next_span = torch.zeros(1, dtype=torch.int32, device=dev)
    terms = torch.empty((Cp, Rc), dtype=torch.float32, device=dev)
    wm = aligned(wm)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_gather_segments_analytic(
            *_launch_args(px, py, pz, wm, lane_need), table.data_ptr(),
            nodes_t.data_ptr(), meta.data_ptr(), L, Cp, Rc, nodes,
            f32(0.0 if sphere_radius is None else sphere_radius),
            _VARIANTS[rule], int(paired), next_span.data_ptr(),
            terms.data_ptr(), out.data_ptr(), stream)
    _raise_on(lib, err, "gather_segments_analytic")
    launches["analytic"] += 1
    return out
