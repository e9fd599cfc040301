#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volumerenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

  1. device    the card's name, power limit and compute capability;
  2. build     nvcc builds csrc/gather_lanes.cu, csrc/gather_segments.cu,
               csrc/gather_vpu.cu and csrc/gather_many.cu from this
               checkout, all at once; ptxas registers, spills and shared
               memory per kernel template;
  3. kernel    the point gather kernel against its plain PyTorch version at
               synthetic shapes (Cp 144, Rc 524288, L in {1, 37, 1000,
               2048}, point/sphere, exact/paired, plus edge cases; the
               paired tier against the exact and the paired plain
               versions);
  4. segkernel the two segment kernels against their plain versions at
               synthetic shapes (Cp 144, Rc 65536): discrete point/sphere x
               exact/paired and every analytic variant (the paired VRL
               one also against the exact plain version, at
               RTOL_PAIRED), with segments of
               ns = 0, zero length, ns % 4 != 0 and > 512 sub-lights, a
               range with start > 0 and an odd count, samples on a
               sub-light, at a Beam centre, inside a beam (q < r), and
               projecting outside [0, L]; the discrete ones again on a
               table of more sub-lights than one stage of the kernel holds;
  5. main      the bench config (1920x1080 cloud(n=96), Point/VPL,
               camera (0, 20, -75), light (0, 20, 20)) through
               Renderer(..., device=DEV) in both gather tiers: step(8)
               warm-up, then step(32) timed; kernel launches counted;
  6. shapes    the point kernel against its plain version on the live
               view's widest band and one frame's lights (the paired tier
               against the exact and the paired plain versions);
  7. sphere    a few Sphere/VSL frames at the bench config;
  8. raybeam   the bench config for RAY discrete exact and paired, RAY
               analytic exact and paired, BEAM discrete exact and BEAM
               analytic closed paired: step(8) warm-up, then step(16) timed;
               launches of each segment kernel per frame;
  9. segshapes each segment kernel against its plain version on one
               frame's segments, on 65,536 lanes of the live widest band
               and on the whole widest band (as a frame launches it; the
               paired discrete and VRL kernels also against the exact
               plain version, at RTOL_PAIRED);
 10. slotkernel the 16 slot-kernel templates (csrc/gather_vpu.cu) against
               their plain versions at synthetic (R, C) = (144, 65536) slot
               planes, about half of them at zero weight, with the segment
               edge cases above, the point kernel over a range from 3 of
               1,093 lights and over 2,048 slots (the paired point and VRL
               kernels also against the exact plain version);
 11. uncached  the bench config with compact_view=False (the slots
               ViewCache) for POINT exact and paired, RAY discrete exact
               and paired, RAY analytic exact and paired, BEAM discrete
               exact and BEAM analytic closed paired: step(8) warm-up, step(8)
               timed, slot-kernel launches per frame, peak memory, the
               image against a cached session at the same frame (rtol
               1e-5, atol 1e-7); and one uncached step (march + shade) per
               frame for POINT exact;
 12. slotshapes each run's slot kernel against its plain version on one
               frame's lights, on 65,536 rays of the live 1080p ViewCache
               and then on the whole ViewCache, as a frame launches it
               (the paired point, discrete and VRL kernels also against the
               exact plain version, at RTOL_PAIRED), and the same launch
               over an empty range (full_scan_ms: the live-sample scan
               alone);
 13. drag      the interactive viewer's setup at the bench config (RAY,
               motion_mode="coarse", first_frame_uncached, settle_chunks
               4): the first frame (warm), coarse drag frames, the settle
               ticks, the merged view against a blocking rebuild (rtol
               2e-6), truncated drag frames (motion_cap 16), each drag
               path's view build alone, and
               gather_stride=3 centroid and gauss2 frames with their
               windowed SSIM against the exact image (printed only);
 14. path      PATH at the bench config (scripts/bench_matrix.py:62-66,
               158: the RenderParams and StaticConfig defaults), then with
               path_stride=3 and with path_frame_batch=4: step(2) warm-up
               (the PathView bake included), step(4) timed, host syncs per
               frame, the view's bytes and a re-bake's ms (equal to the
               view), peak memory, one frame split by stage with CUDA
               events (the camera segment's replay, then per segment the
               alive count, the compaction and sort, the walk); for the
               first run, a cached frame against the uncached render_frame
               and render_frames of 4 against 4 render_frame calls, bit for
               bit;
     pathdrag  PATH with motion_mode="coarse": the first frame, two drag
               frames (no re-bake) and the frame that re-bakes, each on the
               host clock;
 15. goldens   the golden scene (64x64 cloud(n=48)) for Point, Sphere, Ray
               and Beam through the compact view and the slots view, and
               for Path cached and uncached, against tests/goldens at
               windowed SSIM >= 0.995 and max abs error < 5e-3;
 16. manykernel the many-light kernel (csrc/gather_many.cu) against its plain
               version at synthetic (144, 65536) planes, about half of them
               at zero weight, point and sphere, for 2,049 valid slots,
               16,384 all valid, 16,384 at random 80% validity and 100,000
               with 50 valid in the first or only in the last tile, with a
               sample on a light (a sphere's centre);
 17. manylight the bench config through the many-light route: RAY and BEAM
               segment_mode="discrete_expanded" at 16,384 slots (compact
               view), RAY discrete_expanded through the slots view, POINT and
               SPHERE at light_capacity = max_lights = 100,000: step(4)
               warm-up, step(8) timed, many-kernel launches per frame, the
               compaction's dropped count, peak memory, and the image
               against the same session in a mode off this route
               ("discrete": windowed SSIM >= 0.995 and max abs < 5e-3;
               POINT/SPHERE at light_capacity 1000: max abs <= 1e-5);
 18. manyshapes after each manylight run, the many-light kernel against its
               plain version on one frame's lights (the expanded sub-lights
               for Ray/Beam), on a timed slice (65,536 lanes of the widest
               band, or 65,536 rays of the ViewCache) and then on the whole
               widest band or the whole ViewCache, as a frame launches it.

The lines before the last are the card's name and power limit as
nvidia-smi gives them and a JSON object of the kernels, one entry for each
run of phases 5, 8, 11 and 17 (PATH runs no kernel; the many-light
entries after the first two, gather_many[point,exact] and
gather_many[sphere,exact], add their run's label to the name; each entry
with its launches in that run and its bound: the larger of its f32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s, counted for this
run's inputs; the point lane kernel at the widest band, the others at the
whole shape a frame launches: the widest band or the whole ViewCache); the
last line is
{"ok": true, "device": {...}}.  Without CUDA, or outside a checkout of the
repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "volumerenderer_tpu_torch"

# Tolerances of the kernel against its plain version, per lane, relative.
# The plain versions sum in the kernels' order; the rounding of the terms
# differs where a kernel fuses a multiply-add or takes an approximate
# reciprocal (the staged sums of csrc/gather_terms.cuh).
RTOL_EXACT = 2e-5
RTOL_PAIRED = 3e-5  # paired tier against the exact plain version
TPU_CHECKSUM = 57344.9  # accum checksum of the bench config, paired tier, TPU run
BENCH_W, BENCH_H = 1920, 1080
PLAIN_ELEMS = 1 << 26  # (Cp, lanes, L) elements per chunk of the plain version
SYNTH_CP, SYNTH_RC = 144, 524288  # synthetic planes: the main path's cap, one band
SEG_RC = 65536  # lanes of the segment kernels' synthetic and live comparisons
# Segment kernels against their plain versions (exact against exact, paired
# against paired: the same terms in the same order).
RTOL_SEGMENT = 2e-5
RAYBEAM_RUNS = (  # (algorithm, segment_mode, segment_eval, quadrature rule)
    ("RAY", "discrete", "exact", "midpoint"),
    ("RAY", "discrete", "paired", "midpoint"),
    ("RAY", "analytic", "exact", "midpoint"),
    ("RAY", "analytic", "paired", "midpoint"),
    ("BEAM", "discrete", "exact", "midpoint"),
    ("BEAM", "analytic", "paired", "closed"),
)
DEV = "cuda"
SLOT_RAYS = 65536  # rays of the live ViewCache slice of the slot comparisons
MANY_RUNS = (  # (label, algorithm, config, the reference session's config)
    ("RAY discrete_expanded compact", "RAY",
     dict(segment_mode="discrete_expanded"), dict(segment_mode="discrete")),
    ("BEAM discrete_expanded compact", "BEAM",
     dict(segment_mode="discrete_expanded"), dict(segment_mode="discrete")),
    ("RAY discrete_expanded slots", "RAY",
     dict(segment_mode="discrete_expanded", compact_view=False),
     dict(segment_mode="discrete", compact_view=False)),
    ("POINT light_capacity 100000", "POINT", dict(light_capacity=100_000),
     dict()),
    ("SPHERE light_capacity 100000", "SPHERE", dict(light_capacity=100_000),
     dict()),
)
MANY_SLOTS = (  # (L, validity) of the manykernel phase
    (2049, "all"), (16384, "all"), (16384, "random"), (100_000, "first"),
    (100_000, "last"))
UNCACHED_RUNS = (  # (algorithm, gather_eval, segment_mode, segment_eval, rule)
    ("POINT", "exact", "discrete", "exact", "midpoint"),
    ("POINT", "paired", "discrete", "exact", "midpoint"),
    ("RAY", "exact", "discrete", "exact", "midpoint"),
    ("RAY", "exact", "discrete", "paired", "midpoint"),
    ("RAY", "exact", "analytic", "exact", "midpoint"),
    ("RAY", "exact", "analytic", "paired", "midpoint"),
    ("BEAM", "exact", "discrete", "exact", "midpoint"),
    ("BEAM", "exact", "analytic", "paired", "closed"),
)
PATH_RUNS = (  # (label, StaticConfig fields, Renderer attributes)
    ("path", {}, {}),
    ("pathstride", {"path_stride": 3}, {}),
    ("pathbatch", {}, {"path_frame_batch": 4}),
)
# The card's peaks (H100 SXM data sheet, at a 700 W limit): f32 outside
# the tensor cores, and device memory.  The 67 TFLOP/s counts a fused
# multiply-add as two operations (132 SMs x 128 lanes x 2 x ~1.98 GHz), so
# code that fuses nothing reaches at most about half of it.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per term, counted from csrc/gather_terms.cuh (each add,
# subtract, multiply, divide, square root, min, max, compare and select
# one): per (sample, light) for point and sphere lights, per (sample,
# segment) for the closed forms, and (per-segment setup, per node) for the
# quadratures.  A discrete segment's sub-lights are point (Ray) or sphere
# (Beam) lights: their sums count the point or sphere term per (sample,
# sub-light), and the expansion (a convert, a multiply, 3 multiplies and 3
# adds) once per sub-light, whichever kernel does it and however often.
TERM_OPS = {"point": 13, "sphere": 18, "vrl": 52, "vbl-closed": 100}
EXPAND_OPS = 8
NODE_OPS = {"vbl-midpoint": (17, 15), "vbl-tangent": (50, 20)}
REPLACES = {
    "many": "volumerenderer_tpu/ops/pallas/gather_kernel.py:49",
    "lanes": "volumerenderer_tpu/ops/pallas/gather_lanes.py:63",
    "discrete": "volumerenderer_tpu/ops/pallas/gather_lanes.py:156",
    "analytic": "volumerenderer_tpu/ops/pallas/gather_lanes.py:234",
    "vpu": "volumerenderer_tpu/ops/pallas/gather_vpu.py:38",
    "segment_discrete": "volumerenderer_tpu/ops/pallas/gather_vpu.py:646",
    "segment_analytic": "volumerenderer_tpu/ops/pallas/gather_vpu.py:745",
    "segment_sphere": "volumerenderer_tpu/ops/pallas/gather_vpu.py:568",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    """Max over lanes of |got - want| / |want| (0 where both are 0)."""
    import torch

    diff = (got.double() - want.double()).abs()
    den = want.double().abs()
    rel = torch.where(den > 0, diff / torch.clamp(den, min=1e-300),
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def cuda_timed(fn, reps: int = 1):
    """(last result, mean ms per call) of ``fn`` over ``reps`` calls,
    timed by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the operations at the f32 peak and the bytes at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sublights(segs, step) -> int:
    """The discrete sub-lights of a segment table (0 outside the valid
    range), from this run's table."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    return int(gs.discrete_cols(*segs, step)[1].sum())


def ops_per_sample(variant: str, lights=None, segs=None, step=0.3,
                   nodes=16) -> int:
    """f32 operations one used sample costs: ``lights`` the light count for
    point/sphere; ``segs`` (pos_from, pos_to, intensity, valid) for the
    segment variants (discrete: the point or sphere term per sub-light)."""
    if variant in ("point", "sphere"):
        return int(lights) * TERM_OPS[variant]
    if variant.startswith("discrete"):
        term = "sphere" if variant == "discrete-beam" else "point"
        return sublights(segs, step) * TERM_OPS[term]
    count = int(segs[3].sum())
    if variant in NODE_OPS:
        setup, per_node = NODE_OPS[variant]
        return count * (setup + nodes * per_node)
    return count * TERM_OPS[variant]


def variant_of(algo_name: str, mode: str, rule: str) -> str:
    if algo_name in ("POINT", "SPHERE"):
        return algo_name.lower()
    if mode != "analytic":
        return "discrete-" + algo_name.lower()
    return "vrl" if algo_name == "RAY" else f"vbl-{rule}"


def call_ops(variant: str, segs=None, step=0.3) -> int:
    """f32 operations a call costs once, whatever its samples: the
    sub-light expansion of the discrete variants."""
    if variant.startswith("discrete"):
        return sublights(segs, step) * EXPAND_OPS
    return 0


def lane_bound(wm, lane_need, per_sample_ops, table_bytes, once_ops=0):
    """Bound of a lane-kernel call: the terms of the live samples (w != 0;
    a zero weight adds 0), the used samples' weights (j < lane_need) and
    the live ones' positions read once, lane_need and the per-lane output
    8 B a lane."""
    Cp, Rc = wm.shape
    used = int(lane_need.clamp(max=Cp).sum())
    live = int((wm != 0).sum())
    return bound(live * per_sample_ops + once_ops,
                 4 * used + 12 * live + 8 * Rc + table_bytes)


def slot_bound(wm, per_sample_ops, table_bytes, once_ops=0):
    """Bound of a slot-kernel call: every weight read and every output
    written (8 B a sample), the live samples' positions (12 B)."""
    N = wm.numel()
    live = int((wm != 0).sum())
    return bound(live * per_sample_ops + once_ops,
                 8 * N + 12 * live + table_bytes)


def phase_device():
    import torch

    smi = nvidia_smi_line()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         capability=f"{cap[0]}.{cap[1]}", count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    if cap < (9, 0):
        raise RuntimeError(f"the kernels target sm_90a; this card is sm_{cap[0]}{cap[1]}")
    return smi


def phase_build():
    from volumerenderer_tpu_torch.ops.kernels import _build

    names = ("gather_lanes", "gather_segments", "gather_vpu", "gather_many")
    t0 = time.perf_counter()
    _build.build(names)  # one nvcc per source, started together
    dt = time.perf_counter() - t0
    for name in names:
        _build.library(name)
        ptxas = [ln.strip() for ln in _build.build_logs[name].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit("build", kernel=name, seconds=dt, ptxas=ptxas)


def synthetic_case(Cp, Rc, L, start, count, seed, dev):
    """Planes and lights of one synthetic case, from a seed, on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    # Lane needs sorted descending, with zeros at the tail.
    need = torch.sort(torch.randint(0, Cp + 1, (Rc,), generator=gen,
                                    device=dev), descending=True).values
    need[Rc - Rc // 8:] = 0
    planes = [randn(Cp, Rc) * 8 + 15 for _ in range(3)]
    w = rand(Cp, Rc) * 0.01
    w = torch.where(torch.arange(Cp, device=dev)[:, None] < need[None, :], w, 0.0)
    lpos = randn(L, 3) * 8 + 15
    lint = rand(L) * 20
    return planes + [w], lpos, lint, need.to(torch.int32), start, count


def phase_kernel():
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl

    dev = torch.device(DEV)
    Cp, Rc = SYNTH_CP, SYNTH_RC
    cases = [(L, 0, L) for L in (1, 37, 1000, 2048)]
    cases += [(37, 5, 30), (1000, 3, 997 - 2), (0, 0, 0)]  # start>0, count%4
    for ci, (L, start, count) in enumerate(cases):
        planes, lpos, lint, need, s, c = synthetic_case(
            Cp, Rc, L, start, count, 100 + ci, dev)
        for sphere in (False, True):
            kw = dict(sphere=sphere, radius=0.3, lane_need=need)
            ref, plain_ms = cuda_timed(lambda: gl.gather_lanes_reference(
                *planes, lpos, lint, s, c, max_elems=PLAIN_ELEMS, **kw))
            for paired in (False, True):
                run = lambda: gl.gather_lanes(*planes, lpos, lint, s, c,
                                              paired=paired, **kw)
                run()  # first launch outside the timing
                got, ms = cuda_timed(run, 3)
                err = rel_err(got, ref)
                tol = RTOL_PAIRED if paired else RTOL_EXACT
                same_tier = None
                if paired:  # the paired plain version: the levers alone
                    same_tier = rel_err(got, gl.gather_lanes_reference(
                        *planes, lpos, lint, s, c, paired=True,
                        max_elems=PLAIN_ELEMS, **kw))
                emit("kernel", L=L, start=s, count=c, sphere=sphere,
                     paired=paired, Cp=Cp, Rc=Rc, max_rel_err=err, tol=tol,
                     same_tier_max_rel_err=same_tier, ms=ms,
                     plain_exact_ms=plain_ms)
                if not (err <= tol and (same_tier or 0.0) <= RTOL_EXACT):
                    raise AssertionError(
                        f"kernel vs plain: rel err {err:.3g} > {tol:g} or "
                        f"{same_tier} > {RTOL_EXACT:g} in the same tier "
                        f"(L={L} start={s} count={c} sphere={sphere} "
                        f"paired={paired})")
        del planes
        torch.cuda.empty_cache()


def segment_case(Cp, Rc, seed, dev, sphere_radius=0.3, step=0.3):
    """Planes and a segment table of one synthetic case, from a seed, on the
    card, with the edge cases of the segment kernels built in: segments of
    zero length, of ns = 0 (shorter than a step), ns % 4 != 0 and more
    than 512 sub-lights; the valid range starts at 1 and holds an odd
    count; some samples sit on a sub-light or at a Beam centre, inside a
    beam (closest approach < radius) or far along a segment's line."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    L = 24
    pos_from = randn(L, 3) * 8 + 15
    pos_to = pos_from + randn(L, 3) * 4
    pos_to[2] = pos_from[2]  # zero length
    pos_to[3] = pos_from[3] + torch.tensor([0.2, 0.0, 0.0], device=dev)  # ns = 0
    pos_to[4] = pos_from[4] + torch.tensor([0.0, 1.6, 0.0], device=dev)  # ns = 5
    pos_to[5] = pos_from[5] + torch.tensor([160.0, 0.0, 0.0], device=dev)  # > 512
    intensity = rand(L) * 30
    valid = torch.zeros(L, dtype=torch.bool, device=dev)
    valid[1:20] = True  # start 1, count 19
    need = torch.sort(torch.randint(0, Cp + 1, (Rc,), generator=gen,
                                    device=dev), descending=True).values
    need[Rc - Rc // 8:] = 0
    planes = [randn(Cp, Rc) * 8 + 15 for _ in range(3)]
    u = (pos_to[1] - pos_from[1]) / torch.linalg.vector_norm(
        pos_to[1] - pos_from[1])
    special = torch.stack([
        pos_from[1],  # on sub-light 0, the Beam centre of segment 1
        pos_from[1] + u * (3 * step),  # near sub-light 3
        pos_from[1] + u * 0.5 + sphere_radius * 0.5 * torch.tensor(  # q = r/2
            [u[1], -u[0], 0.0], device=dev) / torch.linalg.vector_norm(u[:2]),
        pos_from[1] - u * 50.0,  # projects before the segment
        pos_to[1] + u * 50.0,  # projects past it
    ])
    for i, p in enumerate(special):
        for c in range(3):
            planes[c][0, i] = p[c]
    w = rand(Cp, Rc) * 0.01
    w = torch.where(torch.arange(Cp, device=dev)[:, None] < need[None, :],
                    w, 0.0)
    return planes + [w], (pos_from, pos_to, intensity, valid), need.to(
        torch.int32)


def segment_variants():
    """(label, kernel, keyword arguments) of every segment-kernel variant."""
    out = []
    for sphere in (False, True):
        for paired in (False, True):
            out.append((f"discrete[{'beam' if sphere else 'ray'},"
                        f"{'paired' if paired else 'exact'}]", "discrete",
                        dict(sphere_radius=0.3 if sphere else None,
                             paired=paired)))
    rules = [("vrl", None, "midpoint")] + [
        (f"vbl-{r}", 0.3, r) for r in ("midpoint", "tangent", "closed")]
    for name, radius, rule in rules:
        for paired in (False, True):
            out.append((f"analytic[{name},{'paired' if paired else 'exact'}]",
                        "analytic", dict(sphere_radius=radius, quad_rule=rule,
                                         quad_nodes=16, paired=paired)))
    return out


def held_against_exact(kind: str, kw: dict, live: bool = True) -> bool:
    """Whether a paired kernel is also held against the exact plain
    version at RTOL_PAIRED: the point slot kernel and the closed-form VRL
    everywhere, the discrete kernels at a frame's live shapes (the
    synthetic tables put samples inside beams and on sub-lights, where the
    paired Beam tier reads 3.4e-5 from exact; the VBL rules' pairing
    reorders terms that cancel, and the JAX suite bounds it at 2e-4)."""
    return bool(kw.get("paired")) and (
        kind == "vpu" or (kind == "discrete" and live)
        or (kind == "analytic" and kw.get("sphere_radius") is None))


def lane_exact_plain(kind, planes, segs, need, step, kw):
    """The exact plain version of a lane segment kernel's call."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    if kind == "discrete":
        return gs.gather_segments_discrete_lanes_reference(
            *planes, *segs, step, lane_need=need,
            sphere_radius=kw["sphere_radius"], max_elems=PLAIN_ELEMS)
    return gs.gather_segments_analytic_lanes_reference(
        *planes, *segs, lane_need=need, max_elems=PLAIN_ELEMS // 16)


def check_vs_exact(what: str, err) -> None:
    if err is not None and not err <= RTOL_PAIRED:
        raise AssertionError(f"{what} paired vs the exact plain version: "
                             f"rel err {err:.3g} > {RTOL_PAIRED:g}")


def run_segment_kernel(kind, planes, segs, need, step, kw, reps=3):
    """The kernel and its plain version on the same inputs: returns
    (max rel err, max abs err, kernel ms, plain ms, kernel output)."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    if kind == "discrete":
        fn = lambda: gs.gather_segments_discrete_lanes(
            *planes, *segs, step, lane_need=need, **kw)
        ref_fn = lambda: gs.gather_segments_discrete_lanes_reference(
            *planes, *segs, step, lane_need=need, max_elems=PLAIN_ELEMS, **kw)
    else:
        fn = lambda: gs.gather_segments_analytic_lanes(
            *planes, *segs, lane_need=need, **kw)
        ref_fn = lambda: gs.gather_segments_analytic_lanes_reference(
            *planes, *segs, lane_need=need, max_elems=PLAIN_ELEMS // 16, **kw)
    fn()  # first launch outside the timing
    got, ms = cuda_timed(fn, reps)
    ref, plain_ms = cuda_timed(ref_fn)
    return rel_err(got, ref), float((got - ref).abs().max()), ms, plain_ms, got


def phase_segment_kernel():
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    dev = torch.device(DEV)
    planes, segs, need = segment_case(SYNTH_CP, SEG_RC, 7, dev)
    # A second table for the discrete kernel: 11 valid segments of 318
    # sub-lights (3,498), more than one stage of its sub-light table holds,
    # a segment split between two stages.  They run through the samples'
    # cloud, so that samples sit near sub-lights and the long sums hold
    # near-singular terms.
    gen = torch.Generator(device=dev).manual_seed(8)
    pos_from = torch.randn((12, 3), generator=gen, device=dev) * 8 + 15
    u = torch.randn((12, 3), generator=gen, device=dev)
    pos_to = pos_from + 95.5 * u / torch.linalg.vector_norm(u, dim=1,
                                                             keepdim=True)
    long_segs = (pos_from, pos_to, torch.rand(12, generator=gen, device=dev)
                 * 30, torch.arange(12, device=dev) >= 1)
    runs = [(label, kind, kw, segs) for label, kind, kw in segment_variants()]
    runs += [(label + " long table", kind, kw, long_segs)
             for label, kind, kw in segment_variants() if kind == "discrete"]
    n0 = dict(gs.launches)
    for label, kind, kw, table in runs:
        err, abs_err, ms, plain_ms, got = run_segment_kernel(
            kind, planes, table, need, 0.3, kw)
        vs_exact = None
        if held_against_exact(kind, kw, live=False):
            vs_exact = rel_err(got, lane_exact_plain(kind, planes, table,
                                                     need, 0.3, kw))
        emit("segkernel", variant=label, Cp=SYNTH_CP, Rc=SEG_RC,
             segments=int(table[3].sum()),
             sublights=sublights(table, 0.3) if kind == "discrete" else None,
             max_rel_err=err, max_abs_err=abs_err, tol=RTOL_SEGMENT, ms=ms,
             plain_ms=plain_ms, vs_exact_plain_max_rel_err=vs_exact)
        if not err <= RTOL_SEGMENT:
            raise AssertionError(f"segment kernel {label} vs plain: rel err "
                                 f"{err:.3g} > {RTOL_SEGMENT:g}")
        check_vs_exact(f"segment kernel {label}", vs_exact)
    gs.launches.update(n0)  # comparison launches are not main-path launches
    del planes
    torch.cuda.empty_cache()


def bench_renderer(tier: str, algorithm, **config):
    import volumerenderer_tpu_torch as vt

    grid = vt.grid.procedural.cloud(n=96, device=DEV)
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 20.0, -75.0), light_source_world_pos=(0.0, 20.0, 20.0))
    config = vt.StaticConfig(width=BENCH_W, height=BENCH_H, gather_eval=tier,
                             **config)
    return vt.Renderer(grid, config, params, algorithm=algorithm,
                       device=DEV)


def phase_main(tier: str):
    """The bench config in one tier, then the kernel against its plain
    version on this run's live bands; returns the kernel's figures."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = bench_renderer(tier, vt.Algorithm.POINT)
    t0 = time.perf_counter()
    r.step(8)  # view build + one 8-frame batch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = 32
    syncs0 = r.host_syncs
    gl.launches = 0
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gl.launches
    img = r.state.accum
    checksum = float(img.double().sum())
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"{tier}: image not finite or all zero")
    if launches == 0:
        raise AssertionError(f"{tier}: the main path launched no kernel")
    fields = dict(
        tier=tier, ms_per_frame=dt / frames * 1e3,
        mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6,
        warmup_s=warm_s, accum_checksum=checksum,
        launches=launches, launches_per_frame=launches / frames,
        view_exact=bool(r.view_exact),
        host_syncs_per_batch=(r.host_syncs - syncs0) / (frames / r.frame_batch),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        bands=[tuple(b.wx.shape) for b in r._view.bands],
        lights_last_frame=int(r.lights.count[0]),
    )
    if tier == "paired":
        fields["tpu_checksum"] = TPU_CHECKSUM
        fields["checksum_rel_diff_vs_tpu"] = (
            checksum - TPU_CHECKSUM) / TPU_CHECKSUM
    emit("main", **fields)
    return dict(launches=launches, **phase_shapes(r, tier))


def phase_shapes(r, tier: str):
    """The kernel against its plain version on the live view's widest
    band and the next frame's lights."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.render import photon

    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    lights = photon.generate_lights(
        r.grid, r.params, [r.state.frame_count + 1], r.config,
        max_steps=r._max_steps)
    valid = lights.valid[0].to(torch.int32)
    start, count = torch.argmax(valid), valid.sum()
    args = (band.wx, band.wy, band.wz, band.weight, lights.pos_to[0],
            lights.intensity[0], start, count)
    kw = dict(sphere=False, lane_need=band.lane_need)
    paired = tier == "paired"
    n0 = gl.launches
    gl.gather_lanes(*args, paired=paired, **kw)  # outside the timing
    got, ms = cuda_timed(lambda: gl.gather_lanes(*args, paired=paired, **kw), 5)
    gl.launches = n0  # comparison launches are not main-path launches
    ref, plain_ms = cuda_timed(lambda: gl.gather_lanes_reference(
        *args, max_elems=PLAIN_ELEMS, **kw))  # the exact plain version
    err = rel_err(got, ref)
    abs_err = float((got - ref).abs().max())
    tol = RTOL_PAIRED if paired else RTOL_EXACT
    same_tier = None
    if paired:  # the paired plain version: the levers alone
        same_tier = rel_err(got, gl.gather_lanes_reference(
            *args, paired=True, max_elems=PLAIN_ELEMS, **kw))
    bound_ms, bound_by = lane_bound(
        band.weight, band.lane_need, ops_per_sample("point", int(count)),
        16 * int(count))
    emit("shapes", tier=tier, Cp=band.wx.shape[0], Rc=band.wx.shape[1],
         lights=int(count), max_rel_err=err, max_abs_err=abs_err, tol=tol,
         same_tier_max_rel_err=same_tier, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by)
    if not (err <= tol and (same_tier or 0.0) <= RTOL_EXACT):
        raise AssertionError(f"{tier}: kernel vs plain at the main "
                             f"path's shapes: rel err {err:.3g} > {tol:g}, "
                             f"or {same_tier} > {RTOL_EXACT:g} in the same "
                             "tier")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_sphere():
    import torch

    import volumerenderer_tpu_torch as vt

    r = bench_renderer("exact", vt.Algorithm.SPHERE)
    r.step(8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.step(8)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError("sphere: image not finite or all zero")
    emit("sphere", ms_per_frame=dt / 8 * 1e3, frames=r.state.frame_count,
         accum_checksum=float(img.double().sum()))


def phase_raybeam(algo_name: str, mode: str, tier: str, rule: str):
    """One Ray/Beam run of the bench config: step(8) warm-up, step(16)
    timed; returns the run's segment-kernel launches and its renderer."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = bench_renderer("exact", vt.Algorithm[algo_name], segment_mode=mode,
                       segment_eval=tier, beam_quadrature_rule=rule)
    t0 = time.perf_counter()
    r.step(8)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = 16
    syncs0 = r.host_syncs
    for k in gs.launches:
        gs.launches[k] = 0
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gs.launches)
    kind = "analytic" if mode == "analytic" else "discrete"
    label = f"{algo_name} {mode} {tier}" + (f" {rule}" if kind == "analytic"
                                            and algo_name == "BEAM" else "")
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"{label}: image not finite or all zero")
    if launches[kind] == 0:
        raise AssertionError(f"{label}: the main path launched no {kind} "
                             "segment kernel")
    emit("raybeam", run=label, ms_per_frame=dt / frames * 1e3,
         mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6, warmup_s=warm_s,
         launches=launches,
         launches_per_frame={k: v / frames for k, v in launches.items()},
         host_syncs_per_batch=(r.host_syncs - syncs0) / (frames / r.frame_batch),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         accum_checksum=float(img.double().sum()),
         segments_last_frame=int(r.lights.count[0]))
    return kind, launches[kind], r


def phase_segment_shapes(r, algo_name: str, mode: str, tier: str, rule: str):
    """The run's segment kernel against its plain version on the next
    frame's segments, on SEG_RC lanes of the live widest band, then on the
    whole widest band, as one frame's launch takes it."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.render import photon

    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    lanes = slice(0, min(SEG_RC, band.wx.shape[1]))
    full = (band.wx, band.wy, band.wz, band.weight)
    planes = [t[:, lanes].contiguous() for t in full]
    need = band.lane_need[lanes].contiguous()
    lights = photon.generate_lights(
        r.grid, r.params, [r.state.frame_count + 1], r.config,
        max_steps=r._max_steps)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    kind = "analytic" if mode == "analytic" else "discrete"
    kw = dict(sphere_radius=r.params.beam_radius if algo_name == "BEAM"
              else None, paired=tier == "paired")
    if kind == "analytic":
        kw.update(quad_rule=rule, quad_nodes=r.config.beam_quadrature_nodes)
    step = r.params.light_ray_step_size
    n0 = dict(gs.launches)
    err, abs_err, ms, plain_ms, _ = run_segment_kernel(
        kind, planes, segs, need, step, kw, reps=5)
    full_err, full_abs, full_ms, full_plain_ms, got = run_segment_kernel(
        kind, full, segs, band.lane_need, step, kw)
    gs.launches.update(n0)  # comparison launches are not main-path launches
    vs_exact = None
    if held_against_exact(kind, kw):  # the paired tier against exact
        vs_exact = rel_err(got, lane_exact_plain(kind, full, segs,
                                                 band.lane_need, step, kw))
    del got
    variant = variant_of(algo_name, mode, rule)
    per_sample = ops_per_sample(variant, segs=segs, step=step,
                                nodes=r.config.beam_quadrature_nodes)
    once = call_ops(variant, segs=segs, step=step)
    table = 32 * segs[0].shape[0]
    bound_ms, bound_by = lane_bound(planes[3], need, per_sample, table, once)
    full_bound_ms, full_bound_by = lane_bound(full[3], band.lane_need,
                                              per_sample, table, once)
    emit("segshapes", algorithm=algo_name, mode=mode, tier=tier,
         Cp=planes[0].shape[0], Rc=planes[0].shape[1],
         segments=int(lights.count[0]),
         sublights=sublights(segs, step) if kind == "discrete" else None,
         max_rel_err=err, max_abs_err=abs_err, tol=RTOL_SEGMENT, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         full_shape=list(full[0].shape),
         full_used_samples=int(band.lane_need.clamp(max=full[0].shape[0]).sum()),
         full_live_samples=int((full[3] != 0).sum()),
         full_max_rel_err=full_err, full_max_abs_err=full_abs,
         full_ms=full_ms, full_plain_ms=full_plain_ms,
         full_bound_ms=full_bound_ms, full_bound_by=full_bound_by,
         full_vs_exact_plain_max_rel_err=vs_exact)
    if not max(err, full_err) <= RTOL_SEGMENT:
        raise AssertionError(f"{algo_name} {mode} {tier}: segment kernel vs "
                             f"plain at live shapes: rel err {err:.3g} "
                             f"(slice), {full_err:.3g} (whole) > "
                             f"{RTOL_SEGMENT:g}")
    check_vs_exact(f"{algo_name} {mode}", vs_exact)
    return dict(max_abs_err=max(abs_err, full_abs), ms=full_ms,
                plain_ms=full_plain_ms, bound_ms=full_bound_ms,
                bound_by=full_bound_by, library_ms=None)


def slot_variants():
    """(label, kind, keyword arguments) of the 16 slot-kernel templates."""
    out = []
    for sphere in (False, True):
        for paired in (False, True):
            out.append((f"vpu[{'sphere' if sphere else 'point'},"
                        f"{'paired' if paired else 'exact'}]", "vpu",
                        dict(sphere=sphere, radius=0.3, paired=paired)))
    for label, kind, kw in segment_variants():
        out.append((label.replace("discrete[", "segment_discrete[").replace(
            "analytic[vrl", "segment_analytic[vrl").replace(
            "analytic[vbl", "segment_sphere[vbl"), kind, kw))
    return out


def slot_exact_plain(kind, planes, segs, lights, step, kw):
    """The exact plain version of a slot kernel's call."""
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    if kind == "vpu":
        return gv.gather_vpu_reference(*planes, *lights, sphere=kw["sphere"],
                                       radius=kw.get("radius", 0.0),
                                       max_elems=PLAIN_ELEMS)
    if kind == "discrete":
        return gv.gather_segments_discrete_reference(
            *planes, *segs, step, sphere_radius=kw["sphere_radius"],
            max_elems=PLAIN_ELEMS)
    return gv.gather_segments_analytic_reference(
        *planes, *segs, max_elems=PLAIN_ELEMS // 16)


def slot_call(kind, planes, segs, lights, step, kw, plain=False):
    """A slot kernel's call on these inputs (``plain``: its plain
    version's), as a function of no arguments."""
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    if kind == "vpu":
        if plain:
            return lambda: gv.gather_vpu_reference(
                *planes, *lights, max_elems=PLAIN_ELEMS, **kw)
        return lambda: gv.gather_vpu(*planes, *lights, **kw)
    if kind == "discrete":
        if plain:
            return lambda: gv.gather_segments_discrete_reference(
                *planes, *segs, step, max_elems=PLAIN_ELEMS, **kw)
        return lambda: gv.gather_segments_discrete(*planes, *segs, step, **kw)
    if plain:
        return lambda: gv.gather_segments_analytic_reference(
            *planes, *segs, max_elems=PLAIN_ELEMS // 16, **kw)
    return lambda: gv.gather_segments_analytic(*planes, *segs, **kw)


def run_slot_kernel(kind, planes, segs, lights, step, kw, reps=3):
    """A slot kernel and its plain version on the same inputs: returns
    (max rel err, max abs err, kernel ms, plain ms, kernel output)."""
    fn = slot_call(kind, planes, segs, lights, step, kw)
    ref_fn = slot_call(kind, planes, segs, lights, step, kw, plain=True)
    fn()  # first launch outside the timing
    got, ms = cuda_timed(fn, reps)
    ref, plain_ms = cuda_timed(ref_fn)
    if not bool((got[planes[3] == 0] == 0).all()):
        raise AssertionError("slot kernel: a zero-weight sample is not 0")
    return rel_err(got, ref), float((got - ref).abs().max()), ms, plain_ms, got


def phase_slot_kernel():
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    dev = torch.device(DEV)
    planes, segs, _need = segment_case(SYNTH_CP, SEG_RC, 11, dev)
    _, lpos, lint, _, _, _ = synthetic_case(8, 8, 1100, 0, 0, 12, dev)
    _, lpos2, lint2, _, _, _ = synthetic_case(8, 8, 2048, 0, 0, 13, dev)
    # A range from 3 of 1,093 lights (count % 4 = 1), and 2,048 slots, all
    # valid: SMEM_LIGHT_LIMIT, one stage of the kernel's table.
    light_sets = ((lpos, lint, 3, 1093), (lpos2, lint2, 0, 2048))
    n0 = dict(gv.launches)
    zero = float((planes[3] == 0).double().mean())
    runs = [(label, kind, kw, light_set) for label, kind, kw in slot_variants()
            for light_set in (light_sets if kind == "vpu" else light_sets[:1])]
    for label, kind, kw, light_set in runs:
        err, abs_err, ms, plain_ms, got = run_slot_kernel(
            kind, planes, segs, light_set, 0.3, kw)
        vs_exact = None
        if held_against_exact(kind, kw, live=False):
            vs_exact = rel_err(got, slot_exact_plain(kind, planes, segs,
                                                     light_set, 0.3, kw))
        tol = slot_tol(kind, kw)
        emit("slotkernel", variant=label, R=SYNTH_CP, C=SEG_RC,
             lights=light_set[3] if kind == "vpu" else None,
             zero_weight_share=zero, max_rel_err=err, max_abs_err=abs_err,
             tol=tol, ms=ms, plain_ms=plain_ms,
             vs_exact_plain_max_rel_err=vs_exact)
        if not err <= tol:
            raise AssertionError(f"slot kernel {label} vs plain: rel err "
                                 f"{err:.3g} > {tol:g}")
        check_vs_exact(f"slot kernel {label}", vs_exact)
    gv.launches.update(n0)  # comparison launches are not main-path launches
    del planes
    torch.cuda.empty_cache()


def slot_tol(kind: str, kw: dict) -> float:
    """A slot kernel's tolerance against its plain version in the same
    tier: the plain versions sum in the kernels' order, so the kernel
    against them reads only its instruction forms (the paired tier against
    the exact plain version: RTOL_PAIRED, held_against_exact)."""
    return RTOL_SEGMENT if kind != "vpu" else RTOL_EXACT


def slot_kind(algo_name: str, mode: str) -> tuple:
    """(gather_vpu.launches key, run_slot_kernel kind) of a run."""
    if algo_name in ("POINT", "SPHERE"):
        return "vpu", "vpu"
    if mode != "analytic":
        return "segment_discrete", "discrete"
    return ("segment_analytic" if algo_name == "RAY" else "segment_sphere",
            "analytic")


def run_label(algo_name, tier, mode, seg_tier, rule) -> str:
    if algo_name in ("POINT", "SPHERE"):
        return f"{algo_name} {tier}"
    return f"{algo_name} {mode} {seg_tier}" + (
        f" {rule}" if algo_name == "BEAM" and mode == "analytic" else "")


def phase_uncached(algo_name, tier, mode, seg_tier, rule):
    """One bench-config run through the slots view; returns (key, launches,
    renderer)."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(segment_mode=mode, segment_eval=seg_tier,
              beam_quadrature_rule=rule)
    r = bench_renderer(tier, vt.Algorithm[algo_name], compact_view=False,
                       **kw)
    t0 = time.perf_counter()
    r.step(8)  # the ViewCache build + one batch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = 8
    for k in gv.launches:
        gv.launches[k] = 0
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gv.launches)
    peak = torch.cuda.max_memory_allocated()
    key, _ = slot_kind(algo_name, mode)
    label = run_label(algo_name, tier, mode, seg_tier, rule)
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"uncached {label}: image not finite or zero")
    if launches[key] == 0:
        raise AssertionError(f"uncached {label}: the slots path launched no "
                             f"{key} kernel")
    view_bytes = sum(t.numel() * 4 for t in (r._view.wx, r._view.wy,
                                             r._view.wz, r._view.weight))
    # The same frames through the compact view.
    rc = bench_renderer(tier, vt.Algorithm[algo_name], **kw)
    rc.step(8)
    rc.step(frames)
    torch.cuda.synchronize()
    ref = rc.state.accum
    excess = float(((img - ref).abs() - 1e-5 * ref.abs()).max())
    emit("uncached", run=label, ms_per_frame=dt / frames * 1e3,
         mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6, warmup_s=warm_s,
         launches=launches,
         launches_per_frame={k: v / frames for k, v in launches.items()},
         max_memory_allocated=peak, view_shape=list(r._view.wx.shape),
         view_bytes=view_bytes,
         live_samples=int((r._view.weight != 0).sum()),
         accum_checksum=float(img.double().sum()),
         vs_cached_max_abs=float((img - ref).abs().max()),
         vs_cached_ok=excess <= 1e-7)
    if not excess <= 1e-7:
        raise AssertionError(f"uncached {label}: image differs from the "
                             "cached session's beyond rtol 1e-5, atol 1e-7")
    del rc
    if (algo_name, tier) == ("POINT", "exact"):
        phase_uncached_step(r)
    return key, launches[key], r


def phase_uncached_step(r):
    """use_view_cache=False: march and shade every frame."""
    import torch

    r.use_view_cache = False
    r.step(1)
    torch.cuda.synchronize()
    frames = 3
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r.use_view_cache = True
    emit("uncached_step", run="POINT exact", ms_per_frame=dt / frames * 1e3,
         max_memory_allocated=torch.cuda.max_memory_allocated())


def phase_slot_shapes(r, algo_name, tier, mode, seg_tier, rule):
    """The run's slot kernel against its plain version on the next frame's
    lights, on SLOT_RAYS rays of the live ViewCache (around the image
    centre), then on the whole ViewCache, as one frame's launch takes it."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.render import photon

    v = r._view
    a = max(0, min(v.n_rays // 2 - SLOT_RAYS // 2, v.wx.shape[0] - SLOT_RAYS))
    planes = [t[a:a + SLOT_RAYS].contiguous()
              for t in (v.wx, v.wy, v.wz, v.weight)]
    lights = photon.generate_lights(
        r.grid, r.params, [r.state.frame_count + 1], r.config,
        max_steps=r._max_steps)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    key, kind = slot_kind(algo_name, mode)
    variant = variant_of(algo_name, mode, rule)
    step = r.params.light_ray_step_size
    once = 0
    if kind == "vpu":
        valid = segs[3].to(torch.int32)
        start, count = int(valid.argmax()), int(valid.sum())
        light_args = (lights.pos_to[0], lights.intensity[0], start, count)
        kw = dict(sphere=False, paired=tier == "paired")
        per_sample = ops_per_sample(variant, lights=count)
        table = 16 * segs[0].shape[0]
    else:
        light_args = None
        kw = dict(sphere_radius=r.params.beam_radius if algo_name == "BEAM"
                  else None, paired=seg_tier == "paired")
        if kind == "analytic":
            kw.update(quad_rule=rule,
                      quad_nodes=r.config.beam_quadrature_nodes)
        per_sample = ops_per_sample(variant, segs=segs, step=step,
                                    nodes=r.config.beam_quadrature_nodes)
        once = call_ops(variant, segs=segs, step=step)
        table = 32 * segs[0].shape[0]
    n0 = dict(gv.launches)
    err, abs_err, ms, plain_ms, _ = run_slot_kernel(
        kind, planes, segs, light_args, step, kw, reps=5)
    full = (v.wx, v.wy, v.wz, v.weight)
    full_err, full_abs, full_ms, full_plain_ms, got = run_slot_kernel(
        kind, full, segs, light_args, step, kw)
    vs_exact = None
    if held_against_exact(kind, kw):  # the paired tier against exact
        vs_exact = rel_err(got, slot_exact_plain(kind, full, segs, light_args,
                                                 step, kw))
    del got
    # The same launch over an empty light or segment range: the
    # live-sample scan alone (span claims, the queue, the zeros of dead
    # samples), what the frame's kernel costs beside its terms.
    scan = slot_call(kind, full, segs[:3] + (torch.zeros_like(segs[3]),),
                     None if kind != "vpu" else light_args[:2] + (0, 0),
                     step, kw)
    scan()
    _, full_scan_ms = cuda_timed(scan, 3)
    gv.launches.update(n0)  # comparison launches are not main-path launches
    tol = slot_tol(kind, kw)
    bound_ms, bound_by = slot_bound(planes[3], per_sample, table, once)
    full_bound_ms, full_bound_by = slot_bound(v.weight, per_sample, table,
                                              once)
    emit("slotshapes", run=run_label(algo_name, tier, mode, seg_tier, rule),
         kernel=key, R=SLOT_RAYS, C=planes[0].shape[1],
         live_samples=int((planes[3] != 0).sum()),
         lights=int(segs[3].sum()), max_rel_err=err, max_abs_err=abs_err,
         tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, full_view_ms=full_ms,
         full_view_live_samples=int((v.weight != 0).sum()),
         full_view_max_rel_err=full_err, full_view_max_abs_err=full_abs,
         full_view_plain_ms=full_plain_ms,
         full_view_bound_ms=full_bound_ms, full_view_bound_by=full_bound_by,
         full_view_vs_exact_plain_max_rel_err=vs_exact,
         full_scan_ms=full_scan_ms)
    if not max(err, full_err) <= tol:
        raise AssertionError(f"{key} vs plain at the live shapes: rel err "
                             f"{err:.3g} (slice), {full_err:.3g} (whole) > "
                             f"{tol:g}")
    check_vs_exact(key, vs_exact)
    return dict(max_abs_err=max(abs_err, full_abs), ms=full_ms,
                plain_ms=full_plain_ms, bound_ms=full_bound_ms,
                bound_by=full_bound_by, library_ms=None)


def phase_drag():
    """The interactive viewer's setup at the bench config (RAY discrete):
    first frame, coarse drag, settle, truncated drag, decimation."""
    import numpy as np
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.render.color import (
        build_compact_view_device, build_view, required_march_steps,
    )
    from volumerenderer_tpu_torch.utils.ssim import ssim

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def zero_counts():
        for d in (gv.launches, gs.launches):
            for k in d:
                d[k] = 0

    ray = vt.Algorithm.RAY
    positions = [(0.5 * i, 20.0, -75.0) for i in range(1, 7)]
    fields = {}
    for attempt in range(2):  # the second session is the warm one
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = bench_renderer("exact", ray, motion_mode="coarse",
                           settle_chunks=4)
        r.first_frame_uncached = True
        zero_counts()
        fields["first_frame_ms"] = timed(lambda: r.step(1))
    first_launches = dict(gv.launches)
    if not (r._ttff_done and r._view is None
            and first_launches["segment_discrete"] == 1):
        raise AssertionError("drag: the first frame did not take the "
                             "uncached step")
    fields["first_cached_frame_ms"] = timed(lambda: r.step(1))  # view build
    zero_counts()
    drag_ms = []
    for pos in positions:
        r.set(camera_pos=pos)
        drag_ms.append(timed(lambda: r.step(1)))
    coarse_launches = dict(gv.launches)
    if r.view_exact or coarse_launches["segment_discrete"] != len(positions):
        raise AssertionError("drag: coarse frames did not take the "
                             "uncached coarse step")
    fields["coarse_drag_ms"] = drag_ms
    zero_counts()
    tick_ms = [timed(lambda: r.step(1)) for _ in range(4)]
    if not r.view_exact or len(r._view.bands) < 4:
        raise AssertionError("drag: the settle did not land a merged view")
    fields["settle_tick_ms"] = tick_ms
    fields["settle_launches"] = {"slots": dict(gv.launches),
                                 "lanes": dict(gs.launches)}
    fields["peak_memory_coarse_and_settle"] = torch.cuda.max_memory_allocated()
    r.refresh()
    r.step(1)
    merged = r.state.accum.clone()
    rb = bench_renderer("exact", ray)
    rb.set(camera_pos=positions[-1])
    rb.step(1)
    blocking = rb.state.accum
    excess = float(((merged - blocking).abs() - 2e-6 * blocking.abs()).max())
    fields["merged_vs_blocking_max_abs"] = float(
        (merged - blocking).abs().max())
    if not excess <= 1e-7:
        raise AssertionError("drag: the merged view differs from a blocking "
                             "rebuild beyond rtol 2e-6, atol 1e-7")
    del r, rb
    torch.cuda.empty_cache()

    rt = bench_renderer("exact", ray, motion_mode="truncated")
    rt.step(1)
    zero_counts()
    trunc_ms = []
    for pos in positions:
        rt.set(camera_pos=pos)
        trunc_ms.append(timed(lambda: rt.step(1)))
    if gs.launches["discrete"] < len(positions) or rt.view_exact:
        raise AssertionError("drag: truncated frames did not take the "
                             "identity-order lane path")
    fields["truncated_drag_ms"] = trunc_ms
    fields["truncated_launches"] = dict(gs.launches)
    # Where a drag frame's time goes: each path's view build alone, at the
    # last drag position (the rest is the photon walk and the gather).
    clip_box, view_steps = rt._occupied_clip()
    fields["truncated_build_ms"] = [timed(lambda: build_compact_view_device(
        rt.grid, rt.params, rt.config,
        min(rt.config.motion_cap, view_steps, rt._max_steps),
        clip_box=clip_box, march_cell=rt._march_cell(), order="identity"))
        for _ in range(3)]
    coarse_step = float(np.float32(
        float(rt.params.ray_marching_step_size) * rt.config.motion_stride))
    coarse_params = rt.params.replace(ray_marching_step_size=coarse_step)
    coarse_steps = required_march_steps(rt.grid, coarse_step,
                                        rt.config.max_march_steps)
    fields["coarse_build_ms"] = [timed(lambda: build_view(
        rt.grid, coarse_params, rt.config, coarse_steps)) for _ in range(3)]
    del rt

    exact = bench_renderer("exact", ray)
    exact.step(8)
    exact.step(8)
    want = exact.state.accum.cpu().numpy()
    del exact
    for fold in ("centroid", "gauss2"):
        rd = bench_renderer("exact", ray, gather_stride=3, gather_fold=fold)
        rd.step(8)
        ms = timed(lambda: rd.step(8)) / 8
        img = rd.state.accum.cpu().numpy()
        fields[f"decimated_{fold}_ms_per_frame"] = ms
        fields[f"decimated_{fold}_ssim"] = ssim(img, want)
        fields[f"decimated_{fold}_max_abs"] = float(np.abs(img - want).max())
        del rd
    emit("drag", **fields)
    torch.cuda.empty_cache()


def phase_goldens():
    import numpy as np

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.utils.ssim import ssim

    for algo, compact in [(a, c) for c in (True, False) for a in (
            vt.Algorithm.POINT, vt.Algorithm.SPHERE, vt.Algorithm.RAY,
            vt.Algorithm.BEAM, vt.Algorithm.PATH)]:
        g = vt.grid.procedural.cloud(n=48, seed=7, center_world=(0.0, 20.0, 20.0),
                                     world_extent=70.0, device=DEV)
        params = vt.RenderParams.default().replace(
            light_source_world_pos=(0.0, 20.0, 20.0),
            scattering_probability=0.15)
        config = vt.StaticConfig(width=64, height=64, probe_tile=4096,
                                 build_tile=4096, max_events_per_photon=32,
                                 light_capacity=512, max_points_per_segment=128,
                                 compact_view=compact)
        r = vt.Renderer(g, config, params, algorithm=algo, device=DEV)
        if algo is vt.Algorithm.PATH:
            r.use_view_cache = compact
        r.step(2)
        img = r.state.accum.cpu().numpy()
        want = np.load(ROOT / "tests" / "goldens" / f"{algo.name.lower()}.npy")
        s, err = ssim(img, want), float(np.abs(img - want).max())
        view = ("use_view_cache" if algo is vt.Algorithm.PATH
                else "compact_view")
        emit("goldens", algorithm=algo.name, **{view: compact}, ssim=s,
             max_abs_err=err)
        if not (s >= 0.995 and err < 5e-3):
            raise AssertionError(f"{algo.name}: golden SSIM {s:.5f}, "
                                 f"max abs err {err:.2e}")


def path_renderer(**config):
    """The bench config (scripts/bench_matrix.py:62-66, 158) for PATH: the
    RenderParams and StaticConfig defaults but the light and image size."""
    import volumerenderer_tpu_torch as vt

    return bench_renderer("exact", vt.Algorithm.PATH, **config)


def path_frame_split(r, frame_count: int):
    """One cached frame of ``r``'s session timed stage by stage with CUDA
    events (render.path.PathTrace marks): ms per stage label."""
    import torch

    from volumerenderer_tpu_torch.render import path

    p_eff, light_step, steps = r._path_effective(r._max_steps)
    events = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((label, ev))

    torch.cuda.synchronize()
    events[0][1].record()
    path.render_frame(
        r.grid, p_eff, frame_count, r.config, steps,
        shadow_lut_radius=r._shadow_lut_radius(), cache=r._path_view,
        march_cell=r._path_cell(p_eff.ray_marching_step_size),
        light_step=light_step, trace=path.PathTrace(mark=mark))
    torch.cuda.synchronize()
    return {label: events[i][1].elapsed_time(ev)
            for i, (label, ev) in enumerate(events[1:])}


def phase_path(label: str, config: dict, attrs: dict, frames: int = 4,
               checks: bool = True):
    """PATH at the bench config: step(2) warm-up (the bake included), then
    step(frames) timed; the PathView's bytes and a re-bake's ms, host
    syncs per frame, peak memory, one frame split by stage; with
    ``checks``, a cached frame against the uncached render_frame and
    render_frames of 4 against 4 render_frame calls, bit for bit."""
    import torch

    from volumerenderer_tpu_torch.render import path

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = path_renderer(**config)
    for k, v in attrs.items():
        setattr(r, k, v)
    t0 = time.perf_counter()
    r.step(2)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    syncs0 = r.host_syncs
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"{label}: image not finite or all zero")
    view = r._path_view
    if view is None:
        raise AssertionError(f"{label}: the session did not cache its view")
    p_eff, light_step, steps = r._path_effective(r._max_steps)
    lut_r = r._shadow_lut_radius()
    cell = r._path_cell(p_eff.ray_marching_step_size)
    kw = dict(shadow_lut_radius=lut_r, march_cell=cell,
              light_step=light_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebake = path.bake_path_view(r.grid, p_eff, r.config, steps,
                                 shadow_lut_radius=lut_r,
                                 light_step=light_step)
    torch.cuda.synchronize()
    bake_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(rebake, view)):
        raise AssertionError(f"{label}: a re-bake differs from the view")
    del rebake
    fields = dict(
        run=label, config=config, attrs=attrs,
        ms_per_frame=dt / frames * 1e3,
        mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6, warmup_s=warm_s,
        host_syncs_per_frame=(r.host_syncs - syncs0) / frames,
        max_steps=steps, march_cell=cell, lut_radius=lut_r,
        path_chunk=r.config.path_chunk,
        view_rows=view.o_i.shape[0],
        view_bytes=sum(t.numel() * t.element_size() for t in view),
        bake_ms=bake_ms,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        image_mean=float(img.double().mean()),
        frame_split_ms=path_frame_split(r, r.state.frame_count + 1),
    )
    if checks:
        fc = r.state.frame_count + 1
        args = (r.grid, p_eff)
        cached = path.render_frame(*args, fc, r.config, steps, cache=view,
                                   **kw)
        inline = path.render_frame(*args, fc, r.config, steps, **kw)
        if not torch.equal(cached, inline):
            raise AssertionError(
                f"{label}: the cached frame differs from render_frame "
                f"uncached (max abs {float((cached - inline).abs().max())})")
        fcs = [fc + i for i in range(4)]
        batch = path.render_frames(*args, fcs, r.config, steps, view, **kw)
        for i, f in enumerate(fcs):
            single = cached if i == 0 else path.render_frame(
                *args, f, r.config, steps, cache=view, **kw)
            if not torch.equal(batch[i], single):
                raise AssertionError(
                    f"{label}: render_frames differs from render_frame at "
                    f"frame {f}")
        fields["bit_exact_checks"] = "cached == uncached, frames == frame"
    emit("path", **fields)
    del r, view
    torch.cuda.empty_cache()


def phase_path_drag():
    """PATH with motion_mode="coarse": the first frame (the bake), two drag
    frames (the coarse uncached step, no re-bake) and the frame that
    re-bakes at the settled camera, each on the host clock."""
    import torch

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    r = path_renderer(motion_mode="coarse")
    fields = dict(first_frame_ms=timed(lambda: r.step(1)))
    baked = r._path_view
    drag = []
    for x in (0.5, 1.0):
        r.set(camera_pos=(x, 20.0, -75.0))
        syncs0 = r.host_syncs
        drag.append(timed(lambda: r.step(1)))
        if r._path_view is not baked or r.view_exact:
            raise AssertionError("pathdrag: a drag frame re-baked the view")
    fields["drag_frame_ms"] = drag
    fields["drag_host_syncs"] = r.host_syncs - syncs0
    fields["rebake_frame_ms"] = timed(lambda: r.step(1))
    if r._path_view is baked or not r.view_exact:
        raise AssertionError("pathdrag: the settled frame did not re-bake")
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError("pathdrag: image not finite or all zero")
    emit("pathdrag", **fields)
    del r, baked
    torch.cuda.empty_cache()


def many_validity(L: int, kind: str, gen, dev):
    """(L,) bool: all valid, random 80%, or 50 valid slots scattered over
    the first 256-slot tile or only over the last one."""
    import torch

    if kind == "all":
        return torch.ones(L, dtype=torch.bool, device=dev)
    if kind == "random":
        return torch.rand(L, generator=gen, device=dev) < 0.8
    valid = torch.zeros(L, dtype=torch.bool, device=dev)
    first = 0 if kind == "first" else (L - 1) // 256 * 256
    tile = torch.randperm(min(256, L - first), generator=gen, device=dev)
    valid[first + tile[:50]] = True
    return valid


def run_many_kernel(planes, lights, sphere: bool, radius, reps=3):
    """The many-light kernel and its plain version on the same inputs:
    returns (max rel err, max abs err, kernel ms, plain ms)."""
    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm

    kw = dict(sphere=sphere, radius=radius)
    fn = lambda: gm.gather_many(*planes, *lights, **kw)
    fn()  # first launch outside the timing
    got, ms = cuda_timed(fn, reps)
    ref, plain_ms = cuda_timed(lambda: gm.gather_many_reference(
        *planes, *lights, max_elems=PLAIN_ELEMS, **kw))
    if not bool((got[planes[3] == 0] == 0).all()):
        raise AssertionError("many kernel: a zero-weight sample is not 0")
    return rel_err(got, ref), float((got - ref).abs().max()), ms, plain_ms


def phase_many_kernel():
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm

    dev = torch.device(DEV)
    n0 = dict(gm.launches)
    for ci, (L, kind) in enumerate(MANY_SLOTS):
        planes, lpos, lint, _, _, _ = synthetic_case(SYNTH_CP, SEG_RC, L, 0,
                                                     0, 300 + ci, dev)
        gen = torch.Generator(device=dev).manual_seed(400 + ci)
        valid = many_validity(L, kind, gen, dev)
        k = int(torch.nonzero(valid)[0])
        for c in range(3):  # a sample on a light (a sphere's centre)
            planes[c][0, 0] = lpos[k, c]
        for sphere in (False, True):
            err, abs_err, ms, plain_ms = run_many_kernel(
                planes, (lpos, lint, valid), sphere, 0.3)
            emit("manykernel", L=L, validity=kind,
                 valid_slots=int(valid.sum()), sphere=sphere, R=SYNTH_CP,
                 C=SEG_RC, zero_weight_share=float(
                     (planes[3] == 0).double().mean()),
                 max_rel_err=err, max_abs_err=abs_err, tol=RTOL_EXACT,
                 ms=ms, plain_ms=plain_ms)
            if not err <= RTOL_EXACT:
                raise AssertionError(
                    f"many kernel vs plain: rel err {err:.3g} > "
                    f"{RTOL_EXACT:g} (L={L} {kind} sphere={sphere})")
        del planes
        torch.cuda.empty_cache()
    gm.launches.update(n0)  # comparison launches are not main-path launches


def many_session(algo_name: str, config: dict):
    import volumerenderer_tpu_torch as vt

    r = bench_renderer("exact", vt.Algorithm[algo_name], **config)
    if "light_capacity" in config:
        r.set(max_lights=config["light_capacity"])
    return r


def phase_manylight(label: str, algo_name: str, config: dict,
                    ref_config: dict):
    """One bench-config run through the many-light route: step(4) warm-up,
    step(8) timed; the image against the same session in ``ref_config``.
    Returns (launches, renderer)."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm
    from volumerenderer_tpu_torch.render import color
    from volumerenderer_tpu_torch.utils.ssim import ssim

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = many_session(algo_name, config)
    t0 = time.perf_counter()
    r.step(4)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frames = 8
    gm.launches["many"] = 0
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gm.launches["many"]
    peak = torch.cuda.max_memory_allocated()
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"{label}: image not finite or all zero")
    if launches == 0:
        raise AssertionError(f"{label}: the main path launched no "
                             "many-light kernel")
    _, _, valid, dropped = color._expanded_lights(
        r.lights, r.params, r.algorithm, r.config, 0)
    rr = many_session(algo_name, ref_config)
    rr.step(4)
    rr.step(frames)
    torch.cuda.synchronize()
    ref = rr.state.accum
    err = float((img - ref).abs().max())
    fields = dict(run=label, ms_per_frame=dt / frames * 1e3,
                  mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6,
                  warmup_s=warm_s, launches=launches,
                  launches_per_frame=launches / frames,
                  slots=int(valid.shape[0]),
                  valid_slots_last_frame=int(valid.sum()),
                  dropped_last_frame=int(dropped), max_memory_allocated=peak,
                  accum_checksum=float(img.double().sum()),
                  reference=ref_config, vs_reference_max_abs=err)
    if algo_name in ("POINT", "SPHERE"):
        ok = err <= 1e-5
    else:
        s = ssim(img.cpu().numpy(), ref.cpu().numpy())
        fields["vs_reference_ssim"] = s
        ok = s >= 0.995 and err < 5e-3
    emit("manylight", **fields, vs_reference_ok=ok)
    if not ok:
        raise AssertionError(f"{label}: image differs from the reference "
                             "session beyond its bar")
    del rr
    return launches, r


def phase_many_shapes(r, label: str):
    """The many-light kernel against its plain version on the next frame's
    light slots, on a slice of the live view (SEG_RC lanes of the widest
    band, or SLOT_RAYS rays of a ViewCache around the image centre), then
    on the whole widest band or the whole ViewCache, as one frame's launch
    takes it."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm
    from volumerenderer_tpu_torch.render import color, photon

    if r.config.compact_view:
        v = max(r._view.bands, key=lambda b: b.wx.shape[0])
        cut = lambda t: t[:, :min(SEG_RC, t.shape[1])]
    else:
        v = r._view
        a = max(0, min(v.n_rays // 2 - SLOT_RAYS // 2,
                       v.wx.shape[0] - SLOT_RAYS))
        cut = lambda t: t[a:a + SLOT_RAYS]
    full = (v.wx, v.wy, v.wz, v.weight)
    planes = [cut(t).contiguous() for t in full]
    lights = photon.generate_lights(
        r.grid, r.params, [r.state.frame_count + 1], r.config,
        max_steps=r._max_steps)
    pos, inten, valid, dropped = color._expanded_lights(
        lights, r.params, r.algorithm, r.config, 0)
    sphere = r.algorithm in (vt.Algorithm.SPHERE, vt.Algorithm.BEAM)
    n_valid = int(valid.sum())
    per_sample = n_valid * TERM_OPS["sphere" if sphere else "point"]
    n0 = dict(gm.launches)
    err, abs_err, ms, plain_ms = run_many_kernel(
        planes, (pos, inten, valid), sphere, r.params.beam_radius, reps=5)
    full_err, full_abs, full_ms, full_plain_ms = run_many_kernel(
        full, (pos, inten, valid), sphere, r.params.beam_radius)
    # The same launch with no valid light: the live-sample scan alone (span
    # claims, the queue, the zeros of dead samples), what a frame's kernel
    # costs beside its terms.
    scan = lambda: gm.gather_many(*full, pos, inten, torch.zeros_like(valid),
                                  sphere=sphere, radius=r.params.beam_radius)
    scan()
    _, full_scan_ms = cuda_timed(scan, 3)
    gm.launches.update(n0)  # comparison launches are not main-path launches
    bound_ms, bound_by = slot_bound(planes[3], per_sample, 17 * valid.shape[0])
    full_bound_ms, full_bound_by = slot_bound(full[3], per_sample,
                                              17 * valid.shape[0])
    emit("manyshapes", run=label, shape=list(planes[0].shape),
         live_samples=int((planes[3] != 0).sum()),
         slots=int(valid.shape[0]), valid_slots=n_valid, dropped=int(dropped),
         max_rel_err=err, max_abs_err=abs_err, tol=RTOL_EXACT, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
         full_shape=list(full[0].shape),
         full_live_samples=int((full[3] != 0).sum()),
         full_max_rel_err=full_err, full_max_abs_err=full_abs,
         full_ms=full_ms, full_plain_ms=full_plain_ms,
         full_bound_ms=full_bound_ms, full_bound_by=full_bound_by,
         full_scan_ms=full_scan_ms)
    if not max(err, full_err) <= RTOL_EXACT:
        raise AssertionError(
            f"{label}: many kernel vs plain at the live shapes: rel err "
            f"{err:.3g} (slice), {full_err:.3g} (whole) > {RTOL_EXACT:g}")
    return dict(max_abs_err=max(abs_err, full_abs), ms=full_ms,
                plain_ms=full_plain_ms, bound_ms=full_bound_ms,
                bound_by=full_bound_by, library_ms=None)


def main() -> int:
    if not (PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    phase_kernel()
    phase_segment_kernel()
    per_tier = {tier: phase_main(tier) for tier in ("exact", "paired")}
    phase_sphere()
    segment_runs = []
    for run in RAYBEAM_RUNS:
        kind, launches, r = phase_raybeam(*run)
        segment_runs.append((run, kind, launches,
                             phase_segment_shapes(r, *run)))
        del r
    phase_slot_kernel()
    slot_runs = []
    for run in UNCACHED_RUNS:
        key, launches, r = phase_uncached(*run)
        slot_runs.append((run, key, launches, phase_slot_shapes(r, *run)))
        del r
    phase_drag()
    for run in PATH_RUNS:
        phase_path(*run)
    phase_path_drag()
    phase_goldens()
    phase_many_kernel()
    many_runs = {}
    for label, algo_name, config, ref_config in MANY_RUNS:
        launches, r = phase_manylight(label, algo_name, config, ref_config)
        many_runs[label] = (launches, phase_many_shapes(r, label))
        del r
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")

    kernels = [
        dict(name=f"gather_lanes[{tier}]", route="cuda",
             source="volumerenderer_tpu_torch/csrc/gather_lanes.cu",
             replaces=REPLACES["lanes"], **v)
        for tier, v in per_tier.items()
    ]
    for (algo_name, mode, tier, rule), kind, launches, v in segment_runs:
        if kind == "discrete":
            variant = algo_name.lower()
        else:
            variant = "vrl" if algo_name == "RAY" else f"vbl-{rule}"
        kernels.append(dict(
            name=f"gather_segments_{kind}[{variant},{tier}]", route="cuda",
            source="volumerenderer_tpu_torch/csrc/gather_segments.cu",
            replaces=REPLACES[kind], launches=launches, **v))
    for (algo_name, tier, mode, seg_tier, rule), key, launches, v in slot_runs:
        variant = variant_of(algo_name, mode, rule).replace("discrete-", "")
        kernels.append(dict(
            name=f"{key}[{variant},"
                 f"{tier if key == 'vpu' else seg_tier}]", route="cuda",
            source="volumerenderer_tpu_torch/csrc/gather_vpu.cu",
            replaces=REPLACES[key], launches=launches, **v))
    for i, (label, algo_name, _, _) in enumerate(MANY_RUNS):
        launches, v = many_runs[label]
        variant = "sphere" if algo_name in ("SPHERE", "BEAM") else "point"
        name = f"gather_many[{variant},exact]"
        if i > 1:  # the first two keep the names of earlier kernels lines
            name = f"{name} {label}"
        kernels.append(dict(
            name=name, route="cuda",
            source="volumerenderer_tpu_torch/csrc/gather_many.cu",
            replaces=REPLACES["many"], launches=launches, **v))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
