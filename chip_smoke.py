#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volumerenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

  1. device    the card's name, power limit and compute capability;
  2. build     nvcc builds csrc/gather_lanes.cu, csrc/gather_segments.cu,
               csrc/gather_vpu.cu, csrc/gather_many.cu and
               csrc/march_planes.cu from this checkout, all at once; ptxas
               registers, spills and shared memory per kernel template;
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
               warm-up, then step(32) timed; kernel launches counted,
               and the walk kernel's: one launch a tick, each on the
               kernel route (the "walk" route counts), or it fails;
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
     march     the march kernel (csrc/march_planes.cu) against its plain
               version at the bench config's rays: the coarse drag frame
               (step 12, 16 samples, slots and lanes layouts) and the
               slots view's build (step 1, the occupied clip box):
               positions bit for bit, the weights' largest relative error
               against the plain version on CPU copies of SLOT_RAYS rays
               and on the card (rtol 1e-6, or S x 2^-24 where more), and
               the samples weighted on one side only; kernel and plain ms,
               the plain version's launches, the byte bound;
     walk      the photon-walk kernel (csrc/photon_walk.cu) against the
               plain loop on the card, from one start state, at the cells'
               walks: 8 frames of 16 photons at step 1 in the asset (the
               bunny-class fog), the bench's cloud(n=96) and the
               benchmark's cumulus stand-in, and 1 frame at the coarse drag
               step 12: event counts and drops equal, positions within
               1e-4, intensities within rtol 2e-6; kernel, generate_lights
               and plain ms, each route's device launches, and the serial
               bound (the longest photon's windows);
 11. uncached  the bench config with compact_view=False (the slots
               ViewCache) for POINT exact and paired, RAY discrete exact
               and paired, RAY analytic exact and paired, BEAM discrete
               exact and BEAM analytic closed paired: step(8) warm-up, step(8)
               timed, slot-kernel launches per frame, the march kernel's
               launches in the view build (one) and in the timed frames
               (none), peak memory, the
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
               4): the first frame (warm), coarse drag frames (each
               launching one march kernel and one walk kernel, or it
               fails), the settle
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
               and Beam through the compact view and the slots view, for
               Path cached and uncached, and the density harness's image,
               against tests/goldens at windowed SSIM >= 0.995 and max abs
               error < 5e-3;
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
               widest band or the whole ViewCache, as a frame launches it;
 19. asset     the bunny-class volume of scripts/make_asset.py (392 x 360 x
               312 voxels, seed 42; this file's own copy of make_volume,
               computed in slabs on threads, equal to it bit for bit)
               written with save_vdb (blosc+mask) and save_nvdb (zip), read
               back with grid.load and through a NanoVDB blob, each equal
               voxel for voxel with its map; RAY at 1920x1080 (camera
               (0, 20, -40), light (-10, 28, 8)) through the host-banded
               build: bands, caps, view bytes, build ms, ms/frame over
               step(8) after step(2), host syncs, peak memory, launches;
               POINT, SPHERE, BEAM and PATH step(2) each; the point lane
               kernel (row 1, POINT) and the discrete one (row 2, RAY)
               against their plain versions on SEG_RC lanes of the widest
               band; the host build against the device build at 512x512
               (rtol 1e-5, atol 1e-7), each build and frame timed; RAY with
               gather_samples=12 (top-k planes padded to 16), its discrete
               kernel against plain; ``python -m volumerenderer_tpu_torch
               render`` on the .vdb (its PPM equal to the same session's
               image in this process), ``bench`` and ``warmup`` as
               subprocesses;
 20. options   the slice options.  options_asset: the asset (read from
               build/asset/asset.vdb) at 1920x1080 with
               interpolation="trilinear", RAY discrete exact through the
               host-banded build at the full step budget (fails if the
               device build would take it): bands, caps, view bytes, build
               ms, stored, used and live samples, ms/frame over step(8)
               after step(2), host syncs a frame, peak memory, discrete
               launches a frame; the image against the nearest session's
               (they differ); row 2 against plain on the SEG_RC lanes of
               the band window with the most live samples, beside the
               nearest view's (ns per live sample); POINT step(2) and row 1
               on the same lanes; the trilinear samples of nonzero density
               the occupied-box clip leaves out, on every 4th ray.
               options_bench: the bench config under trilinear, POINT exact,
               RAY discrete exact and RAY analytic paired through the
               compact view (the device build in identity order, no host
               read), POINT and RAY discrete exact through the slots view
               (rows 4 and 5 against plain on SLOT_RAYS rays, the image
               against the compact one at rtol 1e-5, atol 1e-7): step(8),
               then step(8) timed, launches.  options_u8: POINT exact with
               accum_dtype="uint8": after step(1) equal to a float32
               session's accumulator quantized, bit for bit; after step(8)
               on the k/255 grid.  The phase's seconds;
 21. density   the density harness on the asset read from .vdb: the
               reference's CPU_test (256x256, camera (0, 250, -800),
               world-as-index) and 1920x1080 with apply_transform=True from
               the asset's camera: seconds, max, nonzero pixels;
 22. aux       a 1080p asset RAY session: a checkpoint after step(3)
               loaded into a fresh session, then step(2), equal bit for bit
               to the uninterrupted session; the debug light views of its
               lights (lit pixels); profiling.trace around one frame (the
               Chrome trace names the discrete kernel);
               device_memory_stats(); viewer.render_offline of 4 frames at
               512x512 to PNG, and one InteractiveViewer.tick under Agg
               where matplotlib is installed;
 23. mesh      volumerenderer_tpu_torch.parallel at the bench config.
               (a) a world of one rank under NCCL, in this process: POINT
               exact and paired, RAY discrete exact and PATH cached through
               MeshRenderer, each against the single-device Renderer driven
               by the same step() calls (step(1), step(7), then step(16)
               timed; PATH step(1), step(1), step(4)) at rtol 1e-6, atol
               1e-7, with ms/frame of both, kernel launches (counted from 0
               over the MeshRenderer's run), peak memory and whether the
               images are equal bit for bit; the run's kernel against its
               plain version on the mesh's view (shapes, segshapes).  (b) a
               (2, 2) world of 4 gloo ranks, all on this card (launch):
               POINT exact and RAY discrete exact through MeshRenderer, and
               RAY's first frame through light_sharded_radiance, each
               gathered image within rtol 1e-4, atol 1e-6 of (a)'s
               single-device frame; each rank's launches (rows 1, 2 and 5
               on every rank), ms/frame and peak memory; on rank 0 each
               run's kernel against its plain version at rank 0's inputs
               (its 540-row band's compact view or, for the light-sharded
               frame, its slots view, with its half of the light slots:
               shapes, segshapes, slotshapes).  (c) dryrun_multichip(4) on
               this card.

The lines before the last are the card's name and power limit as
nvidia-smi gives them and a JSON object of the kernels, one entry for each
run of phases 5, 8, 11, 17, 20 and 23 (PATH runs no kernel; the many-light
entries after the first two, gather_many[point,exact] and
gather_many[sphere,exact], add their run's label to the name; each entry
with its launches in that run and its bound: the larger of its f32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s, counted for this
run's inputs; the point lane kernel at the widest band, the others at the
whole shape a frame launches: the widest band or the whole ViewCache;
phase 20's entries, named "... trilinear", at the slices they were held
against plain on; phase 23's, named "... mesh", with the launches of the
world of one's runs, at the mesh view's shapes, and "... mesh (2,2)", with
rank 0's launches in the (2, 2) world, at rank 0's band and light shard;
the march kernel's entries, march_planes[drag] with the launches of phase
13's coarse drag frames, one a frame, and march_planes[slots_build] with
those of phase 11's first view build, at the march phase's shapes (the
lanes layout, which no run of the bench config launches, is in the march
phase's line alone); and the walk kernel's, photon_walk[<shape>], with
the walk launches of phase 5's exact converging ticks (the step-1
shapes) or of phase 13's coarse drag frames (the drag shape), at the walk
phase's shapes);
the last line is
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
# The asset phase: scripts/make_asset.py's volume, transform and view.
ASSET_SHAPE, ASSET_SEED = (392, 360, 312), 42
ASSET_BLOBS = ((0, -0.25, 0, 0.62, 0.5, 0.55), (0.05, 0.32, 0.12, 0.34, 0.3, 0.3),
               (-0.12, 0.72, 0.1, 0.1, 0.32, 0.12), (0.2, 0.74, 0.1, 0.1, 0.34, 0.12))
ASSET_BBOX_MIN, ASSET_VOXEL = (-196, -180, -156), 0.125
ASSET_TRANSLATION = (0.0, 20.0, 20.0)
ASSET_CAMERA, ASSET_LIGHT = (0.0, 20.0, -40.0), (-10.0, 28.0, 8.0)
ASSET_DIR = ROOT / "build" / "asset"
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

    names = ("gather_lanes", "gather_segments", "gather_vpu", "gather_many",
             "march_planes", "photon_walk")
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
    version on this run's live bands; returns (the kernel's figures, the
    walk kernel's launches over the measured frames, one a tick)."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import photon_walk as pw
    from volumerenderer_tpu_torch.utils import profiling

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
    pw.launches["walk"] = 0
    routes0 = profiling.totals()
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gl.launches
    walk_launches = pw.launches["walk"]
    check_walks(tier, routes0, walk_launches, frames // r.frame_batch)
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
        walk_launches=walk_launches, view_exact=bool(r.view_exact),
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
    return dict(launches=launches, **phase_shapes(r, tier)), walk_launches


def check_walks(label: str, before: dict, launches: int, calls: int):
    """Fail unless ``calls`` generate_lights calls since the counts
    ``before`` each took the kernel route and launched the walk kernel
    once: "walk" counts at "photon.walk.kernel" and launches both
    ``calls``, none at "photon.walk.plain"."""
    from volumerenderer_tpu_torch.utils import profiling

    after = profiling.totals()
    routed = {site: after.get(("walk", site), 0) - before.get(("walk", site),
                                                              0)
              for site in ("photon.walk.kernel", "photon.walk.plain")}
    if (routed["photon.walk.plain"] or calls < 1
            or routed["photon.walk.kernel"] != calls or launches != calls):
        raise AssertionError(f"{label}: {calls} walks wanted, one kernel "
                             f"launch each; routes {routed}, launches "
                             f"{launches}")


def phase_shapes(r, tier: str):
    """The kernel against its plain version on the live view's widest
    band and the next frame's lights."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl

    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    lights = next_lights(r)
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

    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    lanes = slice(0, min(SEG_RC, band.wx.shape[1]))
    full = (band.wx, band.wy, band.wz, band.weight)
    planes = [t[:, lanes].contiguous() for t in full]
    need = band.lane_need[lanes].contiguous()
    lights = next_lights(r)
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


def device_events(fn):
    """The device activities (kernels, copies, fills) that one call of
    ``fn`` puts on the card, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_launches(fn, reps: int = 1) -> int:
    """Device activities one call of ``fn`` puts on the card: the most of
    ``reps`` traced calls (a trace can miss an activity record, never add
    one)."""
    return max(len(device_events(fn)) for _ in range(reps))


def device_ms(fn, name: str, reps: int = 10):
    """Device ms of one kernel whose name holds ``name``, the mean over
    ``reps`` traced calls of ``fn`` that each launch it once (a trace can
    miss a record: the mean is over the launches caught); None if no
    trace caught one."""
    caught = [e.time_range.elapsed_us() for _ in range(reps)
              for e in device_events(fn) if name in e.name]
    return sum(caught) / len(caught) / 1e3 if caught else None


def phase_march():
    """The march kernel against its plain version at the main path's
    shapes (module docstring, ``march``); returns each shape's fields by
    its name."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import march_planes as mp
    from volumerenderer_tpu_torch.render import color

    r = bench_renderer("exact", vt.Algorithm.RAY, compact_view=False)
    n0 = mp.launches["march"]
    shapes = {}
    for name, step, clip, lanes in (("drag", 12.0, False, False),
                                    ("drag_lanes", 12.0, False, True),
                                    ("slots_build", 1.0, True, False)):
        params = r.params.replace(ray_marching_step_size=step)
        o_i, d_i = color.camera_rays_index(r.grid, params, r.config)
        S = color.required_march_steps(r.grid, step, r.config.max_march_steps)
        box = None
        if clip:
            box, view_steps = r._occupied_clip()
            S = min(S, view_steps)
        kw = dict(ray_max_distance=params.ray_max_distance, step_size=step,
                  absorption=params.absorption_coefficient, max_steps=S,
                  clip_box=box, lanes=lanes)
        N = o_i.shape[0]
        got = mp.march_planes(r.grid, o_i, d_i, **kw)  # warm: the allocation
        got, ms = cuda_timed(lambda: mp.march_planes(r.grid, o_i, d_i, **kw),
                             reps=20)
        plain = lambda: mp.march_planes_reference(
            r.grid, o_i, d_i, tile=r.config.build_tile, **kw)
        want = plain()  # warm: its temporaries and kernels' first loads
        want, plain_ms = cuda_timed(plain, reps=2)
        launches = device_launches(plain)
        # The plain version on CPU copies of SLOT_RAYS rays mid-image (the
        # transmittance product in the kernel's order), and on the card
        # (torch.cumprod's scan there): positions bit for bit, weights.
        a = N // 2 - SLOT_RAYS // 2
        cut = slice(a, a + SLOT_RAYS)
        host = mp.march_planes(
            r.grid.to("cpu"), o_i[cut].cpu(), d_i[cut].cpu(), **dict(
                kw, clip_box=None if box is None
                else tuple(c.cpu() for c in box)))
        mine = (got[:, :, cut] if lanes else got[:, cut]).cpu()
        same = bool(torch.equal(got[:3], want[:3])
                    and torch.equal(mine[:3], host[:3]))
        w, wp, wh = got[3], want[3], host[3]
        err = rel_err(mine[3][(mine[3] != 0) & (wh != 0)],
                      wh[(mine[3] != 0) & (wh != 0)])
        err_card = rel_err(w[(w != 0) & (wp != 0)], wp[(w != 0) & (wp != 0)])
        flips = int(((w != 0) != (wp != 0)).sum()
                    + ((mine[3] != 0) != (wh != 0)).sum())
        nbytes = 16.0 * N * S + 24.0 * N + 4.0 * r.grid.voxels.numel()
        bound_ms, by = bound(0.0, nbytes)
        fields = dict(
            rays=N, samples=S, clip=clip, layout="lanes" if lanes else "slots",
            ms=ms, plain_ms=plain_ms, plain_launches=launches,
            bound_ms=bound_ms, bound_by=by, pct_of_bound=100.0 * bound_ms / ms,
            positions_equal=same, weighted=int((wp != 0).sum()),
            max_rel_err=err, max_rel_err_card_plain=err_card,
            weighted_one_side=flips)
        emit("march", shape=name, **fields)
        shapes[name] = fields
        # 1e-6, or half an ulp of drift a factor of the S-sample product
        # (expf's last bit; cumprod's association on the card).
        tol = max(1e-6, S * 2.0**-24)
        if not same or not max(err, err_card) <= tol:
            raise AssertionError(f"march kernel {name} vs plain: positions "
                                 f"equal {same}, weight rel err "
                                 f"{max(err, err_card):.3g} > {tol:.3g}")
        del got, want, w, wp
        torch.cuda.empty_cache()
    mp.launches["march"] = n0  # comparison launches are not main-path ones
    return shapes


WALK_SHAPES = (  # (name, volume, frames, step): the cells' walks
    ("bunny", "bunny", 8, 1.0),
    ("cloud96", "cloud96", 8, 1.0),
    ("cumulus", "cumulus", 8, 1.0),
    ("cloud96_drag", "cloud96", 1, 12.0),
)


def walk_volumes():
    """The grids and lights of the walk phase: the asset (the bunny-class
    fog), the bench's cloud(n=96) and the benchmark's cumulus stand-in
    (portbench/configs/cumulus-half-1080p.json, seed 1)."""
    import volumerenderer_tpu_torch as vt

    bench = ROOT / "portbench"
    spec = json.loads((bench / "configs" / "cumulus-half-1080p.json")
                      .read_text())
    sys.path.insert(0, str(bench))
    from volumes import cumulus

    dense = cumulus.generate(spec["volume"], 1, DEV).cpu().numpy()
    vs = spec["volume"]
    return {
        "bunny": (vt.grid.from_dense(
            make_volume(), bbox_min=ASSET_BBOX_MIN, voxel_size=ASSET_VOXEL,
            translation=ASSET_TRANSLATION, device=DEV), ASSET_LIGHT),
        "cloud96": (vt.grid.procedural.cloud(n=96, device=DEV),
                    (0.0, 20.0, 20.0)),
        "cumulus": (vt.grid.from_dense(
            dense, bbox_min=vs["bbox_min"], voxel_size=vs["voxel_size"],
            translation=vs["translation"], device=DEV),
            tuple(spec["params"]["light_source_world_pos"])),
    }


def phase_walk(volumes=None):
    """The photon-walk kernel (csrc/photon_walk.cu) against the plain loop
    on the card at the cells' walks: 8 frames of 16 photons at the step 1
    of the bunny, cloud96 and cumulus grids, and one frame at the coarse
    drag step 12.  Both walk from one start state (render.photon.walk_start);
    counts and drops equal, stored positions within 1e-4 and intensities
    within rtol 2e-6.  Kernel ms (its device time, mean of 10 traced calls),
    ms of the wrapper call (the kernel and the world conversion) and of all
    of generate_lights, plain ms (the loop alone), device launches of each
    route's generate_lights, and the serial bound: the windows of the
    longest photon (the plain loop's window count) and its steps, at most
    windows x Wn.  Returns each shape's fields by its name."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import photon_walk as pw
    from volumerenderer_tpu_torch.render import color
    from volumerenderer_tpu_torch.render import photon
    from volumerenderer_tpu_torch.utils import profiling

    volumes = volumes or walk_volumes()
    n0 = pw.launches["walk"]
    shapes = {}
    for name, vol, frames, step in WALK_SHAPES:
        grid, light = volumes[vol]
        config = vt.StaticConfig()
        params = vt.RenderParams.default().replace(
            light_source_world_pos=light, ray_marching_step_size=step)
        S = color.required_march_steps(grid, step, config.max_march_steps)
        fcs = list(range(1, frames + 1))
        lights = photon.generate_lights(grid, params, fcs, config,
                                        max_steps=S)
        args, kw = photon.walk_start(grid, params, fcs, config, S)
        walk = lambda: pw.photon_walk(*args, **kw)
        plain = lambda: pw.photon_walk_reference(*args, **kw)
        gen = lambda: photon.generate_lights(grid, params, fcs, config,
                                             max_steps=S)

        def plain_gen():  # generate_lights with the plain loop
            a, k = photon.walk_start(grid, params, fcs, config, S)
            return photon.clamp_lights(*pw.photon_walk_reference(*a, **k),
                                       params, config)
        got, ms = cuda_timed(walk, reps=20)
        _, gen_ms = cuda_timed(gen, reps=20)
        syncs = profiling.totals().get(("sync", "photon.walk"), 0)
        want, plain_ms = cuda_timed(plain, reps=3)
        windows = (profiling.totals()[("sync", "photon.walk")]
                   - syncs) // 3 - 1
        gen_launches = device_launches(gen, reps=3)
        kernel_ms = device_ms(walk, "walk_kernel")
        plain_launches = device_launches(plain_gen, reps=3)
        (ev, n, dr), (ev_w, n_w, dr_w) = ([t.cpu() for t in got],
                                          [t.cpu() for t in want])
        valid = torch.arange(ev.shape[1])[None, :] < n[:, None]
        a, b = ev[valid], ev_w[valid]
        same = bool(torch.equal(n, n_w) and torch.equal(dr, dr_w))
        pos_err = float((a[:, :6] - b[:, :6]).abs().max()) if len(a) else 0.0
        int_err = rel_err(a[:, 6], b[:, 6])
        Wn = min(pw.WINDOW, S)
        fields = dict(
            photons=int(n.numel()), frames=frames, step=step, max_steps=S,
            window=Wn, missed=int((~args[6]).sum()), stored=int(n.sum()),
            lights=int(lights.count.sum()), dropped=int(dr.sum()),
            kernel_ms=kernel_ms, ms=ms, generate_lights_ms=gen_ms,
            plain_ms=plain_ms,
            device_launches=gen_launches,
            plain_device_launches=plain_launches,
            longest_windows=windows, serial_steps_at_most=windows * Wn,
            us_per_window=(None if kernel_ms is None
                           else 1e3 * kernel_ms / max(windows, 1)),
            counts_equal=same, max_pos_err=pos_err, max_int_rel_err=int_err,
            positions_bit_equal=int((a[:, :6] == b[:, :6]).all(dim=1).sum()))
        emit("walk", shape=name, **fields)
        shapes[name] = fields
        if not same or pos_err > 1e-4 or int_err > 2e-6:
            raise AssertionError(f"walk kernel {name} vs plain: counts equal "
                                 f"{same}, position err {pos_err:.3g}, "
                                 f"intensity rel err {int_err:.3g}")
    pw.launches["walk"] = n0  # comparison launches are not main-path ones
    return shapes


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
    from volumerenderer_tpu_torch.ops.kernels import march_planes as mp

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(segment_mode=mode, segment_eval=seg_tier,
              beam_quadrature_rule=rule)
    r = bench_renderer(tier, vt.Algorithm[algo_name], compact_view=False,
                       **kw)
    mp.launches["march"] = 0
    t0 = time.perf_counter()
    r.step(8)  # the ViewCache build + one batch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    build_marches = mp.launches["march"]
    frames = 8
    for k in gv.launches:
        gv.launches[k] = 0
    mp.launches["march"] = 0
    t0 = time.perf_counter()
    r.step(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(gv.launches)
    frame_marches = mp.launches["march"]
    peak = torch.cuda.max_memory_allocated()
    key, _ = slot_kind(algo_name, mode)
    label = run_label(algo_name, tier, mode, seg_tier, rule)
    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"uncached {label}: image not finite or zero")
    if launches[key] == 0:
        raise AssertionError(f"uncached {label}: the slots path launched no "
                             f"{key} kernel")
    if build_marches != 1 or frame_marches:
        raise AssertionError(f"uncached {label}: the slots view's build "
                             f"launched {build_marches} march kernels (1 "
                             f"wanted), its cached frames {frame_marches}")
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
         build_march_launches=build_marches,
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
    return key, launches[key], build_marches, r


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

    v = r._view
    a = max(0, min(v.n_rays // 2 - SLOT_RAYS // 2, v.wx.shape[0] - SLOT_RAYS))
    planes = [t[a:a + SLOT_RAYS].contiguous()
              for t in (v.wx, v.wy, v.wz, v.weight)]
    lights = next_lights(r)
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
    first frame, coarse drag, settle, truncated drag, decimation; returns
    the march and walk kernels' launches over the coarse drag frames."""
    import numpy as np
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.ops.kernels import march_planes as mp
    from volumerenderer_tpu_torch.ops.kernels import photon_walk as pw
    from volumerenderer_tpu_torch.render.color import (
        build_compact_view_device, build_view, required_march_steps,
    )
    from volumerenderer_tpu_torch.utils import profiling
    from volumerenderer_tpu_torch.utils.ssim import ssim

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def zero_counts():
        for d in (gv.launches, gs.launches, mp.launches):
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
    fields["first_frame_march_launches"] = mp.launches["march"]
    fields["first_cached_frame_ms"] = timed(lambda: r.step(1))  # view build
    zero_counts()
    pw.launches["walk"] = 0
    drag_ms, drag_marches, drag_walks = [], [], []
    for i, pos in enumerate(positions):
        r.set(camera_pos=pos)
        n0 = mp.launches["march"]
        routes0 = profiling.totals()
        w0 = pw.launches["walk"]
        drag_ms.append(timed(lambda: r.step(1)))
        drag_marches.append(mp.launches["march"] - n0)
        drag_walks.append(pw.launches["walk"] - w0)
        check_walks(f"drag frame {i}", routes0, drag_walks[-1], 1)
    coarse_launches = dict(gv.launches)
    if r.view_exact or coarse_launches["segment_discrete"] != len(positions):
        raise AssertionError("drag: coarse frames did not take the "
                             "uncached coarse step")
    if drag_marches != [1] * len(positions):
        raise AssertionError(f"drag: coarse frames launched {drag_marches} "
                             "march kernels, one each wanted")
    fields["coarse_drag_ms"] = drag_ms
    fields["coarse_march_launches"] = drag_marches
    fields["coarse_walk_launches"] = drag_walks
    zero_counts()
    tick_ms = [timed(lambda: r.step(1)) for _ in range(4)]
    if not r.view_exact or len(r._view.bands) < 4:
        raise AssertionError("drag: the settle did not land a merged view")
    fields["settle_tick_ms"] = tick_ms
    fields["settle_launches"] = {"slots": dict(gv.launches),
                                 "lanes": dict(gs.launches),
                                 "march": mp.launches["march"]}
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
    return sum(drag_marches), sum(drag_walks)


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
    # The density harness on the golden scene (tests/test_goldens.py).
    from volumerenderer_tpu_torch.render import density

    img = density.render_density(
        g, width=64, height=64, camera_pos=(0.0, 20.0, -75.0), t_max=200.0,
        dt=1.0, apply_transform=True).cpu().numpy()
    want = np.load(ROOT / "tests" / "goldens" / "density.npy")
    s, err = ssim(img, want), float(np.abs(img - want).max())
    emit("goldens", algorithm="density", ssim=s, max_abs_err=err)
    if not (s >= 0.995 and err < 5e-3):
        raise AssertionError(f"density: golden SSIM {s:.5f}, max abs err "
                             f"{err:.2e}")


def path_renderer(**config):
    """The bench config (scripts/bench_matrix.py:62-66, 158) for PATH: the
    RenderParams and StaticConfig defaults but the light and image size."""
    import volumerenderer_tpu_torch as vt

    return bench_renderer("exact", vt.Algorithm.PATH, **config)


def path_frame_split(r, frame_count: int):
    """One cached frame of ``r``'s session split by its spans
    (utils.profiling: "path.replay", then "path.compact" and "path.walk"
    a segment), in order: [[span, host ms], ...].  Each stage ends in a
    host read of the card, so its host time follows the card's."""
    import torch

    from volumerenderer_tpu_torch.render import path
    from volumerenderer_tpu_torch.utils import profiling

    p_eff, light_step, steps = r._path_effective(r._max_steps)
    torch.cuda.synchronize()
    profiling.drain()
    profiling.record(True)
    try:
        path.render_frame(
            r.grid, p_eff, frame_count, r.config, steps,
            shadow_lut_radius=r._shadow_lut_radius(), cache=r._path_view,
            march_cell=r._path_cell(p_eff.ray_marching_step_size),
            light_step=light_step)
        torch.cuda.synchronize()
    finally:
        profiling.record(False)
    spans = sorted(profiling.drain()["spans"], key=lambda s: s.start_ns)
    return [[s.name, (s.end_ns - s.start_ns) * 1e-6] for s in spans]


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
    from volumerenderer_tpu_torch.render import color

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
    lights = next_lights(r)
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


def make_volume(n=ASSET_SHAPE, seed=ASSET_SEED, workers=8):
    """scripts/make_asset.py's make_volume (a bunny-cloud-like fog: a union
    of soft ellipsoids times three octaves of value noise, a thin shell),
    computed in x slabs on threads: every operation is elementwise but the
    noise's maximum, so the result equals the serial one bit for bit."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    rs = np.random.RandomState(seed)
    lx, ly, lz = (np.linspace(-1, 1, k) for k in n)
    scales = [6 * 2 ** octave for octave in range(3)]
    tables = [rs.rand(s + 1, s + 1, s + 1).astype(np.float32) for s in scales]
    cuts = np.linspace(0, n[0], workers + 1).astype(int)

    def distance_and_noise(i0, i1):
        x, y, z = np.meshgrid(lx[i0:i1], ly, lz, indexing="ij")
        d = np.full(x.shape, 1e9, np.float32)
        for cx, cy, cz, rx, ry, rz in ASSET_BLOBS:
            d = np.minimum(d, np.sqrt(((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2
                                      + ((z - cz) / rz) ** 2) - 1.0)
        noise = np.zeros(x.shape, np.float32)
        for octave, (s, g) in enumerate(zip(scales, tables)):
            xi = np.clip((x * 0.5 + 0.5) * s, 0, s - 1e-3)
            yi = np.clip((y * 0.5 + 0.5) * s, 0, s - 1e-3)
            zi = np.clip((z * 0.5 + 0.5) * s, 0, s - 1e-3)
            x0, y0, z0 = xi.astype(int), yi.astype(int), zi.astype(int)
            fx, fy, fz = xi - x0, yi - y0, zi - z0
            v = 0.0
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                             * (fz if dz else 1 - fz))
                        v = v + w * g[x0 + dx, y0 + dy, z0 + dz]
            noise += v.astype(np.float32) / 2 ** octave
        return d, noise

    def finish(part, peak):
        d, noise = part
        noise /= peak
        shell = np.exp(-np.abs(d) * 6.0) * (d < 0.15)
        dense = (shell * (0.25 + 0.75 * noise)).astype(np.float32)
        dense[dense < 0.02] = 0.0
        return dense

    with ThreadPoolExecutor(workers) as pool:
        parts = list(pool.map(distance_and_noise, cuts[:-1], cuts[1:]))
        peak = max(noise.max() for _, noise in parts)
        return np.concatenate(list(pool.map(finish, parts,
                                            [peak] * len(parts))))


def same_volume(g, g0) -> bool:
    """A reloaded grid holds the source's voxels (over its own bbox, which
    may be the active one), map and translation, exactly."""
    import torch

    lo = (g.bbox_min - g0.bbox_min).tolist()
    if min(lo) < 0:
        return False
    ref = g0.voxels[tuple(slice(a, a + k) for a, k in zip(lo, g.voxels.shape))]
    return (tuple(ref.shape) == tuple(g.voxels.shape)
            and bool(torch.equal(ref, g.voxels))
            and bool(torch.equal(g.map_mat, g0.map_mat))
            and bool(torch.equal(g.map_vec, g0.map_vec)))


def asset_session(g, width, height, algorithm, **config):
    import volumerenderer_tpu_torch as vt

    params = vt.RenderParams.default().replace(
        camera_pos=ASSET_CAMERA, light_source_world_pos=ASSET_LIGHT)
    return vt.Renderer(g, vt.StaticConfig(width=width, height=height,
                                          **config),
                       params, algorithm=algorithm, device=DEV)


def check_image(what: str, r) -> None:
    import torch

    img = r.state.accum
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError(f"asset {what}: image not finite or all zero")


def load_split(path):
    """``grid.load(path)`` with the program's recorder on: the grid and the
    host ms of each of the load's spans ("grid.load", then the file's read,
    the bricking and the upload)."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.utils import profiling

    profiling.drain()
    profiling.record(True)
    try:
        g = vt.grid.load(str(path), device=DEV)
        if DEV != "cpu":
            torch.cuda.synchronize()
    finally:
        profiling.record(False)
    return g, {s.name: (s.end_ns - s.start_ns) * 1e-6
               for s in profiling.drain()["spans"]
               if s.name.startswith("grid.load")}


def phase_asset():
    """The bunny-class asset: files, the host-banded build at 1080p, every
    algorithm, rows 1 and 2 on its widest band, host against device build,
    the command line."""
    import argparse

    import numpy as np
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch import __main__ as cli
    from volumerenderer_tpu_torch.grid import vdbio_native
    from volumerenderer_tpu_torch.io import ppm
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.render import photon
    from volumerenderer_tpu_torch.render.color import device_build_ok
    from volumerenderer_tpu_torch.render.path import padded_rays, view_bytes

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    ASSET_DIR.mkdir(parents=True, exist_ok=True)
    dense, make_s = timed(lambda: make_volume(ASSET_SHAPE, ASSET_SEED))
    g0 = vt.grid.from_dense(dense, bbox_min=ASSET_BBOX_MIN,
                            voxel_size=ASSET_VOXEL,
                            translation=ASSET_TRANSLATION, device=DEV)
    vdb, nvdb = ASSET_DIR / "asset.vdb", ASSET_DIR / "asset.nvdb"
    _, write_vdb_s = timed(lambda: vt.grid.save_vdb(
        g0, str(vdb), compression="blosc+mask"))
    _, write_nvdb_s = timed(lambda: vt.grid.save_nvdb(g0, str(nvdb),
                                                      codec="zip"))
    (g, read_vdb_split_ms), read_vdb_s = timed(lambda: load_split(vdb))
    g_nvdb, read_nvdb_s = timed(lambda: vt.grid.load(str(nvdb), device=DEV))
    blob = vdbio_native.blob_from_dense(
        dense, ASSET_BBOX_MIN, g0.map_mat.cpu().numpy().astype(np.float64),
        g0.map_vec.cpu().numpy().astype(np.float64))
    g_blob, read_blob_s = timed(lambda: vt.grid.from_nanovdb_blob(
        blob, device=DEV))
    same = {"vdb": same_volume(g, g0), "nvdb": same_volume(g_nvdb, g0),
            "blob": same_volume(g_blob, g0)}
    emit("asset_files", shape=list(dense.shape), voxels=int(dense.size),
         occupied=int((dense > 0).sum()), make_s=make_s,
         vdb_bytes=vdb.stat().st_size, nvdb_bytes=nvdb.stat().st_size,
         blob_bytes=len(blob), write_vdb_s=write_vdb_s,
         write_nvdb_s=write_nvdb_s, read_vdb_s=read_vdb_s,
         read_vdb_split_ms=read_vdb_split_ms,
         read_nvdb_s=read_nvdb_s, read_blob_s=read_blob_s,
         loaded_shape=list(g.voxels.shape), exact=same,
         native=vdbio_native.build_info)
    if not all(same.values()):
        raise AssertionError(f"asset: round trip not exact: {same}")
    del dense, blob, g_nvdb, g_blob, g0

    # RAY (discrete, exact) at 1080p through the host-banded build.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.RAY)
    max_steps = r._max_steps
    _, view_steps = r._occupied_clip()
    steps = min(max_steps, view_steps)
    if device_build_ok(r.config, steps, r._march_cell(),
                       r.device_view_budget_bytes):
        raise AssertionError("asset: the 1080p view fits the device budget; "
                             "the host-banded build is not exercised")
    syncs0 = r.host_syncs
    view, build_s = timed(lambda: r._current_view(max_steps))
    if not view.caps:
        raise AssertionError("asset: the view did not come from the "
                             "host-banded build")
    build_syncs = r.host_syncs - syncs0
    r.step(2)
    torch.cuda.synchronize()
    for k in gs.launches:
        gs.launches[k] = 0
    frames = 8
    syncs0 = r.host_syncs
    _, dt = timed(lambda: r.step(frames))
    launches = dict(gs.launches)
    check_image("RAY", r)
    if launches["discrete"] == 0:
        raise AssertionError("asset RAY: no discrete kernel launched")
    lanes = [int(b.wx.shape[1]) for b in view.bands]
    emit("asset_ray", max_steps=max_steps, steps=steps,
         march_cell=r._march_cell(), bands=len(view.bands),
         caps=list(view.caps), lanes=lanes,
         plane_shapes=[list(b.wx.shape) for b in view.bands],
         hit_lanes=int((view.inv_map < view.src.shape[0]).sum()),
         used_samples=int(sum(int(b.lane_need.sum()) for b in view.bands)),
         view_bytes=sum(16 * b.wx.numel() + 4 * b.lane_need.numel()
                        for b in view.bands),
         build_ms=build_s * 1e3, build_host_syncs=build_syncs,
         ms_per_frame=dt / frames * 1e3,
         mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6,
         host_syncs_per_frame=(r.host_syncs - syncs0) / frames,
         launches=launches,
         launches_per_frame={k: v / frames for k, v in launches.items()},
         view_exact=bool(r.view_exact),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         segments_last_frame=int(r.lights.count[0]))

    # Row 2 against its plain version on SEG_RC lanes of the widest band.
    band = max(view.bands, key=lambda b: b.wx.shape[0])
    cut = slice(0, min(SEG_RC, band.wx.shape[1]))
    planes = [t[:, cut].contiguous() for t in
              (band.wx, band.wy, band.wz, band.weight)]
    need = band.lane_need[cut].contiguous()
    lights = photon.generate_lights(r.grid, r.params,
                                    [r.state.frame_count + 1], r.config,
                                    max_steps=max_steps)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    n0 = dict(gs.launches)
    err, abs_err, ms, plain_ms, _ = run_segment_kernel(
        "discrete", planes, segs, need, r.params.light_ray_step_size,
        dict(sphere_radius=None, paired=False))
    gs.launches.update(n0)  # comparison launches are not main-path launches
    emit("asset_segshapes", Cp=planes[0].shape[0], Rc=planes[0].shape[1],
         sublights=sublights(segs, r.params.light_ray_step_size),
         max_rel_err=err, max_abs_err=abs_err, tol=RTOL_SEGMENT, ms=ms,
         plain_ms=plain_ms)
    if not err <= RTOL_SEGMENT:
        raise AssertionError(f"asset: discrete kernel vs plain rel err "
                             f"{err:.3g} > {RTOL_SEGMENT:g}")
    del planes, need, lights, segs

    # POINT, SPHERE and BEAM over the same view; then PATH.
    for name in ("POINT", "SPHERE", "BEAM"):
        torch.cuda.reset_peak_memory_stats()
        r.set_algorithm(vt.Algorithm[name])
        gl.launches = 0
        for k in gs.launches:
            gs.launches[k] = 0
        _, dt = timed(lambda: r.step(2))
        n = gl.launches if name != "BEAM" else gs.launches["discrete"]
        check_image(name, r)
        if n == 0:
            raise AssertionError(f"asset {name}: no lane kernel launched")
        emit("asset_algorithm", algorithm=name, seconds_2frames=dt,
             launches=n, max_memory_allocated=torch.cuda.max_memory_allocated())
        if name == "POINT":  # row 1 on SEG_RC lanes of the widest band
            lights = photon.generate_lights(
                r.grid, r.params, [r.state.frame_count + 1], r.config,
                max_steps=max_steps)
            valid = lights.valid[0].to(torch.int32)
            args = [t[:, cut].contiguous() for t in
                    (band.wx, band.wy, band.wz, band.weight)]
            args += [lights.pos_to[0], lights.intensity[0],
                     torch.argmax(valid), valid.sum()]
            kw = dict(sphere=False, lane_need=band.lane_need[cut].contiguous())
            n0 = gl.launches
            gl.gather_lanes(*args, **kw)  # outside the timing
            got, ms = cuda_timed(lambda: gl.gather_lanes(*args, **kw), 5)
            gl.launches = n0  # comparison launches are not main-path launches
            ref, plain_ms = cuda_timed(lambda: gl.gather_lanes_reference(
                *args, max_elems=PLAIN_ELEMS, **kw))
            err = rel_err(got, ref)
            emit("asset_shapes", Cp=args[0].shape[0], Rc=args[0].shape[1],
                 lights=int(valid.sum()), max_rel_err=err,
                 max_abs_err=float((got - ref).abs().max()), tol=RTOL_EXACT,
                 ms=ms, plain_ms=plain_ms)
            if not err <= RTOL_EXACT:
                raise AssertionError(f"asset: point kernel vs plain rel err "
                                     f"{err:.3g} > {RTOL_EXACT:g}")
            del args, lights
    del r, view, band
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.PATH)
    _, dt = timed(lambda: r.step(2))
    check_image("PATH", r)
    emit("asset_algorithm", algorithm="PATH", seconds_2frames=dt,
         max_steps=r._max_steps,
         path_view_bytes=view_bytes(padded_rays(BENCH_W * BENCH_H,
                                                r._max_steps), r._max_steps),
         path_view_cached=r._path_view is not None,
         host_syncs=r.host_syncs,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del r
    torch.cuda.empty_cache()

    # The host build against the device build where both fit.
    images, fields = {}, {}
    for mode in ("host", "device"):
        r = asset_session(g, 512, 512, vt.Algorithm.RAY, compact_build=mode)
        view, build_s = timed(lambda: r._current_view(r._max_steps))
        r.step(1)
        for k in gs.launches:
            gs.launches[k] = 0
        _, dt = timed(lambda: r.step(2))
        images[mode] = r.image()
        fields[mode] = dict(
            caps=list(view.caps), bands=[list(b.wx.shape) for b in view.bands],
            view_bytes=sum(16 * b.wx.numel() for b in view.bands),
            build_ms=build_s * 1e3, ms_per_frame=dt / 2 * 1e3,
            discrete_launches_per_frame=gs.launches["discrete"] / 2)
        del r, view
    err = float(np.abs(images["host"] - images["device"]).max())
    ok = np.allclose(images["host"], images["device"], rtol=1e-5, atol=1e-7)
    emit("asset_host_vs_device", size=512, **fields, max_abs_err=err,
         rtol=1e-5, atol=1e-7, ok=bool(ok))
    if not ok:
        raise AssertionError(f"asset: host vs device build at 512x512: max "
                             f"abs err {err:.3g}")

    # Top-k planes (gather_samples 12, padded to 16 samples) on the card.
    r = asset_session(g, 512, 512, vt.Algorithm.RAY, gather_samples=12)
    for k in gs.launches:
        gs.launches[k] = 0
    _, dt = timed(lambda: r.step(3))
    check_image("RAY gather_samples", r)
    band = max(r._view.bands, key=lambda b: b.wx.shape[1])
    planes = [t[:, cut].contiguous() for t in
              (band.wx, band.wy, band.wz, band.weight)]
    lights = photon.generate_lights(r.grid, r.params,
                                    [r.state.frame_count + 1], r.config,
                                    max_steps=r._max_steps)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    n0 = dict(gs.launches)
    err, _, ms, plain_ms, _ = run_segment_kernel(
        "discrete", planes, segs, band.lane_need[cut].contiguous(),
        r.params.light_ray_step_size, dict(sphere_radius=None, paired=False))
    gs.launches.update(n0)  # comparison launches are not main-path launches
    emit("asset_topk", size=512, gather_samples=12,
         view_exact=bool(r.view_exact), caps=list(r._view.caps),
         plane_shapes=[list(b.wx.shape) for b in r._view.bands],
         seconds_3frames=dt, discrete_launches=n0["discrete"],
         max_rel_err=err, tol=RTOL_SEGMENT, ms=ms, plain_ms=plain_ms)
    if r.view_exact or n0["discrete"] == 0 or not err <= RTOL_SEGMENT:
        raise AssertionError(f"asset top-k: exact view, no launch or rel "
                             f"err {err:.3g} > {RTOL_SEGMENT:g}")
    del r, band, planes, lights, segs
    torch.cuda.empty_cache()

    # The command line, in subprocesses, against the same session here.
    out = ASSET_DIR / "cli.ppm"
    cmds = {"render": ["render", "--volume", str(vdb), "--size", "512",
                       "--frames", "4", "--out", str(out)],
            "bench": ["bench"], "warmup": ["warmup", "--size", "256"]}
    cli_s = {}
    for name, argv in cmds.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "volumerenderer_tpu_torch", *argv],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        cli_s[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"asset: the {name} command exited "
                                 f"{proc.returncode}:\n{proc.stderr}")
        cli_s[name + "_stdout"] = proc.stdout.strip().splitlines()[-1]
    args = argparse.Namespace(volume=str(vdb), size=512, algorithm="RAY",
                              fast="off", device=DEV)
    r = cli._make_renderer(args)
    r.step(4)
    same_ppm = bool(np.array_equal(ppm.read_ppm(str(out)), r.image_u8()))
    emit("asset_cli", **cli_s, ppm_equals_session=same_ppm,
         phase_s=time.perf_counter() - t_phase)
    if not same_ppm:
        raise AssertionError("asset: the render command's PPM differs from "
                             "the same session's image")



def live_window(band, n: int) -> slice:
    """The ``n``-lane window of a band (starts in steps of 1,024 lanes)
    that holds the most live samples (w != 0)."""
    import torch

    per_lane = (band.weight != 0).sum(dim=0)
    Rc = per_lane.shape[0]
    if Rc <= n:
        return slice(0, Rc)
    csum = torch.cat([per_lane.new_zeros(1), torch.cumsum(per_lane, 0)])
    starts = torch.arange(0, Rc - n + 1, 1024, device=per_lane.device)
    a = int(starts[torch.argmax(csum[starts + n] - csum[starts])])
    return slice(a, a + n)


def lane_slice(band, cut):
    """A band's planes and lane_need over lanes ``cut``, contiguous."""
    planes = [t[:, cut].contiguous() for t in
              (band.wx, band.wy, band.wz, band.weight)]
    return planes, band.lane_need[cut].contiguous()


def next_lights(r):
    """The lights of the session's next frame; on a mesh (``r.mesh``), cut
    to the rank's shard of the light slots, as its kernels take them."""
    from volumerenderer_tpu_torch.parallel import sharding
    from volumerenderer_tpu_torch.render import photon

    lights = photon.generate_lights(r.grid, r.params,
                                    [r.state.frame_count + 1], r.config,
                                    max_steps=r._max_steps)
    mesh = getattr(r, "mesh", None)
    return lights if mesh is None else sharding._light_shard(lights, mesh,
                                                             r.config)


def asset_row2(r, view, label):
    """Row 2 (the lane discrete kernel) against its plain version on the
    SEG_RC lanes of the view's band window with the most live samples, and
    its launches over the whole view, as a frame makes them (view_ms), and
    over no valid segment (view_scan_ms): returns the kernel line's
    figures."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    band = max(view.bands, key=lambda b: int((b.weight != 0).sum()))
    planes, need = lane_slice(band, live_window(band, SEG_RC))
    lights = next_lights(r)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    step = r.params.light_ray_step_size
    n0 = dict(gs.launches)
    err, abs_err, ms, plain_ms, _ = run_segment_kernel(
        "discrete", planes, segs, need, step,
        dict(sphere_radius=None, paired=False))

    # The whole view as a frame shades it (every band's launch), and the
    # same launches with no valid segment: the scan and lane sums alone.
    def shade(valid):
        for b in view.bands:
            gs.gather_segments_discrete_lanes(
                b.wx, b.wy, b.wz, b.weight, *segs[:3], valid, step,
                lane_need=b.lane_need)

    shade(segs[3])
    _, view_ms = cuda_timed(lambda: shade(segs[3]), 3)
    _, view_scan_ms = cuda_timed(lambda: shade(torch.zeros_like(segs[3])), 3)
    gs.launches.update(n0)  # comparison launches are not main-path launches
    live = int((planes[3] != 0).sum())
    bound_ms, bound_by = lane_bound(
        planes[3], need, ops_per_sample("discrete-ray", segs=segs, step=step),
        32 * segs[0].shape[0], call_ops("discrete-ray", segs=segs, step=step))
    fields = dict(Cp=planes[0].shape[0], Rc=planes[0].shape[1],
                  live_samples=live, used_samples=int(need.sum()),
                  sublights=sublights(segs, step), max_rel_err=err,
                  max_abs_err=abs_err, tol=RTOL_SEGMENT, ms=ms,
                  plain_ms=plain_ms, ns_per_live_sample=ms * 1e6 / max(live, 1),
                  bound_ms=bound_ms, bound_by=bound_by, view_ms=view_ms,
                  view_scan_ms=view_scan_ms)
    emit("options_asset_row2", view=label, **fields)
    if not err <= RTOL_SEGMENT:
        raise AssertionError(f"options asset {label}: discrete kernel vs "
                             f"plain rel err {err:.3g} > {RTOL_SEGMENT:g}")
    return fields


def asset_row1(r, view, label):
    """Row 1 (the lane point kernel) against its plain version on the
    SEG_RC lanes of the view's band window with the most live samples,
    with the next frame's lights: returns the kernel line's figures."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl

    band = max(view.bands, key=lambda b: int((b.weight != 0).sum()))
    planes, need = lane_slice(band, live_window(band, SEG_RC))
    lights = next_lights(r)
    valid = lights.valid[0].to(torch.int32)
    args = planes + [lights.pos_to[0], lights.intensity[0],
                     torch.argmax(valid), valid.sum()]
    kw = dict(sphere=False, lane_need=need)
    n0 = gl.launches
    gl.gather_lanes(*args, **kw)  # outside the timing
    got, ms = cuda_timed(lambda: gl.gather_lanes(*args, **kw), 5)
    gl.launches = n0  # comparison launches are not main-path launches
    ref, plain_ms = cuda_timed(lambda: gl.gather_lanes_reference(
        *args, max_elems=PLAIN_ELEMS, **kw))
    err = rel_err(got, ref)
    live = int((planes[3] != 0).sum())
    bound_ms, bound_by = lane_bound(planes[3], need,
                                    ops_per_sample("point", int(valid.sum())),
                                    16 * int(valid.sum()))
    fields = dict(Cp=planes[0].shape[0], Rc=planes[0].shape[1],
                  lights=int(valid.sum()), live_samples=live,
                  used_samples=int(need.sum()), max_rel_err=err,
                  max_abs_err=float((got - ref).abs().max()), tol=RTOL_EXACT,
                  ms=ms, plain_ms=plain_ms,
                  ns_per_live_sample=ms * 1e6 / max(live, 1),
                  bound_ms=bound_ms, bound_by=bound_by)
    emit("options_asset_row1", view=label, **fields)
    if not err <= RTOL_EXACT:
        raise AssertionError(f"options asset {label}: point kernel vs plain "
                             f"rel err {err:.3g} > {RTOL_EXACT:g}")
    return fields


def clip_loss(r, clip_box, every: int = 4, tile: int = 65536):
    """Question (c): trilinear samples the occupied-box clip leaves out.
    Every ``every``-th camera ray is marched trilinearly with and without
    the clip box; counts the unclipped march's samples of nonzero density
    that lie outside the clipped march's [tmin, tmax), and the largest
    difference of a ray's summed weights."""
    import torch

    from volumerenderer_tpu_torch.ops import march as march_ops
    from volumerenderer_tpu_torch.render.color import camera_rays_index

    o_i, d_i = camera_rays_index(r.grid, r.params, r.config)
    o_i, d_i = o_i[::every].contiguous(), d_i[::every].contiguous()
    p = r.params
    kw = dict(ray_max_distance=p.ray_max_distance,
              step_size=p.ray_marching_step_size,
              absorption=p.absorption_coefficient,
              max_steps=r._max_steps, interpolation="trilinear")
    lost, lost_max, wsum_diff = 0, 0.0, 0.0
    for a in range(0, o_i.shape[0], tile):
        o, d = o_i[a:a + tile], d_i[a:a + tile]
        full = march_ops.march(r.grid, o, d, **kw)
        clipped = march_ops.march(r.grid, o, d, clip_box=clip_box, **kw)
        out = ((full.val > 0) & full.active
               & ((full.t < clipped.tmin[:, None])
                  | (full.t >= clipped.tmax[:, None])))
        lost += int(out.sum())
        lost_max = max(lost_max, float(torch.where(out, full.val, 0.0).max()))
        wsum_diff = max(wsum_diff, float(
            (full.weight.sum(-1) - clipped.weight.sum(-1)).abs().max()))
        del full, clipped, out
    return dict(rays=int(o_i.shape[0]), lost_samples=lost,
                lost_max_density=lost_max,
                max_ray_weight_sum_diff=wsum_diff)


def phase_options_asset(g):
    """The asset at 1920x1080 under trilinear through the host-banded
    build at the full step budget: RAY discrete exact, the image against
    nearest's, row 2 then row 1 against plain on its band with the most
    live samples (each beside the nearest view's), the occupied-box clip's
    trilinear samples."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.render.color import device_build_ok

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.RAY,
                      interpolation="trilinear")
    max_steps = r._max_steps
    clip_box, view_steps = r._occupied_clip()
    steps = min(max_steps, view_steps)
    if device_build_ok(r.config, steps, r._march_cell(),
                       r.device_view_budget_bytes):
        raise AssertionError("options asset: the trilinear view fits the "
                             "device budget; the host-banded build is not "
                             "exercised")
    syncs0 = r.host_syncs
    view, build_s = timed(lambda: r._current_view(max_steps))
    if not view.caps:
        raise AssertionError("options asset: the view did not come from the "
                             "host-banded build")
    build_syncs = r.host_syncs - syncs0
    build_peak = torch.cuda.max_memory_allocated()
    r.step(2)
    for k in gs.launches:
        gs.launches[k] = 0
    frames = 8
    syncs0 = r.host_syncs
    _, dt = timed(lambda: r.step(frames))
    launches = dict(gs.launches)
    check_image("RAY trilinear", r)
    if launches["discrete"] == 0:
        raise AssertionError("options asset RAY: no discrete kernel launched")
    stored = sum(b.weight.numel() for b in view.bands)
    emit("options_asset", interpolation="trilinear", max_steps=max_steps,
         steps=steps, bands=len(view.bands), caps=list(view.caps),
         lanes=[int(b.wx.shape[1]) for b in view.bands],
         plane_shapes=[list(b.wx.shape) for b in view.bands],
         view_bytes=sum(16 * b.wx.numel() + 4 * b.lane_need.numel()
                        for b in view.bands),
         build_ms=build_s * 1e3, build_host_syncs=build_syncs,
         build_max_memory_allocated=build_peak,
         stored_samples=stored,
         used_samples=sum(int(b.lane_need.sum()) for b in view.bands),
         live_samples=sum(int((b.weight != 0).sum()) for b in view.bands),
         ms_per_frame=dt / frames * 1e3,
         mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6,
         host_syncs_per_frame=(r.host_syncs - syncs0) / frames,
         launches=launches,
         launches_per_frame={k: v / frames for k, v in launches.items()},
         view_exact=bool(r.view_exact),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         segments_last_frame=int(r.lights.count[0]))

    # The nearest session at the same frame: the images differ; row 2 on
    # its widest band beside the trilinear one's, per live sample.
    rn = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.RAY)
    rn.step(2 + frames)
    diff = (r.state.accum - rn.state.accum).abs()
    emit("options_asset_vs_nearest", max_abs_diff=float(diff.max()),
         mean_abs_diff=float(diff.mean()),
         nearest_live_samples=sum(int((b.weight != 0).sum())
                                  for b in rn._view.bands),
         nearest_stored_samples=sum(b.weight.numel()
                                    for b in rn._view.bands))
    if not float(diff.max()) > 1e-3:
        raise AssertionError("options asset: the trilinear image equals the "
                             "nearest one")
    row2 = asset_row2(r, view, "trilinear")
    asset_row2(rn, rn._view, "nearest")
    asset_row1(rn, rn._view, "nearest")
    del rn, diff
    torch.cuda.empty_cache()

    # Row 1 (POINT) over the same view.
    r.set_algorithm(vt.Algorithm.POINT)
    gl.launches = 0
    _, dt = timed(lambda: r.step(2))
    point_launches = gl.launches
    check_image("POINT trilinear", r)
    if point_launches == 0:
        raise AssertionError("options asset POINT: no lane kernel launched")
    emit("options_asset_point", seconds_2frames=dt, launches=point_launches)
    row1 = asset_row1(r, view, "trilinear")

    emit("options_asset_clip", **clip_loss(r, clip_box))
    del r, view
    torch.cuda.empty_cache()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return [("gather_segments_discrete[ray,exact] trilinear asset", "discrete",
             launches["discrete"], {k: row2[k] for k in keys}),
            ("gather_lanes[exact] trilinear asset", "lanes", point_launches,
             {k: row1[k] for k in keys})]


OPTION_RUNS = (  # (label, algorithm, StaticConfig fields) of options_bench
    ("POINT exact compact", "POINT", {}),
    ("RAY discrete exact compact", "RAY", {}),
    ("RAY analytic paired compact", "RAY",
     dict(segment_mode="analytic", segment_eval="paired")),
    ("POINT exact slots", "POINT", dict(compact_view=False)),
    ("RAY discrete exact slots", "RAY", dict(compact_view=False)),
)


def phase_options_bench():
    """The bench config under trilinear: the compact view (the device
    build in identity order, no occupancy read) and the slots view; rows
    4 and 5 against plain on SLOT_RAYS rays of the ViewCache; the slots
    images against the compact ones."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv
    from volumerenderer_tpu_torch.utils import profiling

    images, entries = {}, []
    for label, algo_name, cfg in OPTION_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = bench_renderer("exact", vt.Algorithm[algo_name],
                           interpolation="trilinear", **cfg)
        build_reads = profiling.totals().get(("sync", "color.build"), 0)
        r.step(8)  # the view build and one batch
        build_reads = (profiling.totals().get(("sync", "color.build"), 0)
                       - build_reads)
        gl.launches = 0
        for counts in (gs.launches, gv.launches):
            for k in counts:
                counts[k] = 0
        frames = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step(frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"lanes": gl.launches, **gs.launches,
                    **{f"slots_{k}": v for k, v in gv.launches.items()}}
        check_image(f"bench trilinear {label}", r)
        slots = "compact_view" in cfg
        if slots:
            key, kind = slot_kind(algo_name, "discrete")
            n = launches[f"slots_{key}"]
        else:
            key = "lanes" if algo_name == "POINT" else cfg.get(
                "segment_mode", "discrete")
            n = launches[key]
            v = r._view
            identity = bool(torch.equal(
                v.src[:v.n_rays].to(torch.int64),
                torch.arange(v.n_rays, device=v.src.device)))
            if v.caps or build_reads or not identity:
                raise AssertionError(f"bench trilinear {label}: not the "
                                     "identity-ordered device build")
        if n == 0:
            raise AssertionError(f"bench trilinear {label}: no {key} kernel "
                                 "launched")
        weights = ([r._view.weight] if slots
                   else [b.weight for b in r._view.bands])
        fields = dict(run=label, ms_per_frame=dt / frames * 1e3,
                      mrays_per_s=BENCH_W * BENCH_H * frames / dt / 1e6,
                      launches={k: v for k, v in launches.items() if v},
                      launches_per_frame=n / frames,
                      stored_samples=sum(w.numel() for w in weights),
                      live_samples=sum(int((w != 0).sum()) for w in weights),
                      max_memory_allocated=torch.cuda.max_memory_allocated())
        if slots:
            ref = images[label.replace("slots", "compact")]
            img = r.state.accum
            excess = float(((img - ref).abs() - 1e-5 * ref.abs()).max())
            fields.update(vs_compact_max_abs=float((img - ref).abs().max()),
                          vs_compact_ok=excess <= 1e-7)
            if not excess <= 1e-7:
                raise AssertionError(f"bench trilinear {label}: the slots "
                                     "image differs from the compact one "
                                     "beyond rtol 1e-5, atol 1e-7")
            variant = "point" if algo_name == "POINT" else "ray"
            entries.append((f"{key}[{variant},exact] trilinear", key, n,
                            slots_row(r, kind)))
        else:
            images[label] = r.state.accum.clone()
        emit("options_bench", **fields)
        del r
    return entries


def slots_row(r, kind):
    """Row 4 (POINT) or row 5 (RAY discrete) against its plain version on
    SLOT_RAYS rays of the live ViewCache around the image centre."""
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    v = r._view
    a = max(0, min(v.n_rays // 2 - SLOT_RAYS // 2, v.wx.shape[0] - SLOT_RAYS))
    planes = [t[a:a + SLOT_RAYS].contiguous()
              for t in (v.wx, v.wy, v.wz, v.weight)]
    lights = next_lights(r)
    segs = (lights.pos_from[0], lights.pos_to[0], lights.intensity[0],
            lights.valid[0])
    step = r.params.light_ray_step_size
    once = 0
    if kind == "vpu":
        valid = segs[3].to(torch.int32)
        count = int(valid.sum())
        light_args = (lights.pos_to[0], lights.intensity[0],
                      int(valid.argmax()), count)
        kw = dict(sphere=False, paired=False)
        per_sample, table = ops_per_sample("point", lights=count), 16 * count
    else:
        light_args = None
        kw = dict(sphere_radius=None, paired=False)
        per_sample = ops_per_sample("discrete-ray", segs=segs, step=step)
        once = call_ops("discrete-ray", segs=segs, step=step)
        table = 32 * segs[0].shape[0]
    n0 = dict(gv.launches)
    err, abs_err, ms, plain_ms, _ = run_slot_kernel(
        kind, planes, segs, light_args, step, kw, reps=5)
    gv.launches.update(n0)  # comparison launches are not main-path launches
    tol = slot_tol(kind, kw)
    bound_ms, bound_by = slot_bound(planes[3], per_sample, table, once)
    emit("options_bench_slotshapes", kernel=kind, R=SLOT_RAYS,
         C=planes[0].shape[1], live_samples=int((planes[3] != 0).sum()),
         max_rel_err=err, max_abs_err=abs_err, tol=tol, ms=ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    if not err <= tol:
        raise AssertionError(f"bench trilinear: {kind} slot kernel vs plain "
                             f"rel err {err:.3g} > {tol:g}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_options_u8():
    """POINT exact at the bench config with accum_dtype="uint8": after
    step(1) the accumulator equals a float32 session's, quantized, bit for
    bit; after step(8) every value lies on the k/255 grid."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl

    r8 = bench_renderer("exact", vt.Algorithm.POINT, accum_dtype="uint8")
    rf = bench_renderer("exact", vt.Algorithm.POINT)
    r8.step(1)
    rf.step(1)
    want = torch.round(torch.clamp(rf.state.accum, 0.0, 1.0) * 255.0) / 255.0
    first_equal = bool(torch.equal(r8.state.accum, want))
    del rf, want
    gl.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r8.step(7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    a = r8.state.accum
    on_grid = bool(torch.equal(a, torch.round(a * 255.0) / 255.0))
    emit("options_u8", first_frame_equals_quantized_f32=first_equal,
         on_grid_after_8=on_grid, frames=r8.state.frame_count,
         ms_per_frame=dt / 7 * 1e3, launches=gl.launches,
         levels=int(torch.unique(a).numel()), max=float(a.max()))
    if not (first_equal and on_grid and gl.launches > 0
            and float(a.max()) > 0):
        raise AssertionError("options u8: the quantized accumulator is off "
                             "the k/255 grid, differs from the quantized "
                             "float32 frame, or no kernel launched")


def phase_options():
    """The slice options (trilinear, uint8): the asset, the bench config
    and the uint8 accumulator; returns the kernel line's entries."""
    import volumerenderer_tpu_torch as vt

    t0 = time.perf_counter()
    g = vt.grid.load(str(ASSET_DIR / "asset.vdb"), device=DEV)
    entries = phase_options_asset(g)
    del g
    entries += phase_options_bench()
    phase_options_u8()
    emit("options_phase", seconds=time.perf_counter() - t0)
    return entries


def phase_density():
    """The density harness on the asset loaded from .vdb: the reference's
    CPU_test as it is (256x256, camera (0, 250, -800), fov 45, t_max 1200,
    dt 1, world-as-index), and at 1920x1080 with apply_transform=True from
    the asset's camera."""
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.render import density

    g = vt.grid.load(str(ASSET_DIR / "asset.vdb"), device=DEV)
    runs = (("reference harness", {}),
            ("1080p transform", dict(width=BENCH_W, height=BENCH_H,
                                     camera_pos=ASSET_CAMERA,
                                     apply_transform=True)))
    for label, kw in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = density.render_density(g, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        u8 = density.to_grayscale_u8(img)
        emit("density", run=label, shape=list(img.shape), seconds=dt,
             max=float(img.max()), nonzero=int((img > 0).sum()),
             gray_max=int(u8.max()), finite=bool(torch.isfinite(img).all()))
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"density {label}: not finite")
        if kw and not float(img.max()) > 0:
            raise AssertionError(f"density {label}: all zero")


def phase_aux():
    """Checkpoint, debug views, profiling, memory statistics and the viewer
    on the card: a 1080p asset RAY session."""
    import glob
    import importlib.util
    import os

    import numpy as np
    import torch

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch import viewer
    from volumerenderer_tpu_torch.io import checkpoint
    from volumerenderer_tpu_torch.render import debug_views
    from volumerenderer_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    g = vt.grid.load(str(ASSET_DIR / "asset.vdb"), device=DEV)
    r = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.RAY)
    r.step(3)
    ckpt = str(ASSET_DIR / "aux_checkpoint.npz")
    checkpoint.save(r, ckpt)
    lit = {name: int(fn(r.params, r.lights, r.config).sum())
           for name, fn in (("point", debug_views.view_point_lights),
                            ("ray", debug_views.view_ray_lights))}
    log_dir = str(ASSET_DIR / "trace")
    for f in glob.glob(os.path.join(log_dir, "*.json")):
        os.remove(f)
    with profiling.trace(log_dir) as prof:
        r.step(1)
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    traced = sorted(n for n in names if "discrete_kernel" in n)
    r.step(1)
    want = r.image()
    r2 = asset_session(g, BENCH_W, BENCH_H, vt.Algorithm.POINT)
    checkpoint.load(r2, ckpt)
    resumed_at = r2.state.frame_count
    r2.step(2)
    resumed_equal = bool(np.array_equal(r2.image(), want))
    stats = profiling.device_memory_stats()
    del r, r2
    torch.cuda.empty_cache()
    rv = asset_session(g, 512, 512, vt.Algorithm.RAY)
    png = ASSET_DIR / "offline.png"
    img = viewer.render_offline(rv, 4, str(png))
    tick = "matplotlib not installed"
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib

        matplotlib.use("Agg")
        v = viewer.InteractiveViewer(rv)
        v.tick()
        tick = v.fps_text.get_text()
    emit("aux", lit_pixels=lit, checkpoint_resumed_at=resumed_at,
         checkpoint_resume_bit_equal=resumed_equal,
         trace_file=os.path.basename(prof.trace_path),
         trace_bytes=os.path.getsize(prof.trace_path),
         trace_discrete_kernels=traced[:3],
         memory_stats_devices=sorted(stats),
         peak_allocated=stats["cuda:0"].get("allocated_bytes.all.peak"),
         offline_png_bytes=png.stat().st_size,
         offline_shape=list(img.shape), viewer_tick=tick,
         seconds=time.perf_counter() - t0)
    if not (resumed_at == 3 and resumed_equal):
        raise AssertionError("aux: the checkpoint did not resume bit for bit")
    if not (lit["point"] > 0 and lit["ray"] > 0):
        raise AssertionError(f"aux: a debug view lit no pixel: {lit}")
    if not traced:
        raise AssertionError("aux: the trace names no discrete kernel")
    if "cuda:0" not in stats or not stats["cuda:0"]:
        raise AssertionError("aux: no memory statistics for cuda:0")
    if img.shape != (512, 512, 3) or not png.stat().st_size:
        raise AssertionError("aux: render_offline wrote no 512x512 PNG")


# The mesh phase: volumerenderer_tpu_torch.parallel at the bench config.
MESH_RUNS = (  # (label, algorithm, StaticConfig fields) of mesh (a)
    ("POINT exact", "POINT", {}),
    ("POINT paired", "POINT", {"gather_eval": "paired"}),
    ("RAY discrete exact", "RAY", {}),
    ("PATH cached", "PATH", {}),
)
MESH_RANK_RUNS = MESH_RUNS[0], MESH_RUNS[2]  # the (2, 2) world's sessions
# step() calls of a session, the last one timed: the first frame alone
# (RAY's is the light-sharded frame's reference), single frames, then
# batches of 8.  PATH renders single frames.
MESH_STEPS = {"POINT": (1, 7, 16), "RAY": (1, 7, 16), "PATH": (1, 1, 4)}
# A world of one against the single-device Renderer: the same view,
# kernels and sums, so equal but for rounding of the accumulation.
MESH_RTOL, MESH_ATOL = 1e-6, 1e-7
# Sharded over "lights" against the single device: JAX's sharded bound
# (tests/test_sharding.py).
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 1e-6
# The kernel each mesh session must launch (REPLACES keys): rows 1, 2, 5.
MESH_KERNELS = {"POINT": "lanes", "RAY": "discrete", "PATH": None,
                "RAY light_sharded_radiance": "segment_discrete"}


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count, by REPLACES key."""
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    return {"lanes": gl.launches, **gs.launches, **gv.launches,
            **gm.launches}


def reset_kernel_counts() -> None:
    from volumerenderer_tpu_torch.ops.kernels import gather_lanes as gl
    from volumerenderer_tpu_torch.ops.kernels import gather_many as gm
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.ops.kernels import gather_vpu as gv

    gl.launches = 0
    for counts in (gs.launches, gv.launches, gm.launches):
        for k in counts:
            counts[k] = 0


def require_launches(what: str, counts: dict, key) -> None:
    if key is not None and counts[key] == 0:
        raise AssertionError(f"mesh {what}: no {key} kernel launch")


def mesh_scene(dev: str, width: int, height: int, algo_name: str, fields):
    """The bench config's grid, params and config on ``dev``."""
    import volumerenderer_tpu_torch as vt

    grid = vt.grid.procedural.cloud(n=96, device=dev)
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 20.0, -75.0), light_source_world_pos=(0.0, 20.0, 20.0))
    config = vt.StaticConfig(width=width, height=height, **fields)
    return grid, params, config, vt.Algorithm[algo_name]


def drive(session, steps, dev: str):
    """Run ``session.step`` for each count; returns (ms per frame of the
    last call, the accumulator after the first call)."""
    import torch

    session.step(steps[0])
    first = session.state.accum.clone()
    for n in steps[1:-1]:
        session.step(n)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    session.step(steps[-1])
    sync()
    return (time.perf_counter() - t0) / steps[-1] * 1e3, first


def peak_memory(dev: str):
    import torch

    return torch.cuda.max_memory_allocated() if dev == "cuda" else None


def reset_peak_memory(dev: str) -> None:
    import torch

    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_mesh_one():
    """(a) A world of one rank (NCCL on the card): each MESH_RUNS session
    through MeshRenderer against the single-device Renderer driven by the
    same step() calls.  Returns the Renderer's images the (2, 2) world is
    held against and the kernels line's entries of the mesh path."""
    import tempfile

    import torch
    import torch.distributed as dist

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.parallel import sharding

    refs, entries = {}, []
    backend = "nccl" if DEV == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = sharding.make_mesh(1, device=DEV)
            for label, algo_name, fields in MESH_RUNS:
                grid, params, config, algo = mesh_scene(
                    DEV, BENCH_W, BENCH_H, algo_name, fields)
                steps = MESH_STEPS[algo_name]
                reset_peak_memory(DEV)
                r = vt.Renderer(grid, config, params, algorithm=algo,
                                device=DEV)
                single_ms, first = drive(r, steps, DEV)
                single_peak = peak_memory(DEV)
                want = r.state.accum
                refs[label] = want.cpu()
                if algo_name == "RAY":
                    refs["RAY frame 1"] = first.cpu()
                del r, first
                reset_peak_memory(DEV)
                reset_kernel_counts()
                mr = sharding.MeshRenderer(grid, mesh, config, params, algo)
                ms, _ = drive(mr, steps, DEV)
                counts = kernel_counts()
                got = torch.as_tensor(mr.image()[..., 0], device=DEV)
                frames = sum(steps)
                if not (bool(torch.isfinite(got).all())
                        and float(got.max()) > 0):
                    raise AssertionError(f"mesh {label}: image not finite "
                                         "or all zero")
                emit("mesh", part="a", run=label, world=1,
                     backend=dist.get_backend(), mesh=list(mesh.shape),
                     frames=frames, ms_per_frame=ms,
                     single_ms_per_frame=single_ms, launches=counts,
                     launches_per_frame={k: v / frames
                                         for k, v in counts.items() if v},
                     max_memory_allocated=peak_memory(DEV),
                     single_max_memory_allocated=single_peak,
                     bit_equal=bool(torch.equal(got, want)),
                     max_abs_err=float((got - want).abs().max()),
                     rtol=MESH_RTOL, atol=MESH_ATOL)
                require_launches(label, counts, MESH_KERNELS[algo_name])
                if not torch.allclose(got, want, rtol=MESH_RTOL,
                                      atol=MESH_ATOL):
                    raise AssertionError(
                        f"mesh {label}: the world of one differs from the "
                        f"Renderer by {float((got - want).abs().max()):.3g}")
                key = MESH_KERNELS[algo_name]
                if key == "lanes":
                    tier = config.gather_eval
                    entries.append(dict(
                        name=f"gather_lanes[{tier}] mesh", route="cuda",
                        source="volumerenderer_tpu_torch/csrc/gather_lanes.cu",
                        replaces=REPLACES[key], launches=counts[key],
                        **phase_shapes(mr, tier)))
                elif key == "discrete":
                    entries.append(dict(
                        name="gather_segments_discrete[ray,exact] mesh",
                        route="cuda",
                        source="volumerenderer_tpu_torch/csrc/"
                               "gather_segments.cu",
                        replaces=REPLACES[key], launches=counts[key],
                        **phase_segment_shapes(mr, "RAY", "discrete",
                                               "exact", "midpoint")))
                del mr, got, want
        finally:
            dist.destroy_process_group()
    return refs, entries


def mesh_rank(out_dir: str, dev: str, width: int, height: int) -> None:
    """A rank of the (2, 2) world: MESH_RANK_RUNS through MeshRenderer and
    RAY's first frame through light_sharded_radiance; writes its launches,
    peak memory and ms/frame, and (rank 0) the gathered images and each
    run's kernel against its plain version at rank 0's inputs: its band's
    view and its shard of the light slots (the other ranks wait)."""
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from volumerenderer_tpu_torch.engine.state import RenderState
    from volumerenderer_tpu_torch.parallel import sharding
    from volumerenderer_tpu_torch.render.color import required_march_steps

    mesh = sharding.make_mesh(2, device=dev)
    rank = dist.get_rank()
    out = dict(rank=rank, rows_index=mesh.get_local_rank("rows"),
               lights_index=mesh.get_local_rank("lights"),
               device=str(sharding.mesh_device(mesh)),
               backend=dist.get_backend())
    images, kernels = {}, {}
    check = rank == 0
    for label, algo_name, fields in MESH_RANK_RUNS:
        grid, params, config, algo = mesh_scene(dev, width, height,
                                                algo_name, fields)
        reset_peak_memory(dev)
        reset_kernel_counts()
        mr = sharding.MeshRenderer(grid, mesh, config, params, algo)
        ms, _ = drive(mr, MESH_STEPS[algo_name], dev)
        out[label] = dict(launches=kernel_counts(), ms_per_frame=ms,
                          max_memory_allocated=peak_memory(dev))
        images[label] = mr.image()[..., 0]
        if check:
            kernels[label] = (
                phase_shapes(mr, "exact") if algo_name == "POINT" else
                phase_segment_shapes(mr, "RAY", "discrete", "exact",
                                     "midpoint"))
        dist.barrier()
        del mr
    label = "RAY light_sharded_radiance"
    reset_peak_memory(dev)
    reset_kernel_counts()
    band = sharding.shard_rows(mesh, torch.zeros((height, width)))
    frame = sharding.light_sharded_radiance(
        grid, params, RenderState(band, 0), algorithm=algo, config=config,
        max_steps=required_march_steps(grid, params.ray_marching_step_size,
                                       config.max_march_steps), mesh=mesh)
    out[label] = dict(launches=kernel_counts(),
                      max_memory_allocated=peak_memory(dev))
    images[label] = sharding.gather_rows(mesh, frame).cpu().numpy()
    if check:  # the band's slots view, as render_frame marches it
        steps = required_march_steps(grid, params.ray_marching_step_size,
                                     config.max_march_steps)
        uncached = types.SimpleNamespace(
            _view=sharding.build_view_sharded(
                grid, params, config=config, max_steps=steps, mesh=mesh),
            grid=grid, params=params, config=config, _max_steps=steps,
            mesh=mesh, state=RenderState(band, 0))
        kernels[label] = phase_slot_shapes(uncached, "RAY", "exact",
                                           "discrete", "exact", "midpoint")
        out["kernels"] = kernels
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        np.savez(Path(out_dir, "images.npz"), **images)


# (b)'s kernels line entries: (run label, REPLACES key, name, source).
MESH_RANK_KERNELS = (
    ("POINT exact", "lanes", "gather_lanes[exact]", "gather_lanes.cu"),
    ("RAY discrete exact", "discrete", "gather_segments_discrete[ray,exact]",
     "gather_segments.cu"),
    ("RAY light_sharded_radiance", "segment_discrete",
     "segment_discrete[ray,exact]", "gather_vpu.cu"),
)


def phase_mesh_ranks(refs):
    """(b) A (2, 2) world of 4 gloo ranks, all on this card: each run's
    gathered image within SHARDED_RTOL/ATOL of (a)'s single-device frame
    (the light-sharded frame of the Renderer's first RAY frame), and on
    every rank a launch of the run's kernel.  Returns the kernels line's
    entries of (b): each run's kernel against its plain version at rank
    0's inputs, with rank 0's launches."""
    import tempfile

    import numpy as np

    from volumerenderer_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launch.launch(mesh_rank, 4, tmp, DEV, BENCH_W, BENCH_H, device=DEV)
        ranks = [json.loads(Path(tmp, f"rank{i}.json").read_text())
                 for i in range(4)]
        with np.load(Path(tmp, "images.npz")) as f:
            images = dict(f)
    seconds = time.perf_counter() - t0
    checks = {}
    for label, ref in (("POINT exact", "POINT exact"),
                       ("RAY discrete exact", "RAY discrete exact"),
                       ("RAY light_sharded_radiance", "RAY frame 1")):
        got, want = images[label], refs[ref].numpy()
        checks[label] = dict(
            max_abs_err=float(np.abs(got - want).max()),
            ok=bool(np.allclose(got, want, rtol=SHARDED_RTOL,
                                atol=SHARDED_ATOL)
                    and np.isfinite(got).all() and got.max() > 0))
    emit("mesh", part="b", world=4, mesh=[2, 2], ranks=ranks,
         against_single_device=checks, rtol=SHARDED_RTOL, atol=SHARDED_ATOL,
         seconds=seconds)
    for rk in ranks:
        for label, key, _, _ in MESH_RANK_KERNELS:
            require_launches(f"rank {rk['rank']} {label}",
                             rk[label]["launches"], key)
    bad = [k for k, v in checks.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"mesh (2, 2): {bad} differ from the single "
                             f"device beyond rtol {SHARDED_RTOL:g}, atol "
                             f"{SHARDED_ATOL:g}: {checks}")
    return [dict(name=f"{name} mesh (2,2)", route="cuda",
                 source=f"volumerenderer_tpu_torch/csrc/{source}",
                 replaces=REPLACES[key],
                 launches=ranks[0][label]["launches"][key],
                 **ranks[0]["kernels"][label])
            for label, key, name, source in MESH_RANK_KERNELS]


def phase_mesh():
    """The mesh phase: (a) a world of one, (b) a (2, 2) world on this card,
    (c) the dry run on 4 ranks.  Returns (a)'s and (b)'s kernels line
    entries."""
    from volumerenderer_tpu_torch.parallel import dryrun_multichip

    t0 = time.perf_counter()
    refs, entries = phase_mesh_one()
    entries += phase_mesh_ranks(refs)
    t1 = time.perf_counter()
    dryrun_multichip(4, device=DEV)
    emit("mesh", part="c", dryrun_ranks=4,
         seconds=time.perf_counter() - t1,
         phase_seconds=time.perf_counter() - t0)
    return entries


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
    main_runs = {tier: phase_main(tier) for tier in ("exact", "paired")}
    per_tier = {tier: v for tier, (v, _) in main_runs.items()}
    phase_sphere()
    segment_runs = []
    for run in RAYBEAM_RUNS:
        kind, launches, r = phase_raybeam(*run)
        segment_runs.append((run, kind, launches,
                             phase_segment_shapes(r, *run)))
        del r
    phase_slot_kernel()
    march_shapes = phase_march()
    walk_shapes = phase_walk()
    march_launches = {}
    slot_runs = []
    for run in UNCACHED_RUNS:
        key, launches, build_marches, r = phase_uncached(*run)
        march_launches.setdefault("slots_build", build_marches)
        slot_runs.append((run, key, launches, phase_slot_shapes(r, *run)))
        del r
    march_launches["drag"], drag_walks = phase_drag()
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
    phase_asset()
    option_runs = phase_options()
    phase_density()
    phase_aux()
    mesh_entries = phase_mesh()
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
    for name, key, launches, v in option_runs:
        route_file = {"lanes": "gather_lanes.cu",
                      "discrete": "gather_segments.cu"}.get(key,
                                                            "gather_vpu.cu")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"volumerenderer_tpu_torch/csrc/{route_file}",
            replaces=REPLACES[key], launches=launches, library_ms=None, **v))
    for name, launches in march_launches.items():
        kernels.append(dict(
            name=f"march_planes[{name}]", route="cuda",
            source="volumerenderer_tpu_torch/csrc/march_planes.cu",
            replaces=None, launches=launches, **march_shapes[name]))
    for name, v in walk_shapes.items():
        launches, run = (
            (drag_walks, "coarse drag frames") if v["step"] != 1.0
            else (main_runs["exact"][1], "main exact, converging ticks"))
        kernels.append(dict(
            name=f"photon_walk[{name}]", route="cuda",
            source="volumerenderer_tpu_torch/csrc/photon_walk.cu",
            replaces=None, launches=launches, launches_run=run, **v))
    kernels.extend(mesh_entries)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
