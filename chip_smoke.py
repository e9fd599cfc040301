#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volumerenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

  1. device    the card's name, power limit and compute capability;
  2. build     nvcc builds csrc/gather_lanes.cu and csrc/gather_segments.cu
               from this checkout, both at once; ptxas registers, spills and
               shared memory per kernel template;
  3. kernel    the point gather kernel against its plain PyTorch version at
               synthetic shapes (Cp 144, Rc 524288, L in {1, 37, 1000},
               point/sphere, exact/paired, plus edge cases);
  4. segkernel the two segment kernels against their plain versions at
               synthetic shapes (Cp 144, Rc 65536): discrete point/sphere x
               exact/paired and every analytic variant, with segments of
               ns = 0, zero length, ns % 4 != 0 and > 512 sub-lights, a
               range with start > 0 and an odd count, samples on a
               sub-light, at a Beam centre, inside a beam (q < r), and
               projecting outside [0, L];
  5. main      the bench config (1920x1080 cloud(n=96), Point/VPL,
               camera (0, 20, -75), light (0, 20, 20)) through
               Renderer(..., device=DEV) in both gather tiers: step(8)
               warm-up, then step(32) timed; kernel launches counted;
  6. shapes    the point kernel against its plain version on the live
               view's bands and one frame's lights;
  7. sphere    a few Sphere/VSL frames at the bench config;
  8. raybeam   the bench config for RAY discrete exact and paired, RAY
               analytic paired, BEAM discrete exact and BEAM analytic
               closed paired: step(8) warm-up, then step(16) timed; launches
               of each segment kernel per frame;
  9. segshapes each segment kernel against its plain version on 65,536
               lanes of the live widest band and one frame's segments;
 10. goldens   the golden scene (64x64 cloud(n=48)) for Point, Sphere, Ray
               and Beam against tests/goldens at windowed SSIM >= 0.995 and
               max abs error < 5e-3.

The lines before the last are the card's name and power limit as
nvidia-smi gives them and a JSON object of the kernels; the last line is
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
RTOL_EXACT = 2e-5  # FMA-free term order; only the summation order differs
RTOL_PAIRED = 3e-5  # paired tier against the exact plain version
TPU_CHECKSUM = 57344.9  # accum checksum of the bench config, paired tier, TPU run
BENCH_W, BENCH_H = 1920, 1080
PLAIN_ELEMS = 1 << 26  # (Cp, lanes, L) elements per chunk of the plain version
SYNTH_CP, SYNTH_RC = 144, 524288  # synthetic planes: the main path's cap, one band
SEG_RC = 65536  # lanes of the segment kernels' synthetic and live comparisons
# Segment kernels against their plain versions (exact against exact, paired
# against paired: the same terms, only the summation order differs).
RTOL_SEGMENT = 2e-5
RAYBEAM_RUNS = (  # (algorithm, segment_mode, segment_eval, quadrature rule)
    ("RAY", "discrete", "exact", "midpoint"),
    ("RAY", "discrete", "paired", "midpoint"),
    ("RAY", "analytic", "paired", "midpoint"),
    ("BEAM", "discrete", "exact", "midpoint"),
    ("BEAM", "analytic", "paired", "closed"),
)
DEV = "cuda"


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

    names = ("gather_lanes", "gather_segments")
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
    cases = [(L, 0, L) for L in (1, 37, 1000)]
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
                emit("kernel", L=L, start=s, count=c, sphere=sphere,
                     paired=paired, Cp=Cp, Rc=Rc, max_rel_err=err, tol=tol,
                     ms=ms, plain_exact_ms=plain_ms)
                if not err <= tol:
                    raise AssertionError(
                        f"kernel vs plain: rel err {err:.3g} > {tol:g} "
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


def run_segment_kernel(kind, planes, segs, need, step, kw, reps=3):
    """The kernel and its plain version on the same inputs: returns
    (max rel err, max abs err, kernel ms, plain ms)."""
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
    return rel_err(got, ref), float((got - ref).abs().max()), ms, plain_ms


def phase_segment_kernel():
    import torch

    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs

    dev = torch.device(DEV)
    planes, segs, need = segment_case(SYNTH_CP, SEG_RC, 7, dev)
    n0 = dict(gs.launches)
    for label, kind, kw in segment_variants():
        err, abs_err, ms, plain_ms = run_segment_kernel(
            kind, planes, segs, need, 0.3, kw)
        emit("segkernel", variant=label, Cp=SYNTH_CP, Rc=SEG_RC,
             segments=int(segs[3].sum()), max_rel_err=err, max_abs_err=abs_err,
             tol=RTOL_SEGMENT, ms=ms, plain_ms=plain_ms)
        if not err <= RTOL_SEGMENT:
            raise AssertionError(f"segment kernel {label} vs plain: rel err "
                                 f"{err:.3g} > {RTOL_SEGMENT:g}")
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
    emit("shapes", tier=tier, Cp=band.wx.shape[0], Rc=band.wx.shape[1],
         lights=int(count), max_rel_err=err, max_abs_err=abs_err, tol=tol,
         ms=ms, plain_ms=plain_ms)
    if not err <= tol:
        raise AssertionError(f"{tier}: kernel vs plain at the main "
                             f"path's shapes: rel err {err:.3g} > {tol:g}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)


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
    """The run's segment kernel against its plain version on SEG_RC lanes of
    the live widest band and the next frame's segments."""
    from volumerenderer_tpu_torch.ops.kernels import gather_segments as gs
    from volumerenderer_tpu_torch.render import photon

    band = max(r._view.bands, key=lambda b: b.wx.shape[0])
    lanes = slice(0, min(SEG_RC, band.wx.shape[1]))
    planes = [t[:, lanes].contiguous()
              for t in (band.wx, band.wy, band.wz, band.weight)]
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
    n0 = dict(gs.launches)
    err, abs_err, ms, plain_ms = run_segment_kernel(
        kind, planes, segs, need, r.params.light_ray_step_size, kw, reps=5)
    gs.launches.update(n0)  # comparison launches are not main-path launches
    emit("segshapes", algorithm=algo_name, mode=mode, tier=tier, Cp=planes[0].shape[0],
         Rc=planes[0].shape[1], segments=int(lights.count[0]),
         max_rel_err=err, max_abs_err=abs_err, tol=RTOL_SEGMENT, ms=ms,
         plain_ms=plain_ms)
    if not err <= RTOL_SEGMENT:
        raise AssertionError(f"{algo_name} {mode} {tier}: segment kernel vs "
                             f"plain at live shapes: rel err {err:.3g} > "
                             f"{RTOL_SEGMENT:g}")
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)


def phase_goldens():
    import numpy as np

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.utils.ssim import ssim

    for algo in (vt.Algorithm.POINT, vt.Algorithm.SPHERE, vt.Algorithm.RAY,
                 vt.Algorithm.BEAM):
        g = vt.grid.procedural.cloud(n=48, seed=7, center_world=(0.0, 20.0, 20.0),
                                     world_extent=70.0, device=DEV)
        params = vt.RenderParams.default().replace(
            light_source_world_pos=(0.0, 20.0, 20.0),
            scattering_probability=0.15)
        config = vt.StaticConfig(width=64, height=64, probe_tile=4096,
                                 build_tile=4096, max_events_per_photon=32,
                                 light_capacity=512, max_points_per_segment=128)
        r = vt.Renderer(g, config, params, algorithm=algo, device=DEV)
        r.step(2)
        img = r.state.accum.cpu().numpy()
        want = np.load(ROOT / "tests" / "goldens" / f"{algo.name.lower()}.npy")
        s, err = ssim(img, want), float(np.abs(img - want).max())
        emit("goldens", algorithm=algo.name, ssim=s, max_abs_err=err)
        if not (s >= 0.995 and err < 5e-3):
            raise AssertionError(f"{algo.name}: golden SSIM {s:.5f}, "
                                 f"max abs err {err:.2e}")


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
    phase_goldens()
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")

    kernels = [
        dict(name=f"gather_lanes[{tier}]", route="cuda",
             source="volumerenderer_tpu_torch/csrc/gather_lanes.cu",
             replaces="volumerenderer_tpu/ops/pallas/gather_lanes.py:63",
             **v)
        for tier, v in per_tier.items()
    ]
    replaces = {"discrete": "volumerenderer_tpu/ops/pallas/gather_lanes.py:156",
                "analytic": "volumerenderer_tpu/ops/pallas/gather_lanes.py:234"}
    for (algo_name, mode, tier, rule), kind, launches, v in segment_runs:
        if kind == "discrete":
            variant = algo_name.lower()
        else:
            variant = "vrl" if algo_name == "RAY" else f"vbl-{rule}"
        kernels.append(dict(
            name=f"gather_segments_{kind}[{variant},{tier}]", route="cuda",
            source="volumerenderer_tpu_torch/csrc/gather_segments.cu",
            replaces=replaces[kind], launches=launches, **v))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
