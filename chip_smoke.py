#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (volumerenderer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits nonzero:

  1. device    the card's name, power limit and compute capability;
  2. build     nvcc builds csrc/gather_lanes.cu from this checkout;
  3. kernel    the gather kernel against its plain PyTorch version at
               synthetic shapes (Cp 144, Rc 524288, L in {1, 37, 1000},
               point/sphere, exact/paired, plus edge cases);
  4. main      the bench config (1920x1080 cloud(n=96), Point/VPL,
               camera (0, 20, -75), light (0, 20, 20)) through
               Renderer(..., device=DEV) in both gather tiers: step(8)
               warm-up, then step(32) timed; kernel launches counted;
  5. shapes    the kernel against its plain version on the live view's
               bands and one frame's lights;
  6. sphere    a few Sphere/VSL frames at the bench config;
  7. goldens   the golden scene (64x64 cloud(n=48)) for Point and Sphere
               against tests/goldens at windowed SSIM >= 0.995 and max abs
               error < 5e-3.

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

    t0 = time.perf_counter()
    _build.library("gather_lanes")
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_logs["gather_lanes"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="gather_lanes", seconds=dt, ptxas=ptxas)


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


def bench_renderer(tier: str, algorithm):
    import volumerenderer_tpu_torch as vt

    grid = vt.grid.procedural.cloud(n=96, device=DEV)
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 20.0, -75.0), light_source_world_pos=(0.0, 20.0, 20.0))
    config = vt.StaticConfig(width=BENCH_W, height=BENCH_H, gather_eval=tier)
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


def phase_goldens():
    import numpy as np

    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.utils.ssim import ssim

    for algo in (vt.Algorithm.POINT, vt.Algorithm.SPHERE):
        g = vt.grid.procedural.cloud(n=48, seed=7, center_world=(0.0, 20.0, 20.0),
                                     world_extent=70.0, device=DEV)
        params = vt.RenderParams.default().replace(
            light_source_world_pos=(0.0, 20.0, 20.0),
            scattering_probability=0.15)
        config = vt.StaticConfig(width=64, height=64, probe_tile=4096,
                                 build_tile=4096, max_events_per_photon=32,
                                 light_capacity=512)
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
    per_tier = {tier: phase_main(tier) for tier in ("exact", "paired")}
    phase_sphere()
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
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
