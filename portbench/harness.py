"""One run of one cell: make the inputs from the seed, load them through the
program's user path, warm up the cell's own shapes, drive the traffic for
the window, read the trace (``--trace 1``), free the program, and check its
frames against the reference.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (via the configuration's ``file``),
``traffic/<traffic>.json`` and the driver its ``kind`` names,
``drivers/<kind>.py``, ``limits/<cell>.json`` and ``metrics/<metric>.py``.

A metric module defines ``read(ctx)``, which returns the metric or None
where the run has nothing for it to read.  ``ctx`` holds ``summary`` (the
trace reduced, ``devtrace.Summary``), ``events`` (every traced event of the
window, ``devtrace.Event``, for spans and single kernels), ``window``
(its start and end on the trace's clock), ``frames`` (the window's
frames), ``kind`` and ``algorithm`` (the traffic's), ``inputs``,
``camera``, ``frame_counts`` (the window's frame counters), ``device`` and
``cache`` (shared by the readers of one run).  A module that reads CPU
operators or the program's own spans sets ``ACTIVITIES = ("cpu",)``."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import random
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import check
import drive
import devtrace as trace_mod
import volumes

HERE = Path(__file__).resolve().parent

# Run parameters that come from the configuration's file, keyed as the
# program's RenderParams (``params``) and StaticConfig (``static``) take them.
SCALARS = ("fov", "photon_initial_intensity", "scattering_probability",
           "absorption_coefficient", "ray_max_distance",
           "ray_marching_step_size", "beam_radius", "light_ray_step_size")


def root() -> Path:
    return Path.cwd()


def load_spec() -> dict:
    return json.loads((root() / "BENCHMARK.json").read_text())


def _named(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(spec: dict, cell: str):
    """(workload, configuration file, traffic mix, limits) of a cell."""
    w = _named(spec["workloads"], cell, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    config = json.loads((root() / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    return w, config, traffic, limits


def override(config: dict, overrides) -> dict:
    """``config`` with ``overrides`` merged in, one level deep (a test's
    smaller image and volume)."""
    for k, v in (overrides or {}).items():
        config[k] = ({**config[k], **v} if isinstance(v, dict) else v)
    return config


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str, cell_e2e) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in cell_e2e


def f32(x) -> float:
    return float(np.float32(x))


def make_inputs(config: dict, seed: int, device) -> dict:
    """The volume array and every parameter, as the program and the
    reference both get them."""
    vspec = config["volume"]
    values = volumes.generate(vspec, seed, device)
    if "world_extent" in vspec:
        voxel = float(vspec["world_extent"]) / int(vspec["n"])
        translation = (np.asarray(vspec["center"], np.float64)
                       - float(vspec["world_extent"]) / 2.0)
        bbox_min = (0, 0, 0)
    else:
        voxel = float(vspec["voxel_size"])
        translation = np.asarray(vspec["translation"], np.float64)
        bbox_min = tuple(vspec["bbox_min"])
    p = dict(config["params"])
    params = {k: f32(p[k]) for k in SCALARS}
    params.update(max_lights=int(p["max_lights"]),
                  camera_pos=np.float32(p["camera_pos"]),
                  light_source_world_pos=np.float32(
                      p["light_source_world_pos"]))
    inputs = dict(config["static"], params=params,
                  width=int(config["width"]), height=int(config["height"]),
                  volume=dict(values=values, bbox_min=bbox_min,
                              voxel_size=voxel, translation=translation,
                              active=vspec.get("file") is not None))
    return inputs


def volume_file(vspec: dict, seed: int, values) -> Path:
    """The volume written once per seed and checkout as the file a user
    would load (``build/portbench/``, keyed by the generator's parameters
    and the seed)."""
    import volumerenderer_tpu_torch as vt

    key = hashlib.sha256(json.dumps([vspec, int(seed)], sort_keys=True)
                         .encode()).hexdigest()[:16]
    out = root() / "build" / "portbench" / f"{vspec['generator']}-{key}.vdb"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        arr = values.cpu().numpy() if torch.is_tensor(values) else values
        g = vt.grid.from_dense(arr, bbox_min=vspec["bbox_min"],
                               voxel_size=float(vspec["voxel_size"]),
                               translation=vspec["translation"], device="cpu")
        tmp = out.with_suffix(".tmp.vdb")
        vt.grid.save_vdb(g, str(tmp), compression=vspec["file"])
        tmp.replace(out)
    return out


def load_grid(inputs, vspec, path, device):
    """The program's user path from the generated volume to its grid."""
    import volumerenderer_tpu_torch as vt

    if path is not None:
        return vt.grid.load(str(path), device=device)
    v = inputs["volume"]
    arr = v["values"]
    arr = arr.cpu().numpy() if torch.is_tensor(arr) else arr
    return vt.grid.from_dense(arr, bbox_min=v["bbox_min"],
                              voxel_size=v["voxel_size"],
                              translation=v["translation"], device=device)


def make_renderer(grid, inputs, config, traffic, device):
    import volumerenderer_tpu_torch as vt

    p = inputs["params"]
    params = vt.RenderParams.default().replace(**p)
    static = vt.StaticConfig(width=inputs["width"], height=inputs["height"],
                             **{k: v for k, v in config["static"].items()},
                             **traffic.get("config", {}))
    r = vt.Renderer(grid, static, params,
                    algorithm=vt.Algorithm[traffic["algorithm"]],
                    device=device)
    for k, v in traffic.get("renderer", {}).items():
        setattr(r, k, v)
    return r


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - reported, never fatal
        return f"unknown ({type(e).__name__})"


def _start_trace(cuda: bool, wanted: set):
    """A started profiler over the window: CUDA activity, and CPU operators
    where a metric asks for them (or on the CPU, where nothing else is
    recorded); then the opening marker of the window."""
    import warnings
    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message=".*Profiler clears")
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if "cpu" in wanted or not cuda else [])
    prof = profile(activities=acts)
    prof.start()
    ann = torch.profiler.record_function(trace_mod.WINDOW)
    ann.__enter__()
    if cuda:
        torch.cuda.synchronize()  # the window's opening marker
    return prof, ann


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", t_start: float | None = None,
             overrides: dict | None = None, log=print) -> tuple:
    """Returns (result dict, checks dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec()
    _, config, traffic, limits = cell_files(spec, cell)
    config = override(config, overrides)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # 1. The benchmark's own data: not the user's cost.
    t = time.perf_counter()
    inputs = make_inputs(config, seed, device)
    vspec = config["volume"]
    path = (volume_file(vspec, seed, inputs["volume"]["values"])
            if vspec.get("file") else None)
    vals = inputs["volume"]["values"]
    inputs["volume"]["values"] = (vals.cpu() if torch.is_tensor(vals)
                                  else torch.as_tensor(vals))
    del vals
    sync()
    data_s = time.perf_counter() - t
    log(f"portbench: data {data_s:.3f} s (not in setup_s)")

    # 2. The program, loaded and warmed up through its user path.
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv = drive.driver(traffic["kind"])
    build = getattr(drv, "make_renderer", make_renderer)
    opened = []

    def open_session():
        grid = load_grid(inputs, vspec, path, device)
        opened.append(drive.Session(build(grid, inputs, config, traffic,
                                          device)))
        return opened[-1]

    e2e_names = [m["name"] for m in spec["end_to_end"]
                 if cell in m.get("workloads", [cell])]
    readers = []
    if traced:
        readers = [(m, load_metric(m["name"])) for m in spec["per_layer"]
                   if reports(m, cell, e2e_names)]
    state = SimpleNamespace(prof=None, ann=None, t_window=None)

    def on_window():
        sync()
        if traced:
            state.prof, state.ann = _start_trace(
                cuda, {a for _, mod in readers
                       for a in getattr(mod, "ACTIVITIES", ())})
        state.t_window = time.perf_counter()

    out = drv.drive(open_session, traffic, seconds, random.Random(int(seed)),
                    drive.default_clock, on_window)
    sync()
    setup_s = state.t_window - t_start - data_s
    events = summary = None
    if traced:
        state.ann.__exit__(None, None, None)
        state.prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=1, memory_peak_bytes=int(peak))
    if traced:
        import volumerenderer_tpu_torch as vt
        names = trace_mod.program_kernels(Path(vt.__file__).parent)
        events = trace_mod.events_of(state.prof)
        state.prof = None
        summary = trace_mod.summarize(events, names)
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        log(f"portbench: traced window {summary.window_s:.3f} s, "
            f"{out['window_s'] * 1e3 / out['frames']:.4f} ms a frame")

    for sess in opened:
        sess.r = None
    del opened
    if cuda:
        torch.cuda.empty_cache()

    # 3. Metrics.
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    if not traced:
        values = dict(out["metrics"], setup_s=setup_s)
        for name in e2e_names:
            metrics[name] = {"value": values[name], "unit": units[name]}
    else:
        w0, w1 = trace_mod.window(events)
        ctx = SimpleNamespace(
            summary=summary, window=(w0, w1),
            events=[e for e in events if e.end > w0 and e.start < w1],
            frames=out["frames"], kind=traffic["kind"],
            algorithm=traffic["algorithm"], inputs=inputs,
            camera=inputs["params"]["camera_pos"],
            frame_counts=out["window_frames"], device=device, cache={})
        del events
        for m, mod in readers:
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        del ctx

    # 4. The check, after the window, with the program freed.
    got = check.compare(out["samples"], inputs, traffic["algorithm"], device,
                        log=log)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    correct = bool(checks) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    result = dict(correct=correct, attempted=int(out["frames"]), failed=0,
                  metrics=metrics, device=device_info)
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary.device_ops,
                                   idle_gaps=summary.idle_gaps)
    result["checks"] = checks
    ticks = np.asarray(out.get("tick_ms", []))
    if len(ticks) >= 2:
        q = np.percentile(ticks, [10, 50, 90, 100])
        half = len(ticks) // 2
        log(f"portbench: tick ms p10 {q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f}"
            f" max {q[3]:.3f}; mean of the first half "
            f"{ticks[:half].mean():.3f}, of the second {ticks[half:].mean():.3f}")
    log(f"portbench: cell {cell} seed {seed} setup_s {setup_s:.4f} "
        f"window {out['window_s']:.3f} s frames {out['frames']} "
        f"{json.dumps(out.get('counts', {}))}")
    return result, checks
