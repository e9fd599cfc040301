"""Where a benchmark cell's time goes, by the program's own spans and
counts (``volumerenderer_tpu_torch.utils.profiling``), on one CUDA card.

    python3 scripts/port_span_report.py [--mode on|off|sites] \
        [--seconds S] [--seed N] <cell> [<cell> ...]

from the root of a checkout.  Each cell is run once through the
benchmark's harness (``portbench/harness.run_cell``) and printed as one
JSON line:

  * ``on``: a traced run (``--trace 1``) with the program's recorder on:
    its per-layer metrics, the traced frame time, the "sync" count per frame
    by site beside the trace's synchronizing runtime calls per frame, the
    share of the device-idle time that falls inside any span and inside each
    span name's own time (its spans less their child spans), host seconds
    by span name, the recorder buffer's peak entries, and the set-up's
    volume load split by its spans (``grid.load`` and its children: the
    file's read, the bricking, the upload), which end before the window;
  * ``off``: the same traced run with the recorder off (the program-span
    readers left out): the traced frame time, for the recorder's cost;
  * ``sites``: an untraced run whose window runs under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing call per
    frame by the program's source line that made it, beside the "sync"
    count per frame by site, to find a wait the counter misses."""

from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
import types
import warnings
from pathlib import Path

ROOT = Path.cwd()
PORT = "volumerenderer_tpu_torch"


def _site_of(stack) -> str:
    """The innermost frame in the program, and the outermost one."""
    mine = [f for f in stack if f"/{PORT}/" in f.filename]
    if not mine:
        return "(outside the program)"
    inner, outer = mine[-1], mine[0]
    name = lambda f: (f"{f.filename.split(f'/{PORT}/')[1]}:{f.lineno} "  # noqa
                      f"{f.name}")
    return name(inner) if inner is outer else f"{name(inner)} < {name(outer)}"


def _analyse(ctx, spans_mod) -> dict:
    s = ctx.summary
    out = dict(frames=ctx.frames, window_s=s.window_s,
               traced_frame_ms=s.window_s * 1e3 / ctx.frames,
               idle_s=s.window_s - s.busy_s,
               trace_syncs_per_frame=s.syncs / ctx.frames)
    if spans_mod is None:
        return out
    w = spans_mod.of(ctx)
    if w is None:
        return out
    sites = collections.Counter()
    for kind, site, n, _ in w.counts:
        if kind == "sync":
            sites[site] += n
    idle = out["idle_s"]
    names = sorted({sp.name for sp in w.spans})
    self_idle = {n: w.idle_self_s(ctx.events, n) for n in names}
    out.update(
        sync_per_frame=w.count("sync") / ctx.frames,
        sync_per_frame_by_site={k: v / ctx.frames for k, v in
                                sorted(sites.items(), key=lambda kv: -kv[1])},
        idle_share_in_spans=(w.idle_inside_s(ctx.events) / idle
                             if idle > 0 else None),
        idle_share_by_span_self={k: v / idle for k, v in sorted(
            self_idle.items(), key=lambda kv: -kv[1])} if idle > 0 else None,
        host_ms_per_frame_by_span={n: w.host_s(n) * 1e3 / ctx.frames
                                   for n in names},
        self_ms_per_frame_by_span={n: w.self_s(n) * 1e3 / ctx.frames
                                   for n in names},
        spans_in_window=len(w.spans), counts_in_window=len(w.counts),
        buffer_peak_entries=w.peak, buffer_dropped=w.dropped)
    return out


def _load_split(drained, w0: float) -> dict:
    """Host ms of the volume load's spans ("grid.load" and its children)
    that end before the window opens at ``w0`` (seconds on the trace's
    clock)."""
    out = collections.Counter()
    for s in drained["spans"]:
        if s.name.startswith("grid.load") and s.end_ns * 1e-9 <= w0:
            out[s.name] += (s.end_ns - s.start_ns) * 1e-6
    return dict(sorted(out.items()))


def run(cell: str, mode: str, seconds: float, seed: int) -> dict:
    import torch

    import harness

    spec = harness.load_spec()
    report = {}
    if mode == "off":
        spec["per_layer"] = [m for m in spec["per_layer"]
                             if not m["source"].startswith("program_")]
    spec["per_layer"].append(dict(name="_report", workloads=[cell],
                                  source="device_trace", moves="", unit=""))
    real_load = harness.load_metric

    def load_metric(name):
        if name != "_report":
            return real_load(name)
        spans_mod = sys.modules.get("spans")

        def read(ctx):
            report.update(_analyse(ctx, spans_mod))
            return None
        return types.SimpleNamespace(read=read)

    spans_mod = None
    if mode == "on":
        import spans as spans_mod  # turns the program's recorder on

        real_window_of = spans_mod.window_of

        def window_of(drained, w0, w1):
            report["setup_ms_by_span"] = _load_split(drained, w0)
            return real_window_of(drained, w0, w1)
        spans_mod.window_of = window_of
    real_driver = harness.drive.driver
    sites = collections.Counter()
    from volumerenderer_tpu_torch.utils import profiling

    def driver(kind):
        mod = real_driver(kind)
        if mode != "sites":
            return mod
        wrapped = types.SimpleNamespace(**vars(mod))

        def drive(open_session, traffic, seconds, rng, clock,
                  on_window=None):
            def hook(message, *args, **kwargs):
                if "synchroniz" in str(message):
                    sites[_site_of(traceback.extract_stack()[:-1])] += 1

            def window():
                on_window()
                report["sync_counts0"] = profiling.totals()
                warnings.simplefilter("always")
                warnings.showwarning = hook
                torch.cuda.set_sync_debug_mode("warn")

            out = mod.drive(open_session, traffic, seconds, rng, clock,
                            window)
            torch.cuda.set_sync_debug_mode(0)
            report["sync_counts1"] = profiling.totals()
            report["frames"] = out["frames"]
            return out
        wrapped.drive = drive
        return wrapped

    real_spec, real_show = harness.load_spec, warnings.showwarning
    harness.load_spec = lambda: spec
    harness.load_metric = load_metric
    harness.drive.driver = driver
    try:
        result, _ = harness.run_cell(cell, seed, seconds, mode != "sites",
                                     device="cuda", log=lambda s: None)
    finally:
        harness.load_spec, warnings.showwarning = real_spec, real_show
        harness.load_metric = real_load
        harness.drive.driver = real_driver
        if spans_mod is not None:
            spans_mod.window_of = real_window_of
    if mode == "sites":
        n = report.pop("frames")
        c0, c1 = report.pop("sync_counts0"), report.pop("sync_counts1")
        report.update(
            frames=n,
            waits_per_frame_by_line={k: v / n for k, v in sites.most_common()},
            waits_per_frame=sum(sites.values()) / n,
            sync_per_frame_by_site={
                site: (c1[(k, site)] - c0.get((k, site), 0)) / n
                for (k, site) in c1 if k == "sync"
                and c1[(k, site)] != c0.get((k, site), 0)})
    return dict(cell=cell, mode=mode, seed=seed, correct=result["correct"],
                metrics={k: v["value"] for k, v in result["metrics"].items()},
                **report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--mode", choices=("on", "off", "sites"), default="on")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2**31 + 4242)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "portbench"))
    sys.path.insert(0, str(ROOT))
    import torch

    import harness
    import run as run_mod

    run_mod.cache_env(ROOT)
    if not torch.cuda.is_available():
        print("port_span_report: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(dict(card=harness.power_limit())), flush=True)
    for cell in args.cells:
        print(json.dumps(run(cell, args.mode, args.seconds, args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
