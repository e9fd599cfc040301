"""The traced run's reading of ``torch.profiler`` over the window, reduced to
what the per-layer metrics read.

The trace records CUDA activity (device operations and the runtime calls
that launch and wait for them); CPU operators only where a metric of the
cell asks for them (``ACTIVITIES = ("cpu",)`` in its module), since
recording each operator slows a host-bound frame by half or more, and the
idle share would read that slowdown.

  * the window: from the end of the harness's opening synchronization
    (``MARKER``, the first in the trace) to the end of its closing one (the
    last); or, where CPU operators are recorded and the CUDA runtime is
    not (a run on the CPU), the span of the annotation ``WINDOW``;
  * device operations: every event on the card (kernels, copies, sets);
    busy time is the union of their intervals inside the window;
  * kernels: device operations that are not copies or sets;
  * host syncs: the runtime calls that wait for the card
    (``SYNC_CALLS``);
  * the program's own kernels: those whose name holds a ``__global__``
    function of the port's ``csrc/`` sources.

``Summary`` holds plain numbers, so that the metric readers and the tests
work without a profiler."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

WINDOW = "portbench.window"
MARKER = "cudaDeviceSynchronize"
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D",
})
_COPY = ("Memcpy", "Memset")


@dataclass(slots=True)
class Event:
    name: str
    start: float  # seconds, on the trace's clock
    end: float
    device: bool


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    syncs: int
    program_kernel_s: float
    device_s: dict = field(default_factory=dict)  # short name -> seconds
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds]]


def program_kernels(package_dir) -> list:
    """Names of the ``__global__`` functions in ``<package>/csrc``."""
    names = set()
    for p in sorted(Path(package_dir, "csrc").glob("*.cu*")):
        text = p.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s*)?(\w+)\s*\(", text):
            names.add(m.group(1))
    return sorted(names)


def events_of(prof) -> list:
    """The profiler's events as ``Event``s (seconds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        if e.is_user_annotation() and dev:
            continue  # the annotation's shadow on the device timeline
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), start, start + e.duration_ns() * 1e-9,
                         dev))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters; a copy's or a set's kind (``Memcpy DtoH``)."""
    if name.startswith(_COPY):
        return name.split(" (")[0]
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0].strip()
    return base.split(" ")[-1] if base else name


def _union(iv: np.ndarray) -> np.ndarray:
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def window(events: list) -> tuple:
    """(start, end) of the traced window on the trace's clock."""
    marks = sorted((e for e in events if e.name == MARKER and not e.device),
                   key=lambda e: e.start)
    if len(marks) >= 2:
        return marks[0].end, marks[-1].end
    win = [e for e in events if e.name == WINDOW and not e.device]
    if not win:
        raise RuntimeError(f"trace: no {MARKER!r} pair and no {WINDOW!r} "
                           f"annotation")
    return win[0].start, win[0].end


def summarize(events: list, kernel_names, top: int = 10,
              attribute: int = 200) -> Summary:
    w0, w1 = window(events)
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
    iv = np.asarray([[max(e.start, w0), min(e.end, w1)] for e in dev],
                    np.float64).reshape(-1, 2)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0
    kernels = [e for e in dev if not e.name.startswith(_COPY)]
    per_op: dict = {}
    for e in dev:
        k = short_name(e.name)
        per_op[k] = per_op.get(k, 0.0) + (min(e.end, w1) - max(e.start, w0))
    prog = tuple(kernel_names)
    prog_s = sum(min(e.end, w1) - max(e.start, w0) for e in kernels
                 if any(k in e.name for k in prog))
    host = [e for e in events if not e.device and e.name != WINDOW
            and w0 <= e.start and e.end < w1]  # the markers left out
    syncs = sum(1 for e in host if e.name in SYNC_CALLS)
    return Summary(
        window_s=w1 - w0, busy_s=busy, kernels=len(kernels), syncs=syncs,
        program_kernel_s=prog_s, device_s=per_op,
        device_ops=sorted(([k, v] for k, v in per_op.items()),
                          key=lambda kv: -kv[1])[:top],
        idle_gaps=_idle_by_host_op(merged, w0, w1, host, top, attribute))


def _idle_by_host_op(merged, w0, w1, host, top, attribute):
    """The idle time of the longest ``attribute`` gaps, summed by the
    innermost host operation open at each gap's middle."""
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if not len(gaps) or not host:
        return []
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:attribute]
    starts = np.asarray([e.start for e in host])
    ends = np.asarray([e.end for e in host])
    by: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[open_[np.argmax(starts[open_])]].name if len(open_)
                else "(no host op)")
        by[name] = by.get(name, 0.0) + float(b - a)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]
