"""Tracing and frame statistics (twin of volumerenderer_tpu.utils.
profiling): ``torch.profiler`` traces, an FPS counter and the device
memory statistics; and the port's own spans and counters.

Spans and counters (the port's one facility for them):

  * ``span(name)``: a context manager around a stage of the program.  A
    span records its name, start, end, its parent (the span open around
    it) and its tick: the id of the outermost span open around it, so that
    every span under one ``Renderer.step`` or ``Renderer.image`` call
    (``session.step``, ``session.image``) shares that call's id.
    ``spanned(name)`` makes a function's calls spans.
  * ``count(kind, site, n=1)``: ``n`` events of ``kind`` at a named site;
    kind ``"sync"`` is a place where the host waits for the card (a read
    of a device value, or a copy from pageable host memory, which drains
    the stream).  ``Renderer.host_syncs`` is fed by it.

Counts are always kept: one dictionary add a call (``totals``,
``total``).  Spans, and a timestamped copy of each count, are kept only
while recording is on (``record(True)``; off by default), in a bounded
buffer that ``drain()`` hands over; nothing is written while the program
runs.  Off, ``span`` returns one shared no-op context: no clock read, no
allocation, no ``record_function``.  On, a span also opens
``torch.profiler.record_function(name)``, so a trace with CPU activity
(``trace``) shows the same spans.

Timestamps are ``time.time_ns()``: the Unix-epoch nanoseconds on which
``torch.profiler``'s events are given (``kineto_results.events()``,
``start_ns``), so spans and traced device events share one time axis.
One recorder serves the process and assumes one rendering thread."""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace into
    ``log_dir`` (``trace-<pid>-<ns>.json``; open it in Perfetto or
    chrome://tracing).  Yields the profiler, whose ``trace_path`` is set
    when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


@dataclass
class FrameStats:
    """Rolling frame statistics: the FPS counter the reference never had."""

    window: int = 32
    _times: list = field(default_factory=list)
    _last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def fps(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def mrays_per_sec(self, width: int, height: int) -> float:
        return self.fps * width * height / 1e6


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` per CUDA device ("cuda:0", ...); on a
    host without CUDA, ``{"cpu": None}`` (no statistics, as the reference
    package reports for a backend without them)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


# ---- spans and counters ----


@dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # the enclosing span's id; 0 at the root
    tick: int  # the root span's id


@dataclass(slots=True)
class Count:
    kind: str
    site: str
    n: int
    t_ns: int
    tick: int  # the tick of the innermost open span; 0 outside every span


class Recorder:
    """Counts by (kind, site), always; spans and timestamped counts while
    ``on``, in a buffer of at most ``capacity`` entries (the oldest go
    first, counted in ``dropped``)."""

    def __init__(self, capacity: int = 1 << 20):
        self.on = False
        self.totals: dict = {}
        self.buffer = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.peak = 0  # the most entries the buffer held since the last drain
        self.open: list = []  # the spans open now, outermost first
        self._ids = itertools.count(1)

    def put(self, entry) -> None:
        if len(self.buffer) == self.buffer.maxlen:
            self.dropped += 1
        self.buffer.append(entry)
        self.peak = max(self.peak, len(self.buffer))


RECORDER = Recorder()


class _Open:
    """The context of one recorded span."""

    __slots__ = ("name", "span", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        rec = RECORDER
        up = rec.open[-1] if rec.open else None
        sid = next(rec._ids)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        # The clock is read inside the record_function, so that its own
        # cost under a profiler stays outside the span.
        self.span = Span(self.name, time.time_ns(), 0, sid,
                         up.id if up else 0, up.tick if up else sid)
        rec.open.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.time_ns()
        RECORDER.open.pop()
        RECORDER.put(s)
        self.fn.__exit__(*exc)
        return False


_NOOP = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` around the ``with`` block (the shared no-op
    while recording is off)."""
    return _Open(name) if RECORDER.on else _NOOP


def spanned(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(kind: str, site: str, n: int = 1) -> None:
    """Count ``n`` events of ``kind`` (``"sync"``: the host waits for the
    card) at ``site``."""
    rec = RECORDER
    key = (kind, site)
    rec.totals[key] = rec.totals.get(key, 0) + n
    if rec.on:
        tick = rec.open[-1].tick if rec.open else 0
        rec.put(Count(kind, site, n, time.time_ns(), tick))


def totals() -> dict:
    """{(kind, site): count} since the process started."""
    return dict(RECORDER.totals)


def total(kind: str) -> int:
    """The count of ``kind`` over every site."""
    return sum(n for (k, _), n in RECORDER.totals.items() if k == kind)


def record(on: bool) -> None:
    """Turn the recording of spans and timestamped counts on or off."""
    RECORDER.on = bool(on)


def drain() -> dict:
    """Hand over the buffer and empty it: ``spans`` (closed ``Span``s),
    ``counts`` (``Count``s), ``peak`` (the most entries it held since the
    last drain) and ``dropped`` (entries the bound pushed out)."""
    rec = RECORDER
    entries = list(rec.buffer)
    out = dict(spans=[e for e in entries if isinstance(e, Span)],
               counts=[e for e in entries if isinstance(e, Count)],
               peak=rec.peak, dropped=rec.dropped)
    rec.buffer.clear()
    rec.peak = rec.dropped = 0
    return out
