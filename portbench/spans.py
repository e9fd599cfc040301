"""The program's own spans and counts over a traced run's window, for the
readers in ``metrics/`` whose ``per_layer`` entry has the source
``program_span`` or ``program_counter``.

Importing this module turns the program's recorder on
(``volumerenderer_tpu_torch.utils.profiling.record``).  The harness loads
the readers, and so this module, only in a ``--trace 1`` run, so the runs
behind the end-to-end metrics keep the recorder off.  The spans take no CPU
activity in the trace: a reader of them does not set ``ACTIVITIES``.

``of(ctx)`` hands the recorder's buffer over once a run (in ``ctx.cache``)
and keeps what falls inside ``ctx.window``, in seconds on the trace's
clock: the recorder stamps ``time.time_ns()``, the clock of the profiler's
events.  Where the program has no recorder (a tree before it), ``of``
returns None and so does every reader."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import devtrace

try:
    from volumerenderer_tpu_torch.utils import profiling as program
    program.record(True)
except (ImportError, AttributeError):
    program = None


@dataclass
class Span:
    name: str
    start: float  # seconds on the trace's clock, clipped to the window
    end: float
    id: int
    parent: int  # 0 at a root
    tick: int


@dataclass
class Window:
    start: float
    end: float
    spans: list = field(default_factory=list)
    counts: list = field(default_factory=list)  # (kind, site, n, t)
    peak: int = 0  # the most entries the recorder's buffer held
    dropped: int = 0  # entries its bound pushed out
    _idle: np.ndarray | None = None

    def host_s(self, name: str) -> float:
        """Host seconds inside spans named ``name``."""
        return sum(s.end - s.start for s in self.spans if s.name == name)

    def self_s(self, name: str) -> float:
        """Self time of the spans named ``name``: each one's time less the
        part its child spans cover."""
        mine = {s.id: s for s in self.spans if s.name == name}
        return (sum(s.end - s.start for s in mine.values())
                - _length(_covered(c for c in self.spans
                                   if c.parent in mine)))

    def count(self, kind: str, site: str | None = None) -> int:
        """Counts of ``kind`` (at ``site``, or at every site)."""
        return sum(n for k, st, n, _ in self.counts
                   if k == kind and (site is None or st == site))

    def idle(self, events) -> np.ndarray:
        """The window's device-idle intervals: the window less the union of
        the device events among ``events`` (the window's, computed once)."""
        if self._idle is not None:
            return self._idle
        busy = devtrace._union(np.asarray(
            [[max(e.start, self.start), min(e.end, self.end)]
             for e in events if e.device and e.end > self.start
             and e.start < self.end], np.float64).reshape(-1, 2))
        edges = np.concatenate([[self.start], busy.reshape(-1),
                                [self.end]]).reshape(-1, 2)
        self._idle = edges[edges[:, 1] > edges[:, 0]]
        return self._idle

    def idle_inside_s(self, events, name: str | None = None) -> float:
        """Device-idle seconds that fall inside spans named ``name`` (or
        inside any span)."""
        return _overlap(self.idle(events), _covered(
            s for s in self.spans if name is None or s.name == name))

    def idle_self_s(self, events, name: str) -> float:
        """Device-idle seconds inside spans named ``name`` and outside their
        child spans."""
        ids = {s.id for s in self.spans if s.name == name}
        return (self.idle_inside_s(events, name) - _overlap(
            self.idle(events),
            _covered(c for c in self.spans if c.parent in ids)))


def _covered(spans) -> np.ndarray:
    """The union of the spans' intervals, sorted and disjoint."""
    return devtrace._union(np.asarray([[s.start, s.end] for s in spans],
                                      np.float64).reshape(-1, 2))


def _length(iv) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def window_of(drained: dict, w0: float, w1: float) -> Window:
    """What ``profiling.drain()`` handed over, inside (w0, w1)."""
    win = Window(w0, w1, peak=drained["peak"], dropped=drained["dropped"])
    for s in drained["spans"]:
        a, b = s.start_ns * 1e-9, s.end_ns * 1e-9
        if b > w0 and a < w1:
            win.spans.append(Span(s.name, max(a, w0), min(b, w1), s.id,
                                  s.parent, s.tick))
    for c in drained["counts"]:
        t = c.t_ns * 1e-9
        if w0 <= t < w1:
            win.counts.append((c.kind, c.site, c.n, t))
    return win


def of(ctx) -> Window | None:
    """The window's spans and counts, or None without the recorder."""
    if program is None:
        return None
    if "spans" not in ctx.cache:
        ctx.cache["spans"] = window_of(program.drain(), *ctx.window)
    return ctx.cache["spans"]
