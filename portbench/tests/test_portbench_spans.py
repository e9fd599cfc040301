"""The readers of the program's spans and counts (``spans.py`` and the
``program_span`` / ``program_counter`` metrics) on synthetic spans and
events with known answers; their silence where the program has no
recorder; and, on the card, a span and the traced runtime call inside it
on one time axis."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import pbcases  # noqa: F401  (puts the harness on the path)
import harness
import spans
from devtrace import MARKER, Event
from volumerenderer_tpu_torch.utils import profiling

MS = 1e-3
NS = 1_000_000  # a millisecond in nanoseconds
T0 = 1_700_000_000  # seconds: a Unix-epoch time, as the trace gives


def _span(name, a_ms, b_ms, sid, parent=0, tick=None):
    return profiling.Span(name, (T0 * 1000 + a_ms) * NS,
                          (T0 * 1000 + b_ms) * NS, sid, parent,
                          tick if tick is not None else (parent or sid))


def _count(site, t_ms, n=1, kind="sync"):
    return profiling.Count(kind, site, n, (T0 * 1000 + t_ms) * NS, 1)


def _drained():
    """A window of 100 ms (from T0 + 0 to T0 + 100 ms) holding:

      session.step  0-90    (root, id 1)
        photon.walk 10-50   (id 2)
        color.build 60-80   (id 3)
          color.march 65-70 (id 4)
      path.replay  -20-20   (straddles the window's start, id 5)
        path.compact 5-15   (id 6)
      photon.walk  95-120   (straddles its end, id 7)

    and counts at the walk (3 inside, one before the window)."""
    return dict(
        spans=[_span("photon.walk", 10, 50, 2, 1, 1),
               _span("color.march", 65, 70, 4, 3, 1),
               _span("color.build", 60, 80, 3, 1, 1),
               _span("session.step", 0, 90, 1),
               _span("path.compact", 5, 15, 6, 5, 5),
               _span("path.replay", -20, 20, 5),
               _span("photon.walk", 95, 120, 7)],
        counts=[_count("photon.walk", -5), _count("photon.walk", 12),
                _count("photon.walk", 30, 2), _count("color.build", 61)],
        peak=11, dropped=0)


def _events():
    return [
        Event(MARKER, T0 - 1 * MS, T0, False),
        Event(MARKER, T0 + 99 * MS, T0 + 100 * MS, False),
        # Device busy 0-20, 40-70, 85-100: idle 20-40, 70-85.
        Event("kernel_a", T0, T0 + 20 * MS, True),
        Event("kernel_b", T0 + 40 * MS, T0 + 70 * MS, True),
        Event("Memcpy DtoH", T0 + 85 * MS, T0 + 110 * MS, True),
        Event("cudaLaunchKernel", T0 + 30 * MS, T0 + 31 * MS, False),
    ]


def _ctx(kind="converge", algorithm="POINT", frames=4):
    ctx = SimpleNamespace(window=(T0, T0 + 100 * MS), events=_events(),
                          frames=frames, kind=kind, algorithm=algorithm,
                          cache={})
    ctx.cache["spans"] = spans.window_of(_drained(), *ctx.window)
    return ctx


def test_window_keeps_and_clips_what_falls_inside():
    w = _ctx().cache["spans"]
    assert w.start == T0 and w.end == pytest.approx(T0 + 0.1)
    got = {s.id: (s.start - T0, s.end - T0) for s in w.spans}
    assert set(got) == {1, 2, 3, 4, 5, 6, 7}
    assert got[5] == pytest.approx((0.0, 0.020), abs=1e-6)  # clipped
    assert got[7] == pytest.approx((0.095, 0.100), abs=1e-6)
    assert w.count("sync", "photon.walk") == 3  # the one before left out
    assert w.count("sync") == 4
    assert w.peak == 11


def test_host_and_self_time():
    w = _ctx().cache["spans"]
    assert w.host_s("photon.walk") == pytest.approx(0.045, abs=1e-6)
    assert w.host_s("session.step") == pytest.approx(0.090, abs=1e-6)
    # session.step's own time: 90 ms less its children's 40 + 20.
    assert w.self_s("session.step") == pytest.approx(0.030, abs=1e-6)
    # color.build less the march nested in it.
    assert w.self_s("color.build") == pytest.approx(0.015, abs=1e-6)
    # path.replay, clipped to 20 ms, less path.compact's 10.
    assert w.self_s("path.replay") == pytest.approx(0.010, abs=1e-6)


def test_idle_inside_spans():
    ctx = _ctx()
    w = ctx.cache["spans"]
    idle = w.idle(ctx.events)
    assert (idle - T0).ravel().tolist() == pytest.approx(
        [0.020, 0.040, 0.070, 0.085], abs=1e-6)
    # Idle 20-40 lies in the walk (10-50); 70-85 in session.step (to 90).
    assert w.idle_inside_s(ctx.events, "photon.walk") == pytest.approx(
        0.020, abs=1e-6)
    assert w.idle_inside_s(ctx.events, "color.build") == pytest.approx(
        0.010, abs=1e-6)
    assert w.idle_inside_s(ctx.events) == pytest.approx(0.035, abs=1e-6)
    # Of session.step's idle (20-40, 70-85), the walk holds 20-40 and the
    # build 70-80: its own share is 80-85.
    assert w.idle_self_s(ctx.events, "session.step") == pytest.approx(
        0.005, abs=1e-6)


def read(name, ctx):
    return harness.load_metric(name).read(ctx)


def ms(v):
    """A reading in ms, to the microsecond: seconds since 1970 in float64
    resolve about 0.24 us."""
    return pytest.approx(v, abs=1e-3)


def test_frame_readers():
    ctx = _ctx(frames=4)
    assert read("walk_ms_per_frame.frame", ctx) == ms(45 / 4)
    assert read("walk_idle_ms_per_frame.frame", ctx) == ms(5.0)
    assert read("walk_syncs_per_frame.frame", ctx) == ms(0.75)
    for other in ("march_ms_per_frame.drag", "settle_build_ms.drag",
                  "path_replay_ms_per_frame.path"):
        assert read(other, ctx) is None


def test_drag_readers():
    ctx = _ctx(kind="drag", algorithm="RAY", frames=5)
    assert read("march_ms_per_frame.drag", ctx) == ms(1.0)
    # No merge in the window: no settle to divide by.
    assert read("settle_build_ms.drag", ctx) is None
    w = ctx.cache["spans"]
    w.spans.append(spans.Span("color.merge", T0 + 0.080, T0 + 0.082, 8, 1,
                              1))
    assert read("settle_build_ms.drag", ctx) == ms(22.0)
    assert read("walk_ms_per_frame.frame", ctx) is None


def test_path_readers_take_self_time():
    ctx = _ctx(algorithm="PATH", frames=2)
    assert read("path_replay_ms_per_frame.path", ctx) == ms(5.0)
    assert read("path_compact_ms_per_frame.path", ctx) == ms(5.0)
    assert read("path_walk_ms_per_frame.path", ctx) == ms(0.0)
    assert read("walk_ms_per_frame.frame", ctx) is None


READERS = ("walk_ms_per_frame.frame", "walk_idle_ms_per_frame.frame",
           "walk_syncs_per_frame.frame", "march_ms_per_frame.drag",
           "settle_build_ms.drag", "path_replay_ms_per_frame.path",
           "path_compact_ms_per_frame.path", "path_walk_ms_per_frame.path")


@pytest.mark.parametrize("name", READERS)
def test_silent_without_the_recorder(name, monkeypatch):
    """A program with no recorder (the tree before it): every reader
    returns None, whatever the cell."""
    monkeypatch.setattr(spans, "program", None)
    for kind, algorithm in (("converge", "POINT"), ("converge", "PATH"),
                            ("drag", "RAY")):
        ctx = SimpleNamespace(window=(T0, T0 + 0.1), events=_events(),
                              frames=4, kind=kind, algorithm=algorithm,
                              cache={})
        assert read(name, ctx) is None


def test_importing_the_helper_turns_the_recorder_on():
    assert spans.program is profiling and profiling.RECORDER.on


def test_of_drains_the_recorder_once():
    profiling.drain()
    with profiling.span("session.step"):
        profiling.count("sync", "photon.walk")
    sp = profiling.RECORDER.buffer[-1]  # the span closes after its count
    ctx = SimpleNamespace(
        window=(sp.start_ns * 1e-9 - 1, sp.end_ns * 1e-9 + 1), cache={})
    w = spans.of(ctx)
    assert [s.name for s in w.spans] == ["session.step"]
    assert w.count("sync", "photon.walk") == 1
    assert spans.of(ctx) is w and not profiling.RECORDER.buffer


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_span_holds_its_runtime_call_on_the_cards_trace(card):
    """Under a CUDA-only profiler, as the benchmark traces, a span around
    ``torch.cuda.synchronize()`` holds the traced ``cudaDeviceSynchronize``
    (to the clocks' 5 us), and lies within 50 us of it at either end (the
    median of ten; a busy host may stretch one): the spans' clock is the
    trace's.  The calls follow each other ~70 us apart, so a span that
    holds its own call holds no other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import devtrace

    n = 11
    x = torch.ones(1 << 20, device="cuda")
    profiling.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            y = x * 2.0
            with profiling.span("sync.probe"):
                torch.cuda.synchronize()
    del y
    got = [s for s in profiling.drain()["spans"] if s.name == "sync.probe"]
    calls = [e for e in devtrace.events_of(prof)
             if e.name == "cudaDeviceSynchronize" and not e.device]
    assert len(got) == n
    gaps = []
    for i, s in enumerate(got):
        a, b = s.start_ns * 1e-9, s.end_ns * 1e-9
        inside = [e for e in calls
                  if a - 5e-6 <= e.start and e.end <= b + 5e-6]
        assert len(inside) == 1, (i, a, b, [(e.start, e.end) for e in calls])
        e = inside[0]
        if i:  # the first call warms the profiler and the runtime up
            gaps.append(max(e.start - a, b - e.end))
    assert sorted(gaps)[len(gaps) // 2] < 50e-6, gaps
