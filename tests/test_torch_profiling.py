"""The port's spans and counters (``utils.profiling``): off by default and
free of clock reads and buffers when off; nesting, parents and ticks when
on; timestamps on ``torch.profiler``'s clock; counts by site; the bounded
buffer; and the Renderer's spans and ``host_syncs`` fed by the counter.
This file imports no JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.utils import profiling


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder for the test, recording."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    profiling.record(True)
    return r


@pytest.fixture
def off(monkeypatch):
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


def test_off_by_default_and_free(off, monkeypatch):
    assert not profiling.Recorder().on
    reads = []
    monkeypatch.setattr(profiling.time, "time_ns",
                        lambda: reads.append(1) or 0)
    a, b = profiling.span("photon.walk"), profiling.span("color.build")
    assert a is b  # one shared no-op context
    with a:
        with b:
            profiling.count("sync", "photon.walk")
    assert not reads and not off.buffer and not off.open
    assert profiling.drain() == dict(spans=[], counts=[], peak=0, dropped=0)
    # The count itself is always kept.
    assert profiling.totals() == {("sync", "photon.walk"): 1}


def test_nesting_parents_and_ticks(rec):
    with profiling.span("session.step") as step:
        with profiling.span("photon.walk") as walk:
            profiling.count("sync", "photon.walk")
        with profiling.span("color.build") as build:
            with profiling.span("color.march") as march:
                pass
    with profiling.span("session.image") as image:
        pass
    got = profiling.drain()
    by = {s.name: s for s in got["spans"]}
    assert by["session.step"] is step and step.parent == 0
    assert walk.parent == build.parent == step.id
    assert march.parent == build.id
    assert {walk.tick, build.tick, march.tick, step.tick} == {step.id}
    assert image.tick == image.id != step.id
    for inner, outer in ((walk, step), (build, step), (march, build)):
        assert (outer.start_ns <= inner.start_ns <= inner.end_ns
                <= outer.end_ns)
    assert walk.end_ns <= build.start_ns
    (c,) = got["counts"]
    assert (c.kind, c.site, c.n, c.tick) == ("sync", "photon.walk", 1,
                                             step.id)
    assert walk.start_ns <= c.t_ns <= walk.end_ns
    assert not rec.open


def test_spans_on_the_profilers_clock(rec):
    """Under a CPU-activity profiler, a span around a ``record_function``
    block holds that event, to within 50 us at either end (the median of
    ten; a preempted worker may stretch one)."""
    n = 11
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(n):
            with profiling.span(f"outer{i}"):
                with record_function(f"inner{i}"):
                    torch.ones(256).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in profiling.drain()["spans"]}
    gaps = []
    for i in range(1, n):  # the first call warms the profiler up
        e, s = events[f"inner{i}"], spans[f"outer{i}"]
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s.start_ns <= a + 1000 and b <= s.end_ns + 1000
        gaps.append(max(a - s.start_ns, s.end_ns - b))
        # The span's own record_function shows in the same trace.
        outer = events[f"outer{i}"]
        assert outer.start_ns() <= a and b <= (outer.start_ns()
                                               + outer.duration_ns())
    assert sorted(gaps)[len(gaps) // 2] < 50_000, gaps


def test_counts_by_site(rec):
    profiling.count("sync", "photon.walk")
    profiling.count("sync", "photon.walk", 2)
    profiling.count("sync", "session.image")
    profiling.count("launch", "photon.walk", 5)
    assert profiling.totals() == {("sync", "photon.walk"): 3,
                                  ("sync", "session.image"): 1,
                                  ("launch", "photon.walk"): 5}
    assert profiling.total("sync") == 4 and profiling.total("launch") == 5
    got = profiling.drain()["counts"]
    assert [(c.site, c.n, c.tick) for c in got] == [
        ("photon.walk", 1, 0), ("photon.walk", 2, 0), ("session.image", 1, 0),
        ("photon.walk", 5, 0)]
    assert got == sorted(got, key=lambda c: c.t_ns)


def test_bounded_buffer_keeps_the_newest(monkeypatch):
    r = profiling.Recorder(capacity=4)
    monkeypatch.setattr(profiling, "RECORDER", r)
    profiling.record(True)
    for i in range(6):
        profiling.count("sync", f"site{i}")
    got = profiling.drain()
    assert [c.site for c in got["counts"]] == [f"site{i}" for i in (2, 3, 4,
                                                                    5)]
    assert got["peak"] == 4 and got["dropped"] == 2
    assert profiling.drain()["peak"] == 0  # handed over and emptied
    assert sum(profiling.totals().values()) == 6


def test_spanned_keeps_the_function(rec):
    @profiling.spanned("color.merge")
    def merge(a, b=1):
        """Doc."""
        return a + b

    assert merge(1, b=2) == 3 and merge.__doc__ == "Doc."
    (s,) = profiling.drain()["spans"]
    assert s.name == "color.merge"


def _scene():
    rs = np.random.RandomState(5)
    vals = ((rs.rand(16, 16, 16) < 0.5) * rs.rand(16, 16, 16)).astype(
        np.float32)
    g = vt.grid.from_dense(vals, voxel_size=1.0,
                           translation=(-8.0, -8.0, -8.0), device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -30.0), light_source_world_pos=(0.0, 0.0, 0.0))
    return g, params


@pytest.mark.parametrize("algorithm", ["POINT", "PATH"])
def test_renderer_spans_and_host_syncs(rec, algorithm):
    """Every span of a step shares the step's tick; ``host_syncs`` is the
    "sync" count of the session's calls, ``image()`` included."""
    g, params = _scene()
    r = vt.Renderer(g, vt.StaticConfig(width=24, height=16), params,
                    algorithm=vt.Algorithm[algorithm])
    r.step(2)
    r.image()
    got = profiling.drain()
    roots = [s for s in got["spans"] if s.parent == 0]
    assert [s.name for s in roots] == ["session.step", "session.image"]
    step, image = roots
    stage = "photon.walk" if algorithm == "POINT" else "path.replay"
    assert any(s.name == stage for s in got["spans"])
    assert {s.tick for s in got["spans"] if s is not image} == {step.id}
    assert r.host_syncs == profiling.total("sync") == sum(
        c.n for c in got["counts"] if c.kind == "sync")
    image_reads = [c for c in got["counts"] if c.site == "session.image"]
    assert len(image_reads) == 1 and image_reads[0].tick == image.id
    before = r.host_syncs
    r.image_u8()
    assert r.host_syncs == before + 1
