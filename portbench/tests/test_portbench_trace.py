"""The trace reduction and the roofline arithmetic on synthetic inputs."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import pbcases  # noqa: F401  (puts the harness on the path)
import devtrace
import harness
import roofline
from devtrace import MARKER, Event


def _events():
    ms = 1e-3
    return [
        # The harness's opening and closing synchronizations bound the window.
        Event(MARKER, -1 * ms, 0.0, False),
        Event(MARKER, 99 * ms, 100 * ms, False),
        Event("aten::item", 38 * ms, 62 * ms, False),
        Event("cudaStreamSynchronize", 40 * ms, 60 * ms, False),
        Event("cudaLaunchKernel", 1 * ms, 2 * ms, False),
        Event("cudaEventSynchronize", 150 * ms, 151 * ms, False),  # outside
        Event("void discrete_kernel<true, false>(float const*)", 0.0,
              30 * ms, True),
        Event("lane_sum_kernel(float const*, int)", 20 * ms, 40 * ms, True),
        Event("Memcpy DtoH (Device -> Pageable)", 60 * ms, 70 * ms, True),
        Event("void at::native::elementwise_kernel<4>()", 90 * ms, 110 * ms,
              True),
    ]


def test_summary_arithmetic():
    s = devtrace.summarize(_events(), ["discrete_kernel", "lane_sum_kernel"])
    assert s.window_s == pytest.approx(0.1)
    # Busy: [0, 40] u [60, 70] u [90, 100] (clipped to the window) = 60 ms.
    assert s.busy_s == pytest.approx(0.060)
    assert s.kernels == 3 and s.syncs == 1
    assert s.program_kernel_s == pytest.approx(0.050)
    names = dict(s.device_ops)
    assert names["discrete_kernel"] == pytest.approx(0.030)
    assert names["at::native::elementwise_kernel"] == pytest.approx(0.010)
    assert names["Memcpy DtoH"] == pytest.approx(0.010)
    gaps = dict(s.idle_gaps)
    # The 40-60 ms gap sits inside the sync; 70-90 ms under no host op.
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.020)
    assert gaps["(no host op)"] == pytest.approx(0.020)


def test_window_from_the_markers_or_the_annotation():
    assert devtrace.window(_events()) == pytest.approx((0.0, 0.1))
    ann = [Event(devtrace.WINDOW, 0.5, 2.0, False)]
    assert devtrace.window(ann) == (0.5, 2.0)
    with pytest.raises(RuntimeError):
        devtrace.window([Event(MARKER, 0.0, 1.0, False)])


def test_metric_readers_on_a_summary():
    s = devtrace.summarize(_events(), ["discrete_kernel", "lane_sum_kernel"])
    ctx = SimpleNamespace(summary=s, frames=4, kind="converge",
                          algorithm="POINT", cache={})
    read = lambda n: harness.load_metric(n).read(ctx)  # noqa: E731
    assert read("device_idle_pct.frame") == pytest.approx(40.0)
    assert read("device_busy_ms_per_frame.frame") == pytest.approx(15.0)
    assert read("launches_per_frame.frame") == pytest.approx(0.75)
    assert read("host_syncs_per_frame.frame") == pytest.approx(0.25)
    assert read("gather_ms_per_frame.frame") == pytest.approx(12.5)
    # The drag and PATH readers find nothing to read in this run.
    assert read("device_idle_pct.drag") is None
    assert read("launches_per_frame.path") is None
    ctx.algorithm = "PATH"
    assert read("device_idle_pct.path") == pytest.approx(40.0)
    assert read("device_busy_ms_per_frame.path") == pytest.approx(15.0)
    assert read("device_busy_ms_per_frame.frame") is None
    assert read("host_syncs_per_frame.path") == pytest.approx(0.25)
    ctx.cache["least_time"] = (0.010, {})
    assert read("gather_roofline_pct.frame") == pytest.approx(20.0)


def test_a_metric_file_reads_the_events(tmp_path, monkeypatch):
    """A reader added as a file alone sees every event of the window: here
    one kernel's device time, which the summary sums with the others."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "lane_sum_ms.frame.py").write_text(
        "def read(ctx):\n"
        "    return 1e3 * sum(e.end - e.start for e in ctx.events\n"
        "                     if e.device and 'lane_sum' in e.name)\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    ctx = SimpleNamespace(events=_events())
    assert harness.load_metric("lane_sum_ms.frame").read(ctx) == (
        pytest.approx(20.0))


def test_program_kernels_found_in_the_sources():
    import volumerenderer_tpu_torch as vt
    from pathlib import Path

    names = devtrace.program_kernels(Path(vt.__file__).parent)
    for k in ("gather_lanes_kernel", "discrete_kernel", "lane_sum_kernel",
              "vpu_kernel", "many_kernel", "analytic_kernel"):
        assert k in names


def test_frame_work_and_bound():
    ops, nbytes = roofline.frame_work("RAY", live=1000, hit_rays=100,
                                      lights=7, sub=200)
    assert ops == 1000 * 200 * 13 + 200 * 8
    assert nbytes == 16 * 1000 + 4 * 100 + 28 * 7
    ops, _ = roofline.frame_work("POINT", live=1000, hit_rays=100, lights=40,
                                 sub=0)
    assert ops == 1000 * 40 * 13
    ops, _ = roofline.frame_work("BEAM", live=10, hit_rays=1, lights=1,
                                 sub=3)
    assert ops == 10 * 3 * 18 + 3 * 8
    t, by = roofline.bound(67e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = roofline.bound(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_traced_cpu_run_reports_its_metrics():
    """A traced run on the CPU reads the window and no device time: the
    readers of device time find nothing and stay silent, never 0 for a
    roofline."""
    result, _ = pbcases.run_small("cloud96-point-converge", traced=True,
                                  width=32, height=24)
    m = result["metrics"]
    assert "gather_roofline_pct.frame" not in m
    assert m["device_idle_pct.frame"]["value"] == pytest.approx(100.0)
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
