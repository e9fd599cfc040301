"""Tracing and frame statistics (twin of volumerenderer_tpu.utils.
profiling): ``torch.profiler`` traces, an FPS counter and the device
memory statistics."""

from __future__ import annotations

import contextlib
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
