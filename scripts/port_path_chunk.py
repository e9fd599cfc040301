#!/usr/bin/env python3
"""PATH's chunk width (StaticConfig.path_chunk) on the GPU.

    python3 scripts/port_path_chunk.py [--profile] [width ...]

Runs chip_smoke.py's PATH phase at the 1080p bench config once for each
chunk width (default 16384, 65536, 262144, 1048576 and 4194304, the last
wider than any segment's alive rays: one chunk a segment), in one process:
ms/frame over step(4) after step(2), host syncs per frame, peak memory and
the frame split by stage.  The first width also runs the bit-exact checks
(frames are identical for any width).  Prints the card's name and power
limit first and one JSON line per width.

``--profile``: afterwards, one cached frame at the default width under
torch.profiler: the frame's wall time, the device's busy time (kernel
durations summed), the kernel launches and the ten costliest kernels.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_path_chunk: CUDA is not available", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if a != "--profile"]
    widths = [int(a) for a in args] or [
        16384, 65536, 262144, 1048576, 4194304]
    print(cs.nvidia_smi_line(), flush=True)
    for i, w in enumerate(widths):
        cs.phase_path(f"path_chunk={w}", {"path_chunk": w}, {},
                      checks=i == 0)
    if "--profile" in sys.argv:
        profile_frame()
    return 0


def profile_frame() -> None:
    """One cached PATH frame under torch.profiler (after two warm frames)."""
    import json
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    r = cs.path_renderer()
    r.step(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({
        "phase": "pathprofile", "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches": sum(e.count for e in events),
        "top_kernels": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                        for e in top],
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
