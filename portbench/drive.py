"""What every traffic driver shares.  A traffic mix is a data file
(``traffic/<name>.json``) whose ``kind`` names a driver,
``drivers/<kind>.py``, found by that name; the driver reads the mix's
parameters and drives the program's Renderer through it, as the port's
viewer does (``viewer.InteractiveViewer.tick``: step, then copy the image
to the host).

A driver module defines

    drive(open_session, traffic, seconds, rng, clock, on_window) -> dict

``open_session()`` loads the volume through the program's user path and
returns a ``Session`` (a driver may open it inside the window, or more than
once); ``on_window()`` is called once, when the measured window opens;
``clock()`` is the host clock in seconds.  The driver warms up the shapes of
its own traffic, measures for ``seconds``, and returns

    window_s, frames       the window's length and the frames it completed
    metrics                the cell's end-to-end metrics, by name
    samples                the ticks the check compares (``check.py``)
    window_frames          the frame counters rendered in the window
    tick_ms                (optional) each timed tick's latency, for the log
    counts                 (optional) further counts, for the log

It may also define ``make_renderer(grid, inputs, config, traffic, device)``,
which replaces the harness's, and ``control_samples(traffic, inputs, rng)``,
the ticks ``control.py`` reads: the frame counts and cameras a run of this
kind compares."""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


class Reservoir:
    """A uniform sample of ``cap`` items of a stream, drawn from ``rng``."""

    def __init__(self, cap: int, rng):
        self.cap, self.rng, self.items, self.seen = int(cap), rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.cap:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.cap:
                self.items[j] = item


def _image(r) -> np.ndarray:
    """The presented image, on the host (one channel: the lights are
    white)."""
    return r.image()[..., 0]


class Session:
    """A Renderer with the frame count the harness keeps itself."""

    def __init__(self, renderer):
        self.r = renderer
        self.frames = 0
        self.last = None

    def tick(self, k: int):
        prev, n0 = self.last, self.frames
        self.r.step(k)
        self.last = _image(self.r)
        self.frames += k
        return prev, self.last, n0, self.frames


def driver(kind: str):
    """The module ``drivers/<kind>.py``."""
    path = HERE / "drivers" / f"{kind}.py"
    if not path.exists():
        raise KeyError(f"no traffic driver {kind!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_driver_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def default_clock():
    return time.perf_counter()
