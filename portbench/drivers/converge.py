"""``converge``: a still camera and one user; each tick is
``step(frames_per_tick)`` then ``image()``.

Traffic keys: ``algorithm``, ``config`` (StaticConfig fields),
``frames_per_tick``, ``check_ticks`` (ticks of the window the check
compares, drawn from the seed)."""

from __future__ import annotations

import numpy as np

from drive import Reservoir

WARMUP_TICKS = 2
# Ticks of a control sample are drawn at frame counts a window reaches.
CONTROL_TICKS = (2, 400)


def drive(open_session, traffic, seconds, rng, clock, on_window=None):
    sess = open_session()
    k = int(traffic["frames_per_tick"])
    for _ in range(WARMUP_TICKS):
        sess.tick(k)
    cam = sess.r.params.camera_pos.copy()
    samples = Reservoir(traffic["check_ticks"], rng)
    first = sess.frames
    if on_window:
        on_window()
    t0 = clock()
    ends = []
    while True:
        prev, img, n0, n1 = sess.tick(k)
        samples.offer(dict(prev=prev, img=img, n0=n0, n1=n1, camera=cam,
                           coarse=False))
        ends.append(clock() - t0)
        if ends[-1] >= seconds:
            break
    window = ends[-1]
    frames = len(ends) * k
    return dict(window_s=window, frames=frames,
                metrics={traffic["metric"]: window * 1e3 / frames},
                samples=samples.items,
                window_frames=list(range(first + 1, sess.frames + 1)),
                tick_ms=np.diff(ends, prepend=0) * 1e3)


def control_samples(traffic, inputs, rng):
    k = int(traffic["frames_per_tick"])
    n0 = k * rng.randrange(*CONTROL_TICKS)
    return [dict(n0=n0, n1=n0 + k, camera=inputs["params"]["camera_pos"],
                 coarse=False)]
