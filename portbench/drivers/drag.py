"""``drag``: one user dragging the camera and waiting for each frame.
Episodes of ``drag_frames`` frames, each moving the camera ``move`` units
in the image plane (out along one of ``DIRECTIONS`` directions, then back),
then ticks of ``step(1)`` until the view is exact again.  The seed orders
the directions; every seed makes the same moves.

A drag frame's latency runs from ``set(camera_pos=...)`` to its image on
the host; a settle from the end of the episode's last drag frame to the
image of the first exact frame.

Traffic keys: ``algorithm``, ``config`` (StaticConfig fields),
``renderer`` (Renderer attributes), ``drag_frames``, ``move``."""

from __future__ import annotations

import math

import numpy as np

from drive import Reservoir

DIRECTIONS = 8
WARMUP_EPISODES = 2
CHECK_DRAGS = 2  # coarse drag frames the check compares, drawn from the seed
CHECK_SETTLES = 1  # settled exact frames
MAX_SETTLE_TICKS = 64
# Frame counts of the control's samples: those a window reaches.
CONTROL_FRAMES = (16, 600)


def _directions(rng):
    order = list(range(DIRECTIONS))
    rng.shuffle(order)
    return [np.float32([math.cos(2 * math.pi * i / DIRECTIONS),
                        math.sin(2 * math.pi * i / DIRECTIONS), 0.0])
            for i in order]


def _episodes(home, traffic, rng):
    """The camera positions of each episode, endlessly: out along one
    direction, then back to ``home``, then out along the next."""
    n = int(traffic["drag_frames"])
    move = float(traffic["move"])
    dirs = _directions(rng)
    e = 0
    while True:
        u = dirs[(e // 2) % len(dirs)]
        steps = range(1, n + 1) if e % 2 == 0 else range(n - 1, -1, -1)
        yield [np.float32(home + move * s * u) for s in steps]
        e += 1


def _episode(sess, positions, clock, log):
    """One drag episode and its settle; ``log`` (or None in the warm-up)
    takes the drag frames' and the settle's times and samples."""
    r = sess.r
    for pos in positions:
        t = clock()
        r.set(camera_pos=pos)
        prev, img, n0, n1 = sess.tick(1)
        if log:
            log["drag_s"].append(clock() - t)
            log["drags"].offer(dict(prev=prev, img=img, n0=n0, n1=n1,
                                    camera=pos, coarse=True))
    t = clock()
    ticks = 0
    while True:
        prev, img, n0, n1 = sess.tick(1)
        ticks += 1
        if r.view_exact:
            break
        if ticks > MAX_SETTLE_TICKS:
            raise RuntimeError(
                f"drag: the view did not settle in {MAX_SETTLE_TICKS} ticks")
    if log:
        log["settle_s"].append(clock() - t)
        log["settle_ticks"] += ticks
        log["settles"].offer(dict(prev=prev, img=img, n0=n0, n1=n1,
                                  camera=positions[-1], coarse=False,
                                  settled=True))


def drive(open_session, traffic, seconds, rng, clock, on_window=None):
    sess = open_session()
    home = sess.r.params.camera_pos.copy()
    sess.tick(1)  # the first frame (uncached with first_frame_uncached)
    sess.tick(1)  # the view build
    episodes = _episodes(home, traffic, rng)
    for _ in range(WARMUP_EPISODES):
        _episode(sess, next(episodes), clock, None)
    log = dict(drag_s=[], settle_s=[], settle_ticks=0,
               drags=Reservoir(CHECK_DRAGS, rng),
               settles=Reservoir(CHECK_SETTLES, rng))
    first = sess.frames
    if on_window:
        on_window()
    t0 = clock()
    while clock() - t0 < seconds:
        _episode(sess, next(episodes), clock, log)
    window = clock() - t0
    d_ms = np.array(log["drag_s"]) * 1e3
    s_ms = np.array(log["settle_s"]) * 1e3
    return dict(window_s=window, tick_ms=d_ms,
                frames=sess.frames - first,
                metrics={"drag_p95_ms": float(np.percentile(d_ms, 95)),
                         "settle_ms": float(s_ms.sum() / len(s_ms))},
                samples=log["drags"].items + log["settles"].items,
                window_frames=list(range(first + 1, sess.frames + 1)),
                counts={"drag_frames": len(d_ms), "settles": len(s_ms)})


def control_samples(traffic, inputs, rng):
    """A coarse frame at a camera of the drag's first episode and a settled
    exact frame at its last."""
    positions = next(_episodes(inputs["params"]["camera_pos"], traffic, rng))
    n0 = rng.randrange(*CONTROL_FRAMES)
    return [dict(n0=n0, n1=n0 + 1, camera=rng.choice(positions), coarse=True),
            dict(n0=n0 + 8, n1=n0 + 9, camera=positions[-1], coarse=False,
                 settled=True)]
