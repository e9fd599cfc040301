"""Device-idle time that falls inside the photon walk, per frame of the
traced converging window: the window less the union of device operations,
intersected with the program's "photon.walk" spans."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm == "PATH":
        return None
    return w.idle_inside_s(ctx.events, "photon.walk") * 1e3 / ctx.frames
