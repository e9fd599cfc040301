"""Host time in the photon walk (the program's "photon.walk" spans:
``render.photon.generate_lights``, the Python window loop) per frame of the
traced converging window."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm == "PATH":
        return None
    return w.host_s("photon.walk") * 1e3 / ctx.frames
