"""The photon walk's host reads (the program's "sync" count at the site
"photon.walk": one a window of its loop) per frame of the traced converging
window."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm == "PATH":
        return None
    return w.count("sync", "photon.walk") / ctx.frames
