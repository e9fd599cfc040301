"""Self time of the program's "path.compact" spans (each scatter
segment's alive count and sort) per frame of the traced PATH window."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm != "PATH":
        return None
    return w.self_s("path.compact") * 1e3 / ctx.frames
