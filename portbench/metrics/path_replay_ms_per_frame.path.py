"""Self time of the program's "path.replay" spans (the camera segment,
replayed from the baked view) per frame of the traced PATH window."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm != "PATH":
        return None
    return w.self_s("path.replay") * 1e3 / ctx.frames
