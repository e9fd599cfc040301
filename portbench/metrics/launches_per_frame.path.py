"""Kernels on the card per frame of the traced PATH window."""


def read(ctx):
    if ctx.kind != "converge" or ctx.algorithm != "PATH":
        return None
    return ctx.summary.kernels / ctx.frames
