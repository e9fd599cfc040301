"""Kernels on the card per frame of the traced converging window."""


def read(ctx):
    if ctx.kind != "converge":
        return None
    return ctx.summary.kernels / ctx.frames
