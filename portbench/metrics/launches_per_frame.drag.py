"""Kernels on the card per frame of the traced drag and settle window."""


def read(ctx):
    if ctx.kind != "drag":
        return None
    return ctx.summary.kernels / ctx.frames
