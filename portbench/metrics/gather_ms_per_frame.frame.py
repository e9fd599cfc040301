"""Device time of the kernels built from the port's ``csrc/`` per frame of
the traced converging window."""


def read(ctx):
    s = ctx.summary
    if ctx.kind != "converge" or s.program_kernel_s <= 0:
        return None
    return s.program_kernel_s * 1e3 / ctx.frames
