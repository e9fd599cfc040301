"""Device time per frame of the traced converging window: the union of every
operation's interval on the card (kernels, copies, sets) over the frames.
Unlike the idle share, the profiler's own cost on the host does not enter
it; with the untraced frame time it gives the untraced idle share."""


def read(ctx):
    if ctx.kind != "converge" or ctx.algorithm == "PATH":
        return None
    return ctx.summary.busy_s * 1e3 / ctx.frames
