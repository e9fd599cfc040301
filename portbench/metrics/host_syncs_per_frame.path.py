"""Runtime calls that wait for the card (stream, device and event
synchronizations and blocking copies, ``devtrace.SYNC_CALLS``) per frame of
the traced PATH window."""


def read(ctx):
    if ctx.kind != "converge" or ctx.algorithm != "PATH":
        return None
    return ctx.summary.syncs / ctx.frames
