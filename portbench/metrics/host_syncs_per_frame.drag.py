"""Runtime calls that wait for the card (stream, device and event
synchronizations and blocking copies, ``devtrace.SYNC_CALLS``) per frame of
the traced drag and settle window."""


def read(ctx):
    if ctx.kind != "drag":
        return None
    return ctx.summary.syncs / ctx.frames
