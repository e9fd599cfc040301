"""Host time in the full march of the uncached frames (the program's
"color.march" spans: ``render.color.build_view``, the coarse drag frames)
per frame of the traced drag and settle window."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "drag":
        return None
    return w.host_s("color.march") * 1e3 / ctx.frames
