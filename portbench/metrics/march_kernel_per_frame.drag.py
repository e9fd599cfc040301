"""Marches through the march kernel (the program's "march" count at the
site "color.march.kernel": one a ``render.color._march_planes`` call that
takes csrc/march_planes.cu) per frame of the traced drag and settle window;
None where the program counts no march by route."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "drag" or not w.count("march"):
        return None
    return w.count("march", "color.march.kernel") / ctx.frames
