"""The share of the traced drag and settle window in which nothing ran on the card
(no kernel, copy or set): the window less the union of device activity."""


def read(ctx):
    s = ctx.summary
    if ctx.kind != "drag" or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
