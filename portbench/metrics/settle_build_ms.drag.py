"""Host time a settle spends building the exact view: the program's
"color.build" spans (the settle's row chunks) and "color.merge" spans over
the number of merges, in the traced drag and settle window; None without a
merge there."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "drag":
        return None
    merges = sum(1 for s in w.spans if s.name == "color.merge")
    if not merges:
        return None
    return (w.host_s("color.build") + w.host_s("color.merge")) * 1e3 / merges
