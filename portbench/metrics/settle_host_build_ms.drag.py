"""Host time of a host-banded build in the traced drag and settle window:
the program's "color.build" spans over its "view" counts at
"color.build.host" (one a host-banded build); None without such a build
there (a device-built settle, or a tree before the counts)."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "drag":
        return None
    builds = w.count("view", "color.build.host")
    if not builds:
        return None
    return w.host_s("color.build") * 1e3 / builds
