"""The share of the photon walks that take the walk kernel, in the traced
converging window: the program's "walk" counts at the site
"photon.walk.kernel" (one a ``generate_lights`` call that launches
csrc/photon_walk.cu) over its "walk" counts at every site, as a %.  None
where the program counts no walk by route, as on a tree before the
kernel."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge" or ctx.algorithm == "PATH":
        return None
    walks = w.count("walk")
    if not walks:
        return None
    return 100.0 * w.count("walk", "photon.walk.kernel") / walks
