"""The share of the compact view's plane samples that the gather reads, in
the traced converging window: the program's "view" counts at
"color.shade.live" (each frame's live samples, the sum of the bands'
``lane_need``) over those at "color.shade.held" (the plane samples the view
holds), as a %.  None where the program counts neither (a view whose build
read no live total, or a tree before the counts)."""

import spans


def read(ctx):
    w = spans.of(ctx)
    if w is None or ctx.kind != "converge":
        return None
    held = w.count("view", "color.shade.held")
    if not held:
        return None
    return 100.0 * w.count("view", "color.shade.live") / held
