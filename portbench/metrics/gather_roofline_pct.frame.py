"""The CUDA gather kernels' share of their roofline over a converging
window: the least time the card could take for the window's gathers
(``roofline.least_time``: the reference march's live samples times each
frame's lights or sub-lights from the reference photon walk) over the
device time of the kernels built from the port's ``csrc/``."""

import roofline


def read(ctx):
    s = ctx.summary
    if ctx.kind != "converge" or s.program_kernel_s <= 0:
        return None
    if "least_time" not in ctx.cache:
        ctx.cache["least_time"] = roofline.least_time(
            ctx.inputs, ctx.algorithm, ctx.camera, ctx.frame_counts,
            ctx.device)
    least, _ = ctx.cache["least_time"]
    return 100.0 * least / s.program_kernel_s
