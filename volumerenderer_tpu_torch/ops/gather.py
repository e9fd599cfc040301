"""Point/sphere radiance gather dispatch (twin of volumerenderer_tpu.ops.gather).

    point:   sum_l I_l / (4 pi |p - l|^2)         with |.|^2 < 1e-4 -> 0
    sphere:  sum_l I_l / (4 pi (|p - c_l| - r)^2)  same guard, centre -> 0
(common_functions.h:186-201).
"""

from __future__ import annotations

import torch

from .kernels.gather_lanes import gather_lanes
from .lights import FOUR_PI, GUARD

# Above this many light slots the reference package takes its many-light
# matmul kernel (gather_mxu), which is not ported yet.
SMEM_LIGHT_LIMIT = 2048


def gather_xla(samples, l_pos, l_int, l_valid, *, sphere: bool, radius=0.0,
               light_chunk: int = 512):
    """Plain light-chunked gather, the reference package's ``impl="xla"``
    oracle: samples (N, 3) -> (N,) radiance."""
    l_int = torch.where(l_valid, l_int, 0.0)
    # Park invalid lights far away so their zero terms cannot trip the guard.
    l_pos = torch.where(l_valid[:, None], l_pos, 1e15)
    acc = torch.zeros(samples.shape[0], dtype=torch.float32,
                      device=samples.device)
    for a in range(0, l_pos.shape[0], light_chunk):
        lp, li = l_pos[a:a + light_chunk], l_int[a:a + light_chunk]
        diff = samples[:, None, :] - lp[None, :, :]
        if sphere:
            dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
            d2 = (dist - radius) ** 2
            bad = (d2 < GUARD) | (dist == 0.0)
        else:
            d2 = torch.sum(diff * diff, dim=-1)
            bad = d2 < GUARD
        c = li[None, :] / (FOUR_PI * d2)
        acc = acc + torch.sum(torch.where(bad, 0.0, c), dim=-1)
    return acc


def gather_planes(px, py, pz, weight, l_pos, l_int, l_valid, *,
                  sphere: bool, radius=0.0, layout: str = "lanes",
                  lane_need=None, paired: bool = False):
    """Gather over lane planes (Cp, Rc) -> (Rc,) per-ray sums
    ``sum_samples(w * sum_lights)``.  The valid light slots must form one
    contiguous range (true for photon lights); its start and count stay on
    the device.  ``paired=True``: one divide per 4 lights."""
    if layout != "lanes":
        raise NotImplementedError(
            f"gather_planes(layout={layout!r}): the slots layout is not "
            "ported to PyTorch yet: ROADMAP Queue 1 item 10"
        )
    if l_pos.shape[0] > SMEM_LIGHT_LIMIT:
        raise NotImplementedError(
            f"{l_pos.shape[0]} light slots > {SMEM_LIGHT_LIMIT}: the "
            "many-light gather (gather_mxu) is not ported to PyTorch yet: "
            "ROADMAP Queue 2 item 7"
        )
    valid_i = l_valid.to(torch.int32)
    start = torch.argmax(valid_i)  # first valid slot (0 if none; count 0)
    count = valid_i.sum()
    return gather_lanes(
        px, py, pz, weight, l_pos, l_int, start, count, sphere=sphere,
        radius=radius, lane_need=lane_need, paired=paired,
    )
