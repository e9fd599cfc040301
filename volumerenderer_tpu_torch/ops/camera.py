"""Pinhole camera rays (twin of volumerenderer_tpu.ops.camera.camera_rays).

    x = (2 (px + 0.5) / W - 1) * aspect * tan(fov/2)
    y = (1 - 2 (py + 0.5) / H) * tan(fov/2)
    dir = normalize(rotation @ (x, y, 1))
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling
from .march import f32
from .rng import norm3


def camera_rays(
    width: int,
    height: int,
    fov_deg,
    camera_pos,
    look_rotation=None,
    row_start: int = 0,
    num_rows: int | None = None,
    *,
    device="cpu",
):
    """Return (origins, directions), each (num_rows, W, 3) f32, world space.

    Row j is image row ``row_start + j``; the projection uses the full
    image size, so a row slice renders like the matching slice of the
    frame.  ``look_rotation``: optional (3, 3) rotation of the directions."""
    if num_rows is None:
        num_rows = height
    # The field of view and the camera position are copied to ``device``.
    profiling.count("sync", "camera.rays", 2)
    fov = torch.as_tensor(fov_deg, dtype=torch.float32, device=device)
    scale = torch.tan(fov * f32(0.5 * math.pi / 180.0))
    aspect = f32(width / height)
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py = (
        float(row_start)
        + torch.arange(num_rows, dtype=torch.float32, device=device)[:, None]
    )
    # The reference expression as XLA compiles it (bit-identical): the
    # divide by the constant size is a multiply by the f32 constant 2/size,
    # and aspect * scale is formed before it scales x.
    x = ((px + 0.5) * f32(2.0 / width) - 1.0) * (aspect * scale)
    y = (1.0 - (py + 0.5) * f32(2.0 / height)) * scale
    x = x.expand(num_rows, width)
    y = y.expand(num_rows, width)
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if look_rotation is not None:
        m = look_rotation
        d = torch.stack(
            [
                m[0, 0] * d[..., 0] + m[0, 1] * d[..., 1] + m[0, 2] * d[..., 2],
                m[1, 0] * d[..., 0] + m[1, 1] * d[..., 1] + m[1, 2] * d[..., 2],
                m[2, 0] * d[..., 0] + m[2, 1] * d[..., 1] + m[2, 2] * d[..., 2],
            ],
            dim=-1,
        )
    d = d / norm3(d)
    o = torch.as_tensor(camera_pos, dtype=torch.float32, device=device).expand(d.shape)
    return o, d
