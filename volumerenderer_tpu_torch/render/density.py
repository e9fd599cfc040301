"""Headless density-integral renderer (twin of
volumerenderer_tpu.render.density): the reference's CPU_test harness
(CPU_test/main.cpp:25-43, 103-126).

A 256x256 pinhole render from camera (0, 250, -800), fov 45; each ray
accumulates ``density += value(floor(pos)) * dt`` for t in [0, t_max) with
dt = 1; the grayscale image is ``min(density * 5, 255)``.

Quirk kept: the reference uses the world-space position directly as an
index coordinate, with no world-to-index transform (CPU_test/main.cpp:
34-37).  ``apply_transform=True`` gives the corrected behaviour.
"""

from __future__ import annotations

import torch

from ..grid.dense import DenseGrid
from ..ops import camera
from ..ops.march import f32, f32mul
from ..ops.rng import norm3


def render_density(
    grid: DenseGrid,
    *,
    width: int = 256,
    height: int = 256,
    camera_pos=(0.0, 250.0, -800.0),
    fov: float = 45.0,
    t_max: float = 1200.0,
    dt: float = 1.0,
    num_steps: int | None = None,
    apply_transform: bool = False,
) -> torch.Tensor:
    """The accumulated density integral, (H, W) f32 on the grid's device.

    A fixed trip of ``num_steps`` (default ``int(t_max / dt)``) nearest
    fetches per ray at t = k * dt, summed in step order.
    ``min(density * 5, 255) / 255`` of this is the reference's PPM image."""
    if num_steps is None:
        num_steps = int(t_max / dt)
    o_w, d_w = camera.camera_rays(width, height, fov, camera_pos,
                                  device=grid.device)
    o, d = o_w.reshape(-1, 3), d_w.reshape(-1, 3)
    if apply_transform:
        o = grid.world_to_index(o)
        d = grid.world_to_index_dir(d)
        d = d / norm3(d)
    dt = f32(dt)
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=grid.device)
    for k in range(num_steps):
        pos = o + d * f32mul(k, dt)
        acc = acc + grid.sample_nearest(pos) * dt
    return acc.reshape(height, width)


def to_grayscale_u8(density: torch.Tensor) -> torch.Tensor:
    """min(density * 5, 255) as uint8 (CPU_test/main.cpp:118)."""
    return torch.clamp(density * 5.0, max=255.0).to(torch.uint8)
