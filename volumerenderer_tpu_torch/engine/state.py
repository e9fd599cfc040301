"""Render state: the progressive accumulation buffer and the frame counter
(twin of volumerenderer_tpu.engine.state).  The frame counter is a host
integer: the session always knows it, so no frame reads it back."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class RenderState:
    accum: torch.Tensor  # (H, W) f32 scalar radiance (white light)
    frame_count: int = 0  # 0 == cleared, restart accumulation

    @classmethod
    def create(cls, height: int, width: int, device="cpu") -> "RenderState":
        return cls(
            accum=torch.zeros((height, width), dtype=torch.float32,
                              device=device),
            frame_count=0,
        )

    def refresh(self) -> "RenderState":
        """'Refresh' button / algorithm switch: the next frame clears and
        restarts the average."""
        return dataclasses.replace(self, frame_count=0)

    def rgb(self) -> torch.Tensor:
        """(H, W, 3) view: white lights broadcast to RGB."""
        return self.accum[..., None].expand(*self.accum.shape, 3)

    def rgb_u8(self) -> torch.Tensor:
        """rgba8-storage-image view of the accumulator."""
        return (torch.clamp(self.rgb(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def accumulate(accum: torch.Tensor, frame: torch.Tensor,
               frame_count: int, quantize_u8: bool = False) -> torch.Tensor:
    """Progressive average (point_compute_color.comp:97-105):
    new = (prev * (N - 1) + frame) / N, N = frameCount (1-based).

    The reference's storage image is rgba8, so its accumulator quantizes
    to 8 bits every frame; ``quantize_u8=True`` does the same (round half
    to even, as the reference package's ``jnp.round``)."""
    n = float(frame_count)
    new = (accum * (n - 1.0) + frame) / n
    if quantize_u8:
        new = torch.round(torch.clamp(new, 0.0, 1.0) * 255.0) / 255.0
    return new
