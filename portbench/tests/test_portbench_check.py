"""The number ``correct`` compares, on ticks read back from a float32
running average as the program keeps it (``(accum * (n - 1) + frame) / n``):
its rounding stays a small part of the reading at any frame count, and an
altered answer still reads far above it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pbcases  # noqa: F401  (puts the harness on the path)
import check

PIXELS = 4096


def _tick(n0: int, frames: torch.Tensor, seed: int = 0):
    """(image before, image after) of a tick of ``frames`` accumulated from
    frame ``n0 + 1`` onto an average of ``n0`` frames near 0.02."""
    g = torch.Generator().manual_seed(seed)
    img0 = 0.02 * (0.5 + torch.rand(PIXELS, generator=g))
    acc = img0.clone()
    for i, f in enumerate(frames, start=n0 + 1):
        acc = (acc * (i - 1.0) + f) / i
    return img0.numpy(), acc.numpy()


def _reading(n0, frames, ref):
    img0, img1 = _tick(n0, frames)
    n1 = n0 + len(frames)
    got = check.port_sum(dict(img=img1, prev=img0, n0=n0, n1=n1))
    return check.rel_l1(got, ref.double().sum(0).numpy(), len(frames),
                        check.resolution(img1, n1))


@pytest.mark.parametrize("n0", [100, 1_000, 10_000, 100_000, 1_000_000])
def test_black_frame_reads_little_at_any_frame_count(n0):
    frames = torch.zeros(1, PIXELS)
    assert _reading(n0, frames, frames) < 2e-4


@pytest.mark.parametrize("n0", [100, 10_000, 100_000, 1_000_000])
def test_converging_tick_reads_little_at_any_frame_count(n0):
    g = torch.Generator().manual_seed(1)
    frames = 0.04 * torch.rand(8, PIXELS, generator=g)
    assert _reading(n0, frames, frames) < 4e-4


@pytest.mark.parametrize("n0", [100, 10_000])
def test_altered_tick_reads_above_every_limit(n0):
    g = torch.Generator().manual_seed(2)
    ref = 0.04 * torch.rand(8, PIXELS, generator=g)
    bright = ref.clone()
    bright[:, ::8] *= 1.05
    assert _reading(n0, bright, ref) > 3e-3
