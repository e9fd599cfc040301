"""Pieces of the reference against loops written from the shaders' text
(point/sphere_light_contribution, the Ray/Beam sub-light expansion) and
the active box of a sparse file."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import pbcases  # noqa: F401  (puts the harness on the path)
from reference import render as ref


def _point(sample, light, inten):
    d2 = float(np.dot(light - sample, light - sample))
    return 0.0 if d2 < 1e-4 else inten / (4 * math.pi * d2)


def _sphere(sample, center, inten, radius):
    diff = sample - center
    n = float(np.linalg.norm(diff))
    if n == 0.0:
        return 0.0
    return _point(sample, center + diff / n * radius, inten)


@pytest.mark.parametrize("sphere", [False, True])
def test_light_sums_match_the_shader_loop(sphere):
    g = np.random.default_rng(3)
    samples = g.uniform(-5, 5, (50, 3)).astype(np.float32)
    lights = g.uniform(-5, 5, (7, 3)).astype(np.float32)
    lights[0] = samples[0]  # a light on a sample: the guard gives 0
    inten = g.uniform(1, 10, 7).astype(np.float32)
    got = ref.light_sums(torch.as_tensor(samples), torch.as_tensor(lights),
                         torch.as_tensor(inten), sphere=sphere, radius=0.1)
    term = (lambda s, l, i: _sphere(s, l, i, 0.1)) if sphere else _point
    want = [sum(term(s, l, i) for l, i in zip(lights, inten))
            for s in samples.astype(np.float64)]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


def test_sub_lights_cut_every_step():
    pf = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 0.0, 0.0]])
    pt = torch.tensor([[1.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 0.25, 0.0]])
    it = torch.tensor([6.0, 5.0, 4.0])
    pos, inten = ref.sub_lights(pf, pt, it, 0.3)
    # 1 / 0.3 -> 3 sub-lights of 2.0; a point segment and one shorter than
    # a step give none.
    assert pos.shape == (3, 3)
    np.testing.assert_allclose(pos[:, 0].numpy(),
                               [0.0, np.float32(0.3), np.float32(0.6)])
    np.testing.assert_allclose(inten.numpy(), [2.0, 2.0, 2.0])


def test_active_volume_is_the_tight_box_of_nonzero_voxels():
    v = torch.zeros(10, 12, 14)
    v[2, 3, 4] = 1.0
    v[5, 9, 6] = 2.0
    vol = ref.Volume.active(v, (-5, -6, -7), 0.5, (1.0, 2.0, 3.0))
    assert vol.shape == (4, 7, 3)
    assert vol.bbox_min.tolist() == [-3, -3, -3]
    assert vol.padded_shape == (8, 8, 8)
    pos = torch.tensor([[-3.5, -2.5, -2.5], [-2.5, -2.5, -2.5],
                        [0.5, 3.5, -0.5]])
    assert vol.sample(pos).tolist() == [0.0, 1.0, 2.0]
