"""Ray/VRL and Beam/VBL shading (CPU): the same view and the same lights,
carried across with convert.lights_from_numpy, through the port's and the
JAX package's color pass, for each segment mode; so the shading is held at
the kernels' own bound whatever the photon walks' ulps do."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from test_torch_gather_segments import far_weights
from test_torch_photon import port_config
from test_torch_slice_segments import (
    ALGOS, FRAME_ATOL, VARIANTS, jax_renderer, port_renderer, small_scene,
)
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu.render import color as jcolor
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import color as tcolor

T = torch.as_tensor


def _masked_views(jview, lights, radius):
    """The JAX view with the weights of samples near a guard surface of
    this frame's segments zeroed (see test_torch_gather_segments), and the
    port's CompactView holding the same arrays."""
    pf = np.asarray(lights.pos_from)
    pt = np.asarray(lights.pos_to)
    valid = np.asarray(lights.valid)
    jbands, tbands = [], []
    for b in jview.bands:
        wx, wy, wz = (np.array(a) for a in (b.wx, b.wy, b.wz))
        p = np.stack([wx.ravel(), wy.ravel(), wz.ravel()], -1).astype(
            np.float64)
        dist = np.full(p.shape[0], np.inf)
        for k in np.nonzero(valid)[0]:
            a = pf[k].astype(np.float64)
            seg = pt[k] - a
            t = np.clip((p - a) @ seg / max(seg @ seg, 1e-12), 0.0, 1.0)
            dist = np.minimum(
                dist, np.linalg.norm(p - a - t[:, None] * seg, axis=-1))
        w = far_weights(np.asarray(b.weight), dist.reshape(wx.shape), radius)
        jbands.append(b.replace(weight=jnp.asarray(w)))
        tbands.append(tcolor.PlaneBand(T(wx), T(wy), T(wz), T(w),
                                       T(np.array(b.lane_need))))
    tview = tcolor.CompactView(
        bands=tuple(tbands), inv_map=T(np.array(jview.inv_map)),
        src=T(np.array(jview.src)), n_rays=jview.n_rays, rows=jview.rows)
    return jview.replace(bands=tuple(jbands)), tview


def shade_both(rj, g, p, c, algorithm):
    """One frame's compact colors from both packages, on the JAX
    renderer's view (guard-adjacent weights zeroed in both) and lights."""
    radius = float(p.beam_radius) if algorithm is JAlgorithm.BEAM else None
    jview, tview = _masked_views(rj._view, rj.lights, radius)
    want = np.asarray(jcolor.shade_view_compact(
        rj.grid, jview, rj.params, rj.lights, algorithm,
        dataclasses.replace(c, gather_impl="vpu_interpret")))
    got = tcolor.shade_view_compact(
        convert.grid_from_numpy(g), tview, convert.params_from_numpy(p),
        convert.lights_from_numpy(rj.lights), vt.Algorithm[algorithm.name],
        port_config(c)).numpy()
    assert np.count_nonzero(want) > 100
    return got, want


@pytest.mark.parametrize("mode,tier", VARIANTS,
                         ids=["-".join(v) for v in VARIANTS])
@pytest.mark.parametrize("algorithm", ALGOS, ids=["ray", "beam"])
def test_shading_with_carried_lights_matches_jax(algorithm, mode, tier):
    """rtol 2e-5 per lane, the kernels' own bound."""
    g, p, c = small_scene(mode, tier)
    rj = jax_renderer(g, p, c, algorithm)
    rj.step(1)
    got, want = shade_both(rj, g, p, c, algorithm)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)


@pytest.mark.parametrize("algorithm", ALGOS, ids=["ray", "beam"])
def test_discrete_expanded_matches_jax(algorithm):
    """segment_mode="discrete_expanded" at a capacity the lane gather takes
    (<= 2048): the compacted expansion through the point/sphere gather,
    against the JAX Renderer (frames) and with carried lights (shading)."""
    g, p, c = small_scene("discrete_expanded", "exact")
    c = dataclasses.replace(c, expanded_light_capacity=2048,
                            max_points_per_segment=32)
    rj = jax_renderer(g, p, c, algorithm)
    rt = port_renderer(g, p, c, algorithm)
    rj.step(2)
    rt.step(2)
    got, want = rt.image(), np.asarray(rj.image())
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL[algorithm])
    got, want = shade_both(rj, g, p, c, algorithm)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
