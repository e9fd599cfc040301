"""The many-light paths through the whole port (CPU): Ray/Beam with
``segment_mode="discrete_expanded"`` at the default 16,384 compacted
sub-light slots and Point/Sphere at ``light_capacity`` 4096, both above
SMEM_LIGHT_LIMIT, so every frame shades through the many-light gather.

Frames are held to the JAX Renderer with ``gather_impl="xla"`` (its oracle
route, which takes d^2 by direct differences as the port does) at the
slices' FRAME_ATOL.  The JAX package's own many-light route, the MXU kernel
in interpret mode, carries the matmul form's error (PARITY #8): on these
scenes and frames it is up to 2.8e-3 absolute in BEAM frames (1.6e-5 RAY,
2.1e-5 POINT, 6.8e-5 SPHERE; scripts/port_many_deviations.py), so against
it the shading of identical views and lights is held per lane at the JAX
suite's rtol 2e-3 / atol 1e-5, and at rtol 2e-5 against the oracle."""

import dataclasses

import numpy as np
import pytest

from test_engine import small_renderer
from test_goldens import scene
from test_torch_motion import close
from test_torch_photon import port_config
from test_torch_shading_segments import _masked_views
from test_torch_slice_segments import small_scene
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
from volumerenderer_tpu.render import color as jcolor
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.ops.kernels import gather_many as tmany
from volumerenderer_tpu_torch.ops.lights import SMEM_LIGHT_LIMIT
from volumerenderer_tpu_torch.render import color as tcolor

ALGOS = [JAlgorithm.RAY, JAlgorithm.BEAM, JAlgorithm.POINT,
         JAlgorithm.SPHERE]
IDS = ["ray", "beam", "point", "sphere"]
# As test_torch_slice_segments.FRAME_ATOL (Ray, Beam) and
# test_torch_slice.py (Point, Sphere): the photon walks' ulps.
FRAME_ATOL = {JAlgorithm.RAY: 2e-5, JAlgorithm.BEAM: 1e-3,
              JAlgorithm.POINT: 5e-5, JAlgorithm.SPHERE: 5e-5}
POINT_CAPACITY = 4096


def many_scene(algorithm, compact_view=True):
    """The 32x32 golden scene: discrete_expanded at the default capacity
    for Ray/Beam, 4096 light slots for Point/Sphere."""
    if algorithm in (JAlgorithm.RAY, JAlgorithm.BEAM):
        g, p, c = small_scene("discrete_expanded", "exact")
        assert c.expanded_light_capacity == 16384 > SMEM_LIGHT_LIMIT
    else:
        g, p, c = scene()
        c = dataclasses.replace(c, width=32, height=32,
                                light_capacity=POINT_CAPACITY)
    return g, p, dataclasses.replace(c, compact_view=compact_view)


def renderers(algorithm, g, p, c, impl="xla"):
    rj = JRenderer(g, dataclasses.replace(c, gather_impl=impl), p,
                   algorithm=algorithm)
    rt = vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                     convert.params_from_numpy(p),
                     algorithm=vt.Algorithm[algorithm.name])
    return rj, rt


@pytest.mark.parametrize("compact_view", [True, False],
                         ids=["compact", "slots"])
@pytest.mark.parametrize("algorithm", ALGOS, ids=IDS)
def test_renderer_matches_jax_renderer(algorithm, compact_view):
    """step(1), then step(3) with a frame batch of 3 (one batch of walks),
    each image against the JAX Renderer's; every frame launches no kernel
    on the CPU and shades through the many-light route."""
    g, p, c = many_scene(algorithm, compact_view)
    rj, rt = renderers(algorithm, g, p, c)
    rj.frame_batch = rt.frame_batch = 3
    for n in (1, 3):
        rj.step(n)
        rt.step(n)
        assert rt.state.frame_count == int(rj.state.frame_count)
        got, want = rt.image(), np.asarray(rj.image())
        assert got.shape == want.shape and np.isfinite(got).all()
        assert got.max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FRAME_ATOL[algorithm])
    assert tmany.launches["many"] == 0


@pytest.mark.parametrize("impl", ["xla", "mxu_interpret"])
@pytest.mark.parametrize("algorithm", ALGOS, ids=IDS)
def test_shading_with_carried_lights_matches_jax(algorithm, impl):
    """One frame's compact colors from both packages on the JAX renderer's
    view (weights near a guard surface zeroed in both) and lights: rtol
    2e-5 per lane against the oracle route, the JAX suite's rtol 2e-3 /
    atol 1e-5 against the MXU kernel."""
    g, p, c = many_scene(algorithm)
    rj, _ = renderers(algorithm, g, p, c, impl)
    rj.step(1)
    sphere = algorithm in (JAlgorithm.BEAM, JAlgorithm.SPHERE)
    jview, tview = _masked_views(rj._view, rj.lights,
                                 float(p.beam_radius) if sphere else None)
    want = np.asarray(jcolor.shade_view_compact(
        rj.grid, jview, rj.params, rj.lights, algorithm,
        dataclasses.replace(c, gather_impl=impl)))
    got = tcolor.shade_view_compact(
        convert.grid_from_numpy(g), tview, convert.params_from_numpy(p),
        convert.lights_from_numpy(rj.lights), vt.Algorithm[algorithm.name],
        port_config(c)).numpy()
    assert np.count_nonzero(want) > 100
    if impl == "xla":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


def test_coarse_drag_and_settle_with_discrete_expanded():
    """RAY discrete_expanded at 16,384 slots in the interactive viewer's
    setup: a coarse drag frame (the slots layout) and the four settle
    ticks (coarse frames, then the merged lane view), each against the
    JAX session."""
    rj = small_renderer(algorithm=JAlgorithm.RAY)
    rj.config = dataclasses.replace(
        rj.config, gather_impl="xla", segment_mode="discrete_expanded",
        motion_mode="coarse", motion_stride=4, settle_chunks=4)
    assert rj.config.expanded_light_capacity > SMEM_LIGHT_LIMIT
    rt = vt.Renderer(convert.grid_from_numpy(rj.grid), port_config(rj.config),
                     convert.params_from_numpy(rj.params),
                     algorithm=vt.Algorithm.RAY)
    for r in (rj, rt):
        r.step(1)
    close(rj, rt, JAlgorithm.RAY)
    for r in (rj, rt):
        r.set(camera_pos=np.float32([0.0, 1.5, -15.0]))
        r.step(1)
    assert not rt.view_exact
    close(rj, rt, JAlgorithm.RAY)
    for tick in range(4):
        for r in (rj, rt):
            r.step(1)
        assert rt.view_exact == (tick == 3)
        close(rj, rt, JAlgorithm.RAY)
    assert len(rt._view.bands) == 4
