"""Ray/VRL and Beam/VBL through the whole port (CPU): the port's Renderer
against the JAX package's Renderer, carrying lights across, the segment
options, and the UI semantics of switching to them.  The shading of
identical views and lights is in test_torch_shading_segments.py."""

import dataclasses

import numpy as np
import pytest

from test_goldens import scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import Renderer as JRenderer
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert

ALGOS = [JAlgorithm.RAY, JAlgorithm.BEAM]
# (segment_mode, segment_eval): analytic is the closed-form VRL for RAY and
# the closed-rule VBL for BEAM.
VARIANTS = [("discrete", "exact"), ("discrete", "paired"),
            ("analytic", "paired")]
# Whole frames against the JAX Renderer, absolute (image max 1): the photon
# walk's light positions differ by up to ~1e-4 world units between the
# packages (random_dir's acos/sin/cos ulps, CHANGES.md), which moves every
# sub-light.  Ray's 1/d^2 keeps that small (measured <= 1.9e-6 here, 1e-5
# at 64x64); Beam's 1/(d-r)^2 amplifies it for samples near a beam's
# surface (measured <= 2.4e-4 here; 4.8e-4 discrete and 7e-4 midpoint
# quadrature on the golden scene at 64x64).
FRAME_ATOL = {JAlgorithm.RAY: 2e-5, JAlgorithm.BEAM: 1e-3}


def small_scene(mode, tier, size=32):
    g, p, c = scene()
    c = dataclasses.replace(c, width=size, height=size, segment_mode=mode,
                            segment_eval=tier, beam_quadrature_rule="closed")
    return g, p, c


def jax_renderer(g, p, c, algorithm):
    return JRenderer(g, dataclasses.replace(c, gather_impl="vpu_interpret"),
                     p, algorithm=algorithm)


def port_renderer(g, p, c, algorithm):
    return vt.Renderer(convert.grid_from_numpy(g), port_config(c),
                       convert.params_from_numpy(p),
                       algorithm=vt.Algorithm[algorithm.name])


@pytest.mark.parametrize("steps", [(2,), (3, 1)], ids=["single", "batch"])
@pytest.mark.parametrize("mode,tier", VARIANTS,
                         ids=["-".join(v) for v in VARIANTS])
@pytest.mark.parametrize("algorithm", ALGOS, ids=["ray", "beam"])
def test_renderer_matches_jax_renderer(algorithm, mode, tier, steps):
    """step(2) runs two single frames; with a frame batch of 3, step(3)
    then step(1) runs one compact-space batch and one single frame."""
    g, p, c = small_scene(mode, tier)
    rj = jax_renderer(g, p, c, algorithm)
    rt = port_renderer(g, p, c, algorithm)
    rj.frame_batch = rt.frame_batch = 3
    for n in steps:
        rj.step(n)
        rt.step(n)
    assert rt.state.frame_count == int(rj.state.frame_count) == sum(steps)
    got, want = rt.image(), np.asarray(rj.image())
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL[algorithm])


def test_lights_from_numpy_round_trip():
    """One frame's JAX lights gain the port's frame axis; a batch keeps it."""
    g, p, c = small_scene("discrete", "exact")
    rj = jax_renderer(g, p, c, JAlgorithm.RAY)
    rj.step(1)
    lt = convert.lights_from_numpy(rj.lights)
    for name in ("pos_from", "pos_to", "intensity", "valid", "count",
                 "truncated"):
        got = getattr(lt, name)
        want = np.asarray(getattr(rj.lights, name))
        assert got.shape == (1,) + want.shape
        np.testing.assert_array_equal(got[0].numpy(), want)
    batch = {f: np.stack([np.asarray(getattr(rj.lights, f))] * 2)
             for f in ("pos_from", "pos_to", "intensity", "valid", "count",
                       "truncated")}
    assert convert.lights_from_numpy(batch).count.shape == (2,)


def test_discrete_expanded_over_capacity_raises():
    """discrete_expanded above 2048 slots raised until the many-light
    gather was ported: the default capacity (16,384) and a lane-gather one
    are now accepted; unknown values of the segment options still raise."""
    assert vt.StaticConfig(
        segment_mode="discrete_expanded").expanded_light_capacity == 16384
    vt.StaticConfig(segment_mode="discrete_expanded",
                    expanded_light_capacity=2048)
    for field, value in (("segment_mode", "expanded"),
                         ("segment_eval", "fast"),
                         ("beam_quadrature_rule", "simpson")):
        with pytest.raises(ValueError, match=field):
            vt.StaticConfig(**{field: value})


def test_set_algorithm_to_ray_and_beam_resets():
    """Switching to RAY or BEAM resets the accumulation; re-selecting the
    current algorithm does not (src/main.cpp:649-698)."""
    from volumerenderer_tpu_torch.grid import procedural

    g = procedural.fog_sphere(n=24, center_world=(0.0, 0.0, 10.0),
                              world_extent=20.0, device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -15.0), light_source_world_pos=(0.0, 0.0, 10.0),
        scattering_probability=0.4, ray_max_distance=60.0, max_lights=64)
    config = vt.StaticConfig(width=16, height=12, light_capacity=64,
                             max_events_per_photon=8, probe_tile=64,
                             build_tile=64)
    r = vt.Renderer(g, config, params, algorithm=vt.Algorithm.POINT)
    r.step(2)
    for algo in (vt.Algorithm.RAY, vt.Algorithm.BEAM):
        r.set_algorithm(algo)
        assert r.algorithm is algo and r.state.frame_count == 0
        r.step(2)
        assert r.state.frame_count == 2 and r.image().max() > 0
        r.set_algorithm(algo)  # same algorithm: no reset
        assert r.state.frame_count == 2
