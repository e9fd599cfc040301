"""The port's compact-view build against the JAX package's device build
(CPU): lane order, inverse map and per-lane need equal; within each
lane's need, weights at rtol 1e-6 and positions within 1e-5 world units."""

import numpy as np
import pytest

from test_engine import small_renderer
from test_goldens import scene
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm, Renderer
from volumerenderer_tpu.engine.step import build_compact_view_device_step
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import color as tcolor


def _jax_renderer(which):
    if which == "golden":
        g, p, c = scene()
        return Renderer(g, c, p, algorithm=Algorithm.POINT)
    return small_renderer(algorithm=Algorithm.POINT)


@pytest.mark.parametrize("band_lanes", [512 * 1024, 1024],
                         ids=["one_band", "bands_1024"])
@pytest.mark.parametrize("which", ["golden", "small"])
def test_build_compact_view_device_matches_jax(which, band_lanes):
    rj = _jax_renderer(which)
    g, p, c = rj.grid, rj.params, rj.config
    box, view_steps = rj._occupied_clip()
    steps = min(rj._max_steps, view_steps)
    vj = build_compact_view_device_step(
        g, p, box, config=c, steps=steps, march_cell=8, band_lanes=band_lanes)
    vt = tcolor.build_compact_view_device(
        convert.grid_from_numpy(g), convert.params_from_numpy(p),
        port_config(c), steps, clip_box=box, march_cell=8,
        band_lanes=band_lanes)
    assert (vt.n_rays, vt.rows) == (vj.n_rays, vj.rows)
    np.testing.assert_array_equal(vt.inv_map.numpy(), np.asarray(vj.inv_map))
    np.testing.assert_array_equal(vt.src.numpy(), np.asarray(vj.src))
    assert len(vt.bands) == len(vj.bands)
    total_need = 0
    for bt, bj in zip(vt.bands, vj.bands):
        need = bt.lane_need.numpy()
        np.testing.assert_array_equal(need, np.asarray(bj.lane_need))
        C = bt.wx.shape[0]
        assert C >= need.max(initial=0)
        use = np.arange(C)[:, None] < need[None, :]
        for name in ("wx", "wy", "wz", "weight"):
            got = np.where(use, getattr(bt, name).numpy(), 0.0)
            want = np.where(use, np.asarray(getattr(bj, name))[:C], 0.0)
            if name == "weight":
                # The transmittance cumprod associates differently.
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=name)
            else:
                # World positions: XLA:CPU contracts the unpinned o + d*t
                # into an FMA where the port rounds d*t first: the index
                # position moves by 1 ulp (<= 4e-6 voxels here), the world
                # position by <= 1e-5 (voxels of <= 1.5 world units).
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=name)
        total_need += int(need.sum())
    assert total_need > 0
