"""The port's periphery on the CPU (modelled on tests/test_aux.py):
checkpoint and resume (within the port, and across the two packages'
files), the debug light views against the JAX package's, the viewer's
wiring under matplotlib's Agg backend, and the profiling helpers."""

import dataclasses
import glob
import json
import os

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import small_renderer as jax_small_renderer
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu import viewer as jviewer
from volumerenderer_tpu.io import checkpoint as jcheckpoint
from volumerenderer_tpu.render import debug_views as jdebug
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert, viewer
from volumerenderer_tpu_torch.io import checkpoint
from volumerenderer_tpu_torch.render import debug_views
from volumerenderer_tpu_torch.utils import profiling

# Whole frames against the JAX Renderer, absolute (image max ~1): the
# tolerances the slice tests hold each algorithm to (tests/
# test_torch_slice.py, test_torch_slice_segments.py).
FRAME_ATOL = {JAlgorithm.POINT: 5e-5, JAlgorithm.RAY: 2e-5}


def pair(algorithm):
    """tests/test_aux.py's small renderer in both packages."""
    rj = jax_small_renderer(algorithm=algorithm)
    rt = vt.Renderer(convert.grid_from_numpy(rj.grid),
                     port_config(rj.config),
                     convert.params_from_numpy(rj.params),
                     algorithm=vt.Algorithm[algorithm.name])
    return rj, rt


def small(algorithm=vt.Algorithm.POINT):
    return pair(JAlgorithm[algorithm.name])[1]


def test_checkpoint_resume_bit_identical(tmp_path):
    r1 = small(vt.Algorithm.POINT)
    r1.step(3)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save(r1, p)
    r1.step(2)
    want = r1.image()

    r2 = small(vt.Algorithm.RAY)  # another starting algorithm
    checkpoint.load(r2, p)
    assert r2.state.frame_count == 3
    assert r2.algorithm is vt.Algorithm.POINT
    r2.step(2)
    np.testing.assert_array_equal(r2.image(), want)


def test_checkpoint_shape_mismatch(tmp_path):
    r1 = small()
    r1.step()
    p = str(tmp_path / "c.npz")
    checkpoint.save(r1, p)
    r2 = small()
    r2.resize(8, 8)
    with pytest.raises(ValueError):
        checkpoint.load(r2, p)


def assert_params_equal(pt, pj):
    for f in dataclasses.fields(vt.RenderParams):
        np.testing.assert_array_equal(np.asarray(getattr(pt, f.name)),
                                      np.asarray(getattr(pj, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.RAY],
                         ids=["point", "ray"])
def test_checkpoint_across_packages(tmp_path, algorithm, writer):
    """A checkpoint written after step(3) by one package, with edited
    params, loads in the other: frame count, algorithm, params and the
    image equal; step(2) from it agrees with the writer's own step(2) at
    the slice tolerance."""
    rj, rt = pair(algorithm)
    edits = dict(absorption_coefficient=0.07, camera_pos=(0.0, 1.0, -15.0))
    rj.params = rj.params.replace(
        absorption_coefficient=jnp.float32(0.07),
        camera_pos=jnp.float32([0.0, 1.0, -15.0]))
    rt.set(**edits)
    src = rj if writer == "jax" else rt
    src.step(3)
    p = str(tmp_path / f"{writer}.npz")
    (jcheckpoint if writer == "jax" else checkpoint).save(src, p)
    other = pair(JAlgorithm.SPHERE)[0 if writer == "port" else 1]
    (checkpoint if writer == "jax" else jcheckpoint).load(other, p)
    assert int(other.state.frame_count) == 3
    assert other.algorithm.name == algorithm.name
    assert_params_equal(rt.params if writer == "port" else other.params,
                        rj.params if writer == "jax" else other.params)
    np.testing.assert_array_equal(np.asarray(other.image()),
                                  np.asarray(src.image()))
    src.step(2)
    other.step(2)
    got, want = np.asarray(other.image()), np.asarray(src.image())
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=FRAME_ATOL[algorithm])


@pytest.mark.parametrize("view", ["point", "ray"])
def test_debug_views_match_jax(view):
    """The same lights (the JAX walk's, converted) in both packages:
    equal images.  The widths are large enough to light pixels of the 16x12
    view; the ray view keeps the reference's end-point-as-direction
    quirk."""
    rj, _ = pair(JAlgorithm.POINT)
    rj.step()
    lights = convert.lights_from_numpy(rj.lights)
    pt = convert.params_from_numpy(rj.params)
    ct = port_config(rj.config)
    if view == "point":
        want = np.asarray(jdebug.view_point_lights(rj.params, rj.lights,
                                                   rj.config, radius=1.0))
        got = debug_views.view_point_lights(pt, lights, ct, radius=1.0)
    else:
        want = np.asarray(jdebug.view_ray_lights(rj.params, rj.lights,
                                                 rj.config, width=1.0))
        got = debug_views.view_ray_lights(pt, lights, ct, width=1.0)
    assert got.shape == (12, 16) and got.dtype == torch.float32
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_debug_views_of_renderer_lights():
    """Renderer.lights (the last frame stepped, one frame) feed the views
    directly; an invalid slot lights nothing."""
    r = small(vt.Algorithm.RAY)
    r.step(2)
    img = debug_views.view_point_lights(r.params, r.lights, r.config,
                                        radius=1.0)
    assert img.sum() > 0
    none = dataclasses.replace(r.lights, valid=torch.zeros_like(
        r.lights.valid))
    assert debug_views.view_ray_lights(r.params, none, r.config,
                                       width=1.0).sum() == 0


def test_render_offline_and_viewer_wiring(tmp_path):
    r = small(vt.Algorithm.POINT)
    seen = []
    out = viewer.render_offline(
        r, 2, str(tmp_path / "o.png"), callback=lambda i, im: seen.append(i))
    assert out.shape == (12, 16, 3) and seen == [1, 2]
    assert (tmp_path / "o.png").stat().st_size > 0
    viewer.render_offline(r, 1, str(tmp_path / "o.ppm"))
    assert (tmp_path / "o.ppm").stat().st_size > 0
    v = viewer.InteractiveViewer(r)
    assert r.config.motion_mode == "coarse" and r.first_frame_uncached
    assert v.SLIDERS == jviewer.InteractiveViewer.SLIDERS
    v.tick()
    assert r.state.frame_count == 4
    # A slider edit does not reset; Refresh does.
    v.sliders["absorption_coefficient"].set_val(0.3)
    assert r.state.frame_count == 4
    for comp in "xyz":
        assert f"camera_pos.{comp}" in v.sliders
        assert f"light_source_world_pos.{comp}" in v.sliders
    v.sliders["camera_pos.y"].set_val(25.0)
    np.testing.assert_allclose(r.params.camera_pos, [0.0, 25.0, -15.0])
    v.sliders["light_source_world_pos.x"].set_val(-10.0)
    assert float(r.params.light_source_world_pos[0]) == -10.0
    v.sliders["max_lights"].set_val(321)
    assert r.params.max_lights == 321
    assert r.state.frame_count == 4
    v.tick()  # a drag frame through the coarse path
    assert v.stats.fps > 0
    txt = v.fps_text.get_text()
    assert "fps" in txt and "Mrays/s" in txt and "frame 5" in txt
    assert "Mrays/s" in v.fig.canvas.manager.get_window_title()
    v.radio.set_active([a.name for a in vt.Algorithm].index("RAY"))
    assert r.algorithm is vt.Algorithm.RAY and r.state.frame_count == 0
    v.tick(2)
    assert r.state.frame_count == 2
    # Refresh through matplotlib's event pipeline (a click on the button).
    from matplotlib.backend_bases import MouseEvent

    v.fig.canvas.draw()
    bb = v.btn.ax.bbox
    x, y = (bb.x0 + bb.x1) / 2, (bb.y0 + bb.y1) / 2
    for name in ("button_press_event", "button_release_event"):
        v.fig.canvas.callbacks.process(name, MouseEvent(name, v.fig.canvas,
                                                        x, y, 1))
    assert r.state.frame_count == 0
    import matplotlib.pyplot as plt

    plt.close(v.fig)


def test_frame_stats():
    fs = profiling.FrameStats(window=2)
    fs.tick()
    assert fs.fps == 0.0
    for _ in range(4):
        fs.tick()
    assert len(fs._times) == 2 and fs.fps > 0
    assert fs.mrays_per_sec(100, 100) == pytest.approx(fs.fps * 0.01)


def test_device_memory_stats_on_cpu():
    """No CUDA here: the CPU reports no statistics."""
    assert not torch.cuda.is_available()
    assert profiling.device_memory_stats() == {"cpu": None}


def test_trace_writes_a_chrome_trace(tmp_path):
    """One frame under the profiler: a Chrome trace in log_dir that names
    the frame's operators."""
    r = small(vt.Algorithm.POINT)
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as prof:
        r.step(1)
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert files == [prof.trace_path]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
