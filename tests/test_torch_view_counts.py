"""The view counts and the load spans of ``utils.profiling``: a host-banded
build counts itself and each band it builds; each frame over its view
counts the samples the gather reads (the bands' ``lane_need``) and the
plane samples the view holds; the build's host waits stay three; the
device build counts neither; ``Renderer.host_syncs`` a frame is the same
with the recorder on; ``grid.load`` is a span over the file's read, the
bricking and the upload.  This file imports no JAX."""

from __future__ import annotations

import numpy as np
import pytest

import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.render import color
from volumerenderer_tpu_torch.utils import profiling


@pytest.fixture
def fresh(monkeypatch):
    """A fresh recorder for the test, off."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


def _scene():
    rs = np.random.RandomState(11)
    vals = ((rs.rand(24, 20, 28) < 0.6) * rs.rand(24, 20, 28)).astype(
        np.float32)
    g = vt.grid.from_dense(vals, voxel_size=1.0,
                           translation=(-12.0, -10.0, -14.0), device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -40.0), light_source_world_pos=(0.0, 0.0, 0.0))
    return g, params


def _renderer(build="host", algorithm="POINT"):
    g, params = _scene()
    r = vt.Renderer(g, vt.StaticConfig(width=48, height=32,
                                       compact_build=build),
                    params, algorithm=vt.Algorithm[algorithm])
    r.view_build_budget_bytes = 1  # one band a TILE_L of lanes
    return r


def _view_counts():
    return {site: n for (kind, site), n in profiling.totals().items()
            if kind == "view"}


@pytest.mark.parametrize("algorithm", ["POINT", "RAY"])
def test_host_build_counts_its_bands_and_each_frames_samples(fresh,
                                                             algorithm):
    r = _renderer(algorithm=algorithm)
    r.step(1)
    view = r._view
    assert len(view.bands) >= 2 and view.caps
    live = sum(int(b.lane_need.sum()) for b in view.bands)
    held = sum(b.weight.shape[0] * b.weight.shape[1] for b in view.bands)
    assert view.live == live and view.held == held
    assert 0 < live < held
    assert _view_counts() == {
        "color.build.host": 1, "color.build.band": len(view.bands),
        "color.shade.live": live, "color.shade.held": held}
    # A batch of frames over the same view: one count of each a frame, no
    # new build.
    r.step(8)
    assert _view_counts() == {
        "color.build.host": 1, "color.build.band": len(view.bands),
        "color.shade.live": 9 * live, "color.shade.held": 9 * held}


def test_host_build_waits_three_times(fresh):
    """The counts' read, one copy of the lane order and the inverse map,
    and the read of the live samples (besides the camera rays' copies)."""
    r = _renderer()
    clip_box, steps = r._occupied_clip()
    before = profiling.totals()
    color.build_compact_view(
        r.grid, r.params, r.config, min(r._max_steps, steps),
        clip_box=clip_box, march_cell=r._march_cell(),
        device_budget_bytes=r.device_view_budget_bytes,
        band_budget_bytes=r.view_build_budget_bytes)
    got = {site: n - before.get((kind, site), 0)
           for (kind, site), n in profiling.totals().items()
           if kind == "sync" and site.startswith("color.build")}
    assert got == {"color.build": 1, "color.build.upload": 1,
                   "color.build.live": 1}


def test_device_build_counts_no_view_samples(fresh):
    r = _renderer(build="device")
    r.step(2)
    assert r._view.live is None and not r._view.caps
    assert _view_counts() == {}


def test_each_build_is_one_build_span(fresh):
    """The host-banded build, the device build and one row chunk of a
    settle are each one "color.build" span, none nested in another (the
    per-layer readers sum the spans of that name)."""
    def build_spans():
        return [s.name for s in profiling.drain()["spans"]
                if s.name == "color.build"]

    profiling.record(True)
    for build in ("host", "device"):
        r = _renderer(build=build)
        profiling.drain()
        r.step(1)
        assert build_spans() == ["color.build"], build
        assert bool(r._view.caps) == (build == "host")
    g, params = _scene()
    r = vt.Renderer(g, vt.StaticConfig(width=48, height=32,
                                       motion_mode="coarse", settle_chunks=2),
                    params, algorithm=vt.Algorithm.POINT)
    r.step(1)
    r.set(camera_pos=(1.0, 0.0, -40.0))
    r.step(1)  # a drag frame: the coarse uncached step, no build
    profiling.drain()
    r.step(1)  # the settle's first row chunk
    profiling.record(False)
    assert build_spans() == ["color.build"]
    assert len(r._settle["views"]) == 1 and not r.view_exact


@pytest.mark.parametrize("build", ["host", "device"])
def test_host_syncs_a_frame_unchanged_with_recording_on(fresh, build):
    syncs = []
    for on in (False, True):
        profiling.record(on)
        r = _renderer(build=build)
        r.step(1)
        r.image()
        first = r.host_syncs
        r.step(8)
        r.image()
        syncs.append((first, r.host_syncs - first))
        profiling.drain()
    profiling.record(False)
    assert syncs[0] == syncs[1]


def test_load_spans_the_read_the_bricking_and_the_upload(fresh, tmp_path):
    g, _ = _scene()
    path = tmp_path / "scene.vdb"
    vt.grid.save_vdb(g, str(path), compression="blosc+mask")
    profiling.record(True)
    loaded = vt.grid.load(str(path), device="cpu")
    profiling.record(False)
    spans = profiling.drain()["spans"]
    (load,) = [s for s in spans if s.name == "grid.load"]
    children = sorted((s for s in spans if s.parent == load.id),
                      key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["grid.load.read",
                                          "grid.load.brick",
                                          "grid.load.upload"]
    for s in children:
        assert load.start_ns <= s.start_ns <= s.end_ns <= load.end_ns
    np.testing.assert_array_equal(loaded.voxels.numpy(), g.voxels.numpy())
