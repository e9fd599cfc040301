"""The interactive paths through the port (CPU): coarse and truncated drag
frames, the progressive settle and a re-drag, resize and grid swap not
being drags, and gather decimation, each against the JAX package's
session (frame by frame) or its own functions on carried-across views."""

import dataclasses

import numpy as np
import pytest

from test_engine import small_renderer
from test_torch_photon import port_config
from volumerenderer_tpu import Algorithm as JAlgorithm
from volumerenderer_tpu.render import color as jcolor
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import convert
from volumerenderer_tpu_torch.render import color as tcolor
from volumerenderer_tpu_torch.utils import profiling

# Frames against the JAX session, absolute (image max ~1): the photon
# walks' light positions differ by ulps between the packages
# (test_torch_slice.py: Point 5e-5); Beam's 1/(d-r)^2 amplifies them.
FRAME_ATOL = {JAlgorithm.POINT: 5e-5, JAlgorithm.SPHERE: 5e-5,
              JAlgorithm.RAY: 5e-5, JAlgorithm.BEAM: 1e-3}


def pair(algorithm=JAlgorithm.POINT, **cfg):
    """The JAX suite's small session and the port's copy of it, with the
    Pallas kernels in interpret mode on the JAX side."""
    rj = small_renderer(algorithm=algorithm)
    rj.config = dataclasses.replace(rj.config, gather_impl="vpu_interpret",
                                    **cfg)
    rt = vt.Renderer(convert.grid_from_numpy(rj.grid), port_config(rj.config),
                     convert.params_from_numpy(rj.params),
                     algorithm=vt.Algorithm[algorithm.name])
    return rj, rt


def both(rs, method, *args, **kw):
    for r in rs:
        getattr(r, method)(*args, **kw)


def close(rj, rt, algorithm=JAlgorithm.POINT):
    got, want = rt.image(), np.asarray(rj.image())
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FRAME_ATOL[algorithm])


@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.SPHERE,
                                       JAlgorithm.RAY, JAlgorithm.BEAM],
                         ids=["point", "sphere", "ray", "beam"])
def test_coarse_drag_matches_jax(algorithm):
    """motion_mode="coarse": drag frames march at motion_stride x the step
    (photon walk included) through the uncached step and leave the settled
    view alone; the first key-stable frame rebuilds exactly.  Every frame
    against the JAX session."""
    rj, rt = pair(algorithm, motion_mode="coarse", motion_stride=4,
                  settle_chunks=0)
    both((rj, rt), "step", 1)
    settled = rt._view
    for y in (1.0, 2.0):
        both((rj, rt), "set", camera_pos=np.float32([0.0, y, -15.0]))
        both((rj, rt), "step", 1)
        assert rt._view is settled and not rt.view_exact
        close(rj, rt, algorithm)
    both((rj, rt), "step", 1)  # key repeats: the exact rebuild
    assert rt._view is not settled and rt.view_exact
    close(rj, rt, algorithm)
    assert rt.state.frame_count == int(rj.state.frame_count) == 4


def test_truncated_drag_matches_jax():
    """motion_mode="truncated": drag frames shade the first motion_cap
    occupied samples of each ray through an identity-order build; then the
    settle rebuilds exactly."""
    rj, rt = pair(motion_mode="truncated", motion_cap=8)
    both((rj, rt), "step", 2)
    settled = rt._view
    for y in (1.0, 2.0, 3.0):
        both((rj, rt), "set", camera_pos=np.float32([0.0, y, -15.0]))
        both((rj, rt), "step", 1)
        assert rt._view is settled
        close(rj, rt)
    both((rj, rt), "step", 1)
    assert rt._view is not settled and rt.view_exact
    close(rj, rt)


def test_identity_order_build_matches_jax():
    """The truncated drag frame's build: lanes in ray order, every band at
    the cap, against the JAX device build with order="identity"."""
    from volumerenderer_tpu.engine.step import build_compact_view_device_step

    rj, _ = pair()
    box, view_steps = rj._occupied_clip()
    steps = min(8, view_steps)
    vj = build_compact_view_device_step(rj.grid, rj.params, box,
                                        config=rj.config, steps=steps,
                                        march_cell=8, order="identity")
    before = profiling.totals().get(("sync", "color.build"), 0)
    vt_ = tcolor.build_compact_view_device(
        convert.grid_from_numpy(rj.grid), convert.params_from_numpy(rj.params),
        port_config(rj.config), steps, clip_box=box, march_cell=8,
        order="identity")
    assert profiling.totals().get(("sync", "color.build"), 0) == before
    np.testing.assert_array_equal(vt_.inv_map.numpy(), np.asarray(vj.inv_map))
    np.testing.assert_array_equal(vt_.src.numpy(), np.asarray(vj.src))
    for bt, bj in zip(vt_.bands, vj.bands):
        need = bt.lane_need.numpy()
        np.testing.assert_array_equal(need, np.asarray(bj.lane_need))
        use = np.arange(bt.wx.shape[0])[:, None] < need[None, :]
        np.testing.assert_allclose(
            np.where(use, bt.weight.numpy(), 0),
            np.where(use, np.asarray(bj.weight)[:bt.wx.shape[0]], 0),
            rtol=1e-6, atol=0)


def test_progressive_settle_and_redrag():
    """settle_chunks=4, coarse: the settle builds one row chunk per tick
    with coarse frames in between, a re-drag drops the partial chunks, the
    landing tick shades the merged exact view (one band per chunk), and a
    fresh accumulation over it matches a blocking rebuild to rtol 2e-6.
    Each tick against the JAX session."""
    rj, rt = pair(motion_mode="coarse", motion_stride=4, settle_chunks=4)
    both((rj, rt), "step", 1)
    both((rj, rt), "set", camera_pos=np.float32([0.0, 1.5, -15.0]))
    both((rj, rt), "step", 1)  # drag frame
    assert rt._settle is None and not rt.view_exact
    fc0 = rt.state.frame_count
    for i in range(3):
        both((rj, rt), "step", 1)
        assert not rt.view_exact and len(rt._settle["views"]) == i + 1
        assert rt.state.frame_count == fc0 + 1 + i
        close(rj, rt)
    both((rj, rt), "set", camera_pos=np.float32([0.0, 2.5, -15.0]))
    both((rj, rt), "step", 1)  # re-drag: the partial settle is dropped
    assert rt._settle is None and not rt.view_exact
    close(rj, rt)
    for _ in range(3):
        both((rj, rt), "step", 1)
        assert not rt.view_exact
    both((rj, rt), "step", 1)
    assert rt.view_exact and rt._settle is None
    assert len(rt._view.bands) == 4
    close(rj, rt)
    rt.refresh()
    rt.step(1)
    _, rb = pair()
    rb.set(camera_pos=(0.0, 2.5, -15.0))
    rb.step(1)
    rb.refresh()
    rb.step(1)
    np.testing.assert_allclose(rt.state.accum.numpy(), rb.state.accum.numpy(),
                               rtol=2e-6, atol=1e-7)


def test_resize_and_grid_swap_are_not_drags():
    """resize() and a volume swap change the view key without being
    drags: a coarse-mode session matches a motion-off one bit for bit, and
    both match the JAX session."""
    from volumerenderer_tpu.grid import procedural as jprocedural
    from volumerenderer_tpu_torch.grid import procedural

    def run(mode):
        rj, rt = pair(motion_mode=mode, motion_stride=4)
        both((rj, rt), "step", 2)
        both((rj, rt), "resize", 20, 12)
        both((rj, rt), "step", 1)
        assert rt.view_exact
        close(rj, rt)
        a1 = rt.state.accum.numpy().copy()
        kw = dict(n=16, center_world=(0.0, 0.0, 10.0), world_extent=20.0)
        rj.grid = jprocedural.fog_sphere(**kw)
        rt.grid = procedural.fog_sphere(**kw, device="cpu")
        both((rj, rt), "refresh")
        both((rj, rt), "step", 1)
        assert rt.view_exact
        close(rj, rt)
        return a1, rt.state.accum.numpy()

    a1_off, a2_off = run("off")
    a1_co, a2_co = run("coarse")
    np.testing.assert_array_equal(a1_co, a1_off)
    np.testing.assert_array_equal(a2_co, a2_off)


@pytest.mark.parametrize("fold", ["centroid", "gauss2"])
@pytest.mark.parametrize("stride", [2, 3])
def test_decimate_view_matches_jax(stride, fold):
    """decimate_view on the JAX session's own CompactView, carried across:
    lane_need equal, and within each lane's need the weights at rtol 1e-6
    and positions within 1e-5 world units of the JAX fold."""
    rj, _ = pair()
    rj.step(1)
    vj = rj._view
    want = jcolor.decimate_view(vj, stride, fold=fold)
    got = tcolor.decimate_view(convert.compact_view_from_numpy(vj), stride,
                               fold=fold)
    for bt, bj in zip(got.bands, want.bands):
        need = bt.lane_need.numpy()
        np.testing.assert_array_equal(need, np.asarray(bj.lane_need))
        assert bt.wx.shape == np.asarray(bj.wx).shape
        assert bt.wx.shape[0] % 8 == 0 and bt.wx.is_contiguous()
        use = np.arange(bt.wx.shape[0])[:, None] < need[None, :]
        np.testing.assert_allclose(bt.weight.numpy()[use],
                                   np.asarray(bj.weight)[use], rtol=1e-6)
        for name in ("wx", "wy", "wz"):
            np.testing.assert_allclose(getattr(bt, name).numpy()[use],
                                       np.asarray(getattr(bj, name))[use],
                                       rtol=0, atol=1e-5, err_msg=name)
        # The fold keeps each lane's total weight (brightness).
        np.testing.assert_allclose(bt.weight.numpy().sum(0),
                                   np.asarray(vj.bands[0].weight).sum(0),
                                   rtol=2e-6, atol=1e-9)


@pytest.mark.parametrize("fold", ["centroid", "gauss2"])
@pytest.mark.parametrize("algorithm", [JAlgorithm.POINT, JAlgorithm.RAY],
                         ids=["point", "ray"])
def test_gather_stride_session_matches_jax(algorithm, fold):
    """gather_stride=2: the device build decimates its view; frames
    against the JAX session."""
    rj, rt = pair(algorithm, gather_stride=2, gather_fold=fold)
    both((rj, rt), "step", 2)
    for bt, bj in zip(rt._view.bands, rj._view.bands):
        np.testing.assert_array_equal(bt.lane_need.numpy(),
                                      np.asarray(bj.lane_need))
    close(rj, rt, algorithm)


def test_interactive_config_values_construct():
    """The interactive settings construct with the JAX package's defaults
    and names; an unknown fold is an error."""
    c = vt.StaticConfig(motion_mode="coarse", gather_stride=3,
                        gather_fold="gauss2", compact_view=False)
    assert (c.motion_cap, c.motion_stride, c.settle_chunks) == (16, 12, 4)
    vt.StaticConfig(motion_mode="truncated")
    with pytest.raises(ValueError, match="gather_fold"):
        vt.StaticConfig(gather_fold="gauss")
    with pytest.raises(ValueError, match="gather_stride"):
        vt.StaticConfig(gather_stride=0)
