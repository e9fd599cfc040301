"""The port's PATH against itself: each exactness property of the
reference package's PATH (tests/test_path.py) held with array_equal, the
intensity gate, the light-term LUT, and both fidelities against the loopy
oracle (tests/reference_impl.render_path).  This file imports no JAX; its
`gpu` cases run on the card with

    python -m pytest tests/test_torch_path_exact.py -m gpu --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import reference_impl as ref
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.engine.params import Fidelity
from volumerenderer_tpu_torch.grid.dense import from_dense
from volumerenderer_tpu_torch.render import path
from volumerenderer_tpu_torch.render.color import required_march_steps
from volumerenderer_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread in this module: under pytest-xdist every
    worker would otherwise start a thread per core, and PATH's many small
    parallel ops then wait on descheduled threads (a golden-scene session
    took 330 s with six such processes on 8 cores, 2 s with one thread
    each).  The results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(fidelity=Fidelity.REFERENCE, device="cpu"):
    """tests/test_path.py make_scene, built by the port."""
    rs = np.random.RandomState(14)
    vals = (rs.rand(14, 14, 14) < 0.5) * (rs.rand(14, 14, 14) * 0.9 + 0.1)
    g = from_dense(vals.astype(np.float32), voxel_size=1.2,
                   translation=(-8.0, -8.0, 5.0), device=device)
    params = vt.RenderParams.default().replace(
        camera_pos=(0.3, -0.2, -13.0), fov=48.0,
        light_source_world_pos=(-2.0, 1.0, 11.0),
        scattering_probability=0.25, absorption_coefficient=0.15,
        ray_max_distance=60.0, ray_marching_step_size=0.77,
        photon_initial_intensity=200.0)
    config = vt.StaticConfig(width=10, height=8, max_path_segments=24,
                             fidelity=fidelity)
    return g, params, config


def bigger_scene(device="cpu", **cfg_kw):
    """tests/test_path.py _bigger_scene (32x24), built by the port."""
    rs = np.random.RandomState(3)
    vals = (rs.rand(20, 20, 20) < 0.4) * (rs.rand(20, 20, 20) * 0.9 + 0.1)
    g = from_dense(vals.astype(np.float32), voxel_size=1.0,
                   translation=(-10.0, -10.0, 4.0), device=device)
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -18.0), light_source_world_pos=(-3.0, 2.0, 10.0),
        scattering_probability=0.2, ray_max_distance=80.0)
    config = vt.StaticConfig(width=32, height=24, max_path_segments=6,
                             **cfg_kw)
    return g, params, config


def steps_of(g, params, config):
    return required_march_steps(g, params.ray_marching_step_size,
                                config.max_march_steps)


def render(g, params, config, frame_count=2, **kw):
    out = path.render_frame(g, params, frame_count, config,
                            steps_of(g, params, config), **kw)
    assert torch.isfinite(out).all()
    return out.cpu().numpy()


@pytest.mark.parametrize("prob", [0.2, 0.9])
def test_compaction_matches_full_width(prob):
    """The compacted walk (above path_compact_min rays) equals the full-
    width walk bit for bit; prob 0.9 keeps most rays alive to the end."""
    g, params, config = bigger_scene(path_compact_min=64, path_chunk=64)
    params = params.replace(scattering_probability=prob)
    full = dataclasses.replace(config, path_compact_min=1 << 30)
    compact = render(g, params, config)
    assert compact.max() > 0
    np.testing.assert_array_equal(compact, render(g, params, full))


@pytest.mark.parametrize("cell", [1, 4])
def test_sorted_chunks_are_exact(cell):
    """Cost-sorted compaction ("cells" and "span" keys) equals image-order
    compaction: grouping never changes a ray's arithmetic."""
    g, params, config = bigger_scene(path_compact_min=64, path_chunk=32)
    want = render(g, params, dataclasses.replace(config,
                                                 path_sort_chunks=False),
                  march_cell=cell)
    for key in ("cells", "span"):
        got = render(g, params, dataclasses.replace(config, path_sort_key=key),
                     march_cell=cell)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [32, 100, 4096])
def test_chunk_width_is_exact(chunk):
    """Any path_chunk gives the same frame (the last chunk is ragged at
    100)."""
    g, params, config = bigger_scene(path_compact_min=64)
    want = render(g, params, dataclasses.replace(config, path_chunk=65536))
    got = render(g, params, dataclasses.replace(config, path_chunk=chunk))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cell,subblock", [(2, 32), (4, 32), (4, 24)])
def test_occupied_cell_march_is_exact(cell, subblock):
    """Walking only occupied coarse cells equals the raw walk, compacted
    and full width; sub-block 24 leaves a ragged last cell block (11
    cells in blocks of 6)."""
    g, params, config = bigger_scene(path_compact_min=64)
    for cfg in (config, dataclasses.replace(config, path_compact_min=1 << 30)):
        raw = render(g, params, cfg, subblock=subblock)
        np.testing.assert_array_equal(
            render(g, params, cfg, march_cell=cell, subblock=subblock), raw)


def test_shadow_lut_is_exact():
    g, params, config = bigger_scene(path_compact_min=64)
    np.testing.assert_array_equal(render(g, params, config,
                                         shadow_lut_radius=1),
                                  render(g, params, config))


def test_lut_lookup_equals_gather():
    """The LUT lookup equals sample_nearest at 2,048 random probes within
    the radius of a light placed in an occupied voxel, and reads 0 outside
    the LUT."""
    g, _, _ = bigger_scene()
    occ = np.argwhere(g.voxels.numpy() > 0.05)
    light = torch.as_tensor(occ[len(occ) // 2], dtype=torch.float32) + 0.37
    base, vals = path._shadow_lut(g, light, 1)
    rs = np.random.RandomState(5)
    u = rs.randn(2048, 3)
    u = u / np.linalg.norm(u, axis=1, keepdims=True) * rs.rand(2048, 1)
    probe = light + torch.as_tensor(u, dtype=torch.float32)
    np.testing.assert_array_equal(
        path._lut_lookup(probe, base, vals, 1).numpy(),
        g.sample_nearest(probe).numpy())
    far = light + torch.tensor([[5.0, 0.0, 0.0]])
    assert float(path._lut_lookup(far, base, vals, 1)[0]) == 0.0


@pytest.mark.parametrize("fidelity", [Fidelity.REFERENCE, Fidelity.CORRECTED])
def test_cached_matches_inline(fidelity):
    """render_frame over a baked PathView equals the inline camera march,
    at one tile and at several (a small tile budget)."""
    g, params, config = bigger_scene(path_compact_min=64, fidelity=fidelity)
    S = steps_of(g, params, config)
    for tile_bytes in (path.TILE_BYTES, 8 * S * 96):
        cache = path.bake_path_view(g, params, config, S, shadow_lut_radius=1,
                                    tile_bytes=tile_bytes)
        assert cache.o_i.shape[0] == path.padded_rays(32 * 24, S, tile_bytes)
        for fc in (1, 4):
            inline = render(g, params, config, fc, shadow_lut_radius=1,
                            tile_bytes=tile_bytes)
            cached = render(g, params, config, fc, shadow_lut_radius=1,
                            cache=cache)
            np.testing.assert_array_equal(cached, inline)


def test_tiles_are_exact():
    """The bake and replay tiles change no bit of the frame."""
    g, params, config = bigger_scene(path_compact_min=64)
    S = steps_of(g, params, config)
    want = render(g, params, config, 3)
    np.testing.assert_array_equal(
        render(g, params, config, 3, tile_bytes=8 * S * 64), want)


def test_stride_tier_cached_matches_inline():
    """The path_stride tier's replay equals its inline render (light_step
    threads through bake, camera segment and walk)."""
    g, params, config = bigger_scene(path_compact_min=64)
    k, step = 2, params.ray_marching_step_size
    p_eff = params.replace(
        ray_marching_step_size=step * k,
        scattering_probability=1.0 - (1.0 - params.scattering_probability) ** k)
    S = required_march_steps(g, step * k, config.max_march_steps)
    cache = path.bake_path_view(g, p_eff, config, S, shadow_lut_radius=1,
                                light_step=step)
    for fc in (1, 3):
        kw = dict(shadow_lut_radius=1, light_step=step)
        inline = path.render_frame(g, p_eff, fc, config, S, **kw)
        cached = path.render_frame(g, p_eff, fc, config, S, cache=cache, **kw)
        np.testing.assert_array_equal(cached.numpy(), inline.numpy())
        assert torch.isfinite(inline).all() and inline.max() > 0


@pytest.mark.parametrize("compact_min", [64, 1 << 30])
def test_frame_batch_is_exact(compact_min):
    """render_frames (scatter segments of 3 frames walked together) equals
    render_frame per frame, compacted and full width."""
    g, params, config = bigger_scene(path_compact_min=compact_min,
                                     path_chunk=64)
    S = steps_of(g, params, config)
    cache = path.bake_path_view(g, params, config, S)
    batch = path.render_frames(g, params, [1, 2, 3], config, S, cache)
    assert batch.shape == (3, config.height, config.width)
    for i, fc in enumerate((1, 2, 3)):
        single = path.render_frame(g, params, fc, config, S, cache=cache)
        np.testing.assert_array_equal(batch[i].numpy(), single.numpy())


def test_row_band_matches_full_frame():
    """A band of rows (row_start != 0, compacted walk, seeds re-derived
    from the global row) equals the same rows of the full frame."""
    g, params, config = bigger_scene(path_compact_min=64)
    S = steps_of(g, params, config)
    full = path.render_frame(g, params, 2, config, S)
    band = path.render_frame(g, params, 2, config, S, row_start=8,
                             num_rows=12)
    cache = path.bake_path_view(g, params, config, S, row_start=8,
                                num_rows=12)
    cached = path.render_frame(g, params, 2, config, S, row_start=8,
                               num_rows=12, cache=cache)
    np.testing.assert_array_equal(band.numpy(), full[8:20].numpy())
    np.testing.assert_array_equal(cached.numpy(), band.numpy())


def test_constant_intensity_gate():
    """path_compute_color.comp:86: intensity <= 0.01 never runs the walk
    (the frame is black); just above the gate the frame renders."""
    g, params, config = small_scene()
    dead = params.replace(photon_initial_intensity=0.01)
    assert (render(g, dead, config) == 0.0).all()
    live = params.replace(photon_initial_intensity=0.02)
    assert render(g, live, config).max() > 0.0


@pytest.mark.parametrize("fidelity", [
    pytest.param(Fidelity.REFERENCE, marks=pytest.mark.slow),
    Fidelity.CORRECTED,
])
def test_matches_oracle(fidelity):
    """The loopy per-pixel oracle (tests/reference_impl.render_path) at
    the reference package's tolerance."""
    g, params, config = small_scene(fidelity)
    frame = render(g, params, config, 1)
    want = ref.render_path(g, params, 1, config.width, config.height,
                           max_segments=config.max_path_segments,
                           fidelity=fidelity.value)
    np.testing.assert_allclose(frame, want, rtol=5e-3, atol=5e-5)


def test_corrected_light_term_pieces_are_exact(monkeypatch):
    """The corrected light term marches its positions in pieces (bounded
    temporaries); many small pieces give the same frame."""
    g, params, config = small_scene(Fidelity.CORRECTED)
    want = render(g, params, config, 1)
    monkeypatch.setattr(path, "_CORRECTED_ELEMS", 4096)
    np.testing.assert_array_equal(render(g, params, config, 1), want)


def test_corrected_differs_from_reference():
    g, params, config = small_scene(Fidelity.CORRECTED)
    corrected = render(g, params, config, 1)
    reference = render(g, params, dataclasses.replace(
        config, fidelity=Fidelity.REFERENCE), 1)
    assert not np.allclose(corrected, reference)


def test_trace_counts_host_reads_and_marks_stages():
    """A frame's spans, in order: "path.replay", then per scatter segment
    "path.compact" and "path.walk"; one "sync" count a segment at
    "path.compact", and the walk's early-exit reads at "path.walk"."""
    g, params, config = bigger_scene(path_compact_min=64)
    profiling.drain()
    profiling.record(True)
    try:
        render(g, params, config)
    finally:
        profiling.record(False)
    got = profiling.drain()
    names = [s.name for s in sorted(got["spans"], key=lambda s: s.start_ns)]
    assert names[0] == "path.replay"
    segs = names.count("path.compact")
    assert 1 <= segs <= config.max_path_segments - 1
    assert names[1:3] == ["path.compact", "path.walk"]
    reads = {}
    for c in got["counts"]:
        reads[c.site] = reads.get(c.site, 0) + c.n
    assert reads["path.compact"] == segs
    # One alive count per segment walked plus the early-exit reads.
    assert reads["path.compact"] + reads.get("path.walk", 0) >= segs


def test_renderer_counts_path_host_reads_and_budget():
    """Renderer.host_syncs counts PATH's host reads; a view over
    path_cache_budget_bytes renders uncached with the same frames."""
    g, params, config = bigger_scene(path_compact_min=64)
    r = vt.Renderer(g, config, params, algorithm=vt.Algorithm.PATH)
    r.step(2)
    assert r.host_syncs > 2 and r._path_view is not None
    assert r.lights.count.tolist() == [0]
    S = steps_of(g, params, config)
    assert r._path_view.rank_k.shape == (path.padded_rays(768, S), S)
    ru = vt.Renderer(g, config, params, algorithm=vt.Algorithm.PATH)
    ru.path_cache_budget_bytes = path.view_bytes(path.padded_rays(768, S),
                                                 S) - 1
    ru.step(2)
    assert ru._path_view is None
    np.testing.assert_array_equal(ru.image(), r.image())


def test_first_frame_uncached_then_cached():
    """first_frame_uncached: frame 1 renders through the uncached step
    before the bake, frame 2 over the baked view; the image equals a
    session that bakes at once, bit for bit."""
    g, params, config = bigger_scene(path_compact_min=64)
    r = vt.Renderer(g, config, params, algorithm=vt.Algorithm.PATH)
    r.first_frame_uncached = True
    r.step(1)
    assert r._path_view is None and r.state.frame_count == 1
    r.step(1)
    assert r._path_view is not None
    ref_r = vt.Renderer(g, config, params, algorithm=vt.Algorithm.PATH)
    ref_r.step(2)
    np.testing.assert_array_equal(r.image(), ref_r.image())


@pytest.mark.gpu
def test_cuda_path_exactness():
    """On the card: cached equals inline, compacted equals full width and
    render_frames equals render_frame, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    g, params, config = bigger_scene(device="cuda", path_compact_min=64,
                                     path_chunk=64)
    S = steps_of(g, params, config)
    cache = path.bake_path_view(g, params, config, S, shadow_lut_radius=1)
    inline = render(g, params, config, 3, shadow_lut_radius=1, march_cell=8)
    full = render(g, params, dataclasses.replace(
        config, path_compact_min=1 << 30), 3, shadow_lut_radius=1,
        march_cell=8)
    np.testing.assert_array_equal(full, inline)
    batch = path.render_frames(g, params, [2, 3], config, S, cache,
                               shadow_lut_radius=1, march_cell=8)
    np.testing.assert_array_equal(batch[1].cpu().numpy(), inline)
    cached = render(g, params, config, 3, shadow_lut_radius=1, march_cell=8,
                    cache=cache)
    np.testing.assert_array_equal(cached, inline)
