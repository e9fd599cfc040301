"""The rank side of the port's sharding tests, and the tests of
volumerenderer_tpu_torch.parallel that need no JAX.

``run_cases`` runs in every rank of one 8-rank world, started once per
module by tests/test_torch_sharding.py: it renders each case of
tests/test_sharding.py through the port's parallel package and rank 0
writes the whole frames to an .npz for the test process to hold against
the JAX package and the port's single-device Renderer.  Spawned ranks
import this module, so it imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.engine.state import RenderState
from volumerenderer_tpu_torch.grid import procedural
from volumerenderer_tpu_torch.parallel import launch, sharding
from volumerenderer_tpu_torch.render.color import (CompactView, ViewCache,
                                                   required_march_steps)

ALGORITHMS = ("POINT", "SPHERE", "RAY", "BEAM", "PATH")
MOVED = (2.0, 1.0, -16.0)  # the coarse-motion case's drag
REBAKED = (4.0, 2.0, -18.0)  # the re-bake case's camera


def scene():
    """tests/test_sharding.py's scene in the port (the grid bit for bit)."""
    g = procedural.fog_sphere(n=24, center_world=(0.0, 0.0, 10.0),
                              world_extent=20.0, device="cpu")
    params = vt.RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -15.0), light_source_world_pos=(0.0, 0.0, 10.0),
        scattering_probability=0.4, ray_max_distance=60.0, max_lights=64)
    config = vt.StaticConfig(width=16, height=16, light_capacity=64,
                             max_events_per_photon=8, probe_tile=64,
                             build_tile=64, max_points_per_segment=32,
                             max_path_segments=8)
    return g, params, config


def coarse_config(config):
    """The coarse-motion case's config: settle_chunks=0 settles blocking,
    as MeshRenderer does."""
    return dataclasses.replace(config, motion_mode="coarse", motion_stride=4,
                               settle_chunks=0)


def stride_config(config):
    return dataclasses.replace(config, gather_stride=2, gather_eval="paired")


def _image(mr) -> np.ndarray:
    return mr.image()[..., 0]


def run_cases(out_path: str) -> None:
    """Every case on this rank; rank 0 saves the frames to ``out_path``."""
    g, params, config = scene()
    steps = required_march_steps(g, 1.0, config.max_march_steps)
    rows8 = sharding.make_mesh(1, device="cpu")  # (8, 1)
    mesh24 = sharding.make_mesh(4, device="cpu")  # (2, 4)
    algo = vt.Algorithm
    out = {}

    def fresh(mesh):
        return RenderState(sharding.shard_rows(
            mesh, torch.zeros((config.height, config.width))), 0)

    for name in ALGORITHMS:
        state = fresh(rows8)
        for _ in range(2):
            state = sharding.sharded_render_step(
                g, params, state, algorithm=algo[name], config=config,
                max_steps=steps, mesh=rows8)
        out[f"row_{name}"] = sharding.gather_rows(rows8, state.accum).numpy()
    for name in ALGORITHMS[:4]:
        frame = sharding.light_sharded_radiance(
            g, params, fresh(mesh24), algorithm=algo[name], config=config,
            max_steps=steps, mesh=mesh24)
        out[f"light_{name}"] = sharding.gather_rows(mesh24, frame).numpy()

    try:
        sharding.make_mesh(3, device="cpu")
    except ValueError:
        out["mesh_validation"] = np.array(True)

    for lights_axis, mesh in ((1, rows8), (4, mesh24)):
        mr = sharding.MeshRenderer(g, mesh, config, params, algo.POINT)
        mr.step(2)
        out[f"cached_{lights_axis}"] = _image(mr)
        out[f"cached_{lights_axis}_compact"] = np.array(
            mr._use_compact and isinstance(mr._view, CompactView)
            and mr.state.frame_count == 2)

    slots = dataclasses.replace(config, compact_view=False)
    for lights_axis, mesh in ((1, rows8), (4, mesh24)):
        mr = sharding.MeshRenderer(g, mesh, slots, params, algo.RAY)
        mr.step(2)
        out[f"slots_{lights_axis}"] = _image(mr)
        out[f"slots_{lights_axis}_view"] = np.array(
            isinstance(mr._view, ViewCache))

    mr = sharding.MeshRenderer(g, rows8, config, params, algo.PATH)
    mr.step(2)
    out["path_cached"] = _image(mr)
    out["path_cached_baked"] = np.array(mr._path_view is not None)
    # A band's PathView over the Renderer's budget: the uncached frames.
    budget = vt.Renderer.path_cache_budget_bytes
    vt.Renderer.path_cache_budget_bytes = 0
    try:
        mr = sharding.MeshRenderer(g, rows8, config, params, algo.PATH)
        mr.step(2)
    finally:
        vt.Renderer.path_cache_budget_bytes = budget
    out["path_uncached"] = _image(mr)
    out["path_uncached_unbaked"] = np.array(mr._path_view is None)

    per_frame = sharding.MeshRenderer(g, rows8, config, params, algo.POINT)
    per_frame.frame_batch = 1
    per_frame.step(8)
    batched = sharding.MeshRenderer(g, rows8, config, params, algo.POINT)
    batched.step(8)
    out["per_frame"], out["batched"] = _image(per_frame), _image(batched)
    out["batched_frames"] = np.array(batched.state.frame_count)

    moved = params.replace(camera_pos=MOVED)
    for name in ALGORITHMS:
        mr = sharding.MeshRenderer(g, rows8, coarse_config(config), params,
                                   algo[name])
        for i in range(3):
            if i == 1:
                mr.params = moved
            mr.step(1)
            out[f"coarse_{name}_{i}"] = _image(mr)
        out[f"coarse_{name}_settled"] = np.array(
            (mr._path_view if name == "PATH" else mr._view) is not None)

    try:
        sharding.MeshRenderer(
            g, rows8, dataclasses.replace(config, motion_mode="truncated"),
            params, algo.POINT)
    except ValueError as e:
        out["truncated_refused"] = np.array("coarse" in str(e))

    rebaked = params.replace(camera_pos=REBAKED)
    mr = sharding.MeshRenderer(g, rows8, config, params, algo.POINT)
    mr.step(1)
    fresh_mr = sharding.MeshRenderer(g, rows8, config, rebaked, algo.POINT)
    fresh_mr.step(1)
    mr.params = rebaked
    mr.state = mr.state.refresh()
    mr.step(1)
    out["rebake"], out["rebake_fresh"] = _image(mr), _image(fresh_mr)

    mr = sharding.MeshRenderer(g, rows8, stride_config(config), params,
                               algo.POINT)
    mr.step(2)
    out["stride"] = _image(mr)

    if dist.get_rank() == 0:
        np.savez(out_path, **out)


def test_dryrun_multichip_on_cpu():
    """The dry run on 8 gloo ranks: (4, 2) mesh, row-sharded and
    light-sharded frames, BEAM's per-shard expansion, cached POINT and
    PATH sessions, all finite."""
    launch.dryrun_multichip(8, device="cpu")


def _fail_on_rank_one(path: str) -> None:
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()  # rank 0 waits for rank 1, which never arrives
    open(path, "w").close()


def test_launch_raises_when_a_rank_fails(tmp_path):
    """Rank 1 raises: launch raises the first rank's error to fail (rank 1's
    own, or rank 0's broken barrier) and rank 0 never finishes."""
    path = tmp_path / "rank0_finished"
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        launch.launch(_fail_on_rank_one, 2, str(path), device="cpu")
    assert not path.exists()


def test_entry_points_raise_without_cuda():
    """The entry points default to the card and never carry on on the
    CPU without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.dryrun_multichip(2)


def _nccl_world_of_one(path: str) -> None:
    g, params, config = scene()
    g = g.to("cuda")
    mesh = sharding.make_mesh(device="cuda")
    mr = sharding.MeshRenderer(g, mesh, config, params, vt.Algorithm.POINT)
    mr.step(2)
    r = vt.Renderer(g, config, params, algorithm=vt.Algorithm.POINT)
    r.step(2)
    np.savez(path, mesh=mr.image(), single=r.image(),
             backend=np.array(dist.get_backend()))


@pytest.mark.gpu
def test_nccl_world_of_one_matches_renderer(tmp_path):
    """One rank under NCCL on the card: the MeshRenderer's frames equal
    the single-device Renderer's (the same view, kernels and sums: the
    compact batch of one frame against the image-space frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (NCCL)")
    path = str(tmp_path / "world1.npz")
    launch.launch(_nccl_world_of_one, 1, path, device="cuda")
    got = np.load(path)
    assert str(got["backend"]) == "nccl"
    np.testing.assert_allclose(got["mesh"], got["single"], rtol=1e-6, atol=0)
    assert got["mesh"].max() > 0
