"""Local rank worlds and the multi-device dry run (twin of
``dryrun_multichip`` in the reference package's ``__graft_entry__``).

``launch(fn, n, *args, device=...)`` starts ``n`` ranks on this host, one
process each (torch.multiprocessing, spawn), joined through a FileStore in
a temporary directory, and runs ``fn(*args)`` in every rank with the
default process group initialised: NCCL when every rank has a card of its
own, otherwise gloo (on the CPU, or ranks sharing cards).  ``fn`` must be
a module-level function of a module that spawned processes can import.
Any failing rank makes ``launch`` raise; the others are stopped.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..engine.params import Algorithm, RenderParams, StaticConfig
from ..engine.state import RenderState
from ..grid import procedural
from ..grid.dense import check_device
from ..render import color, photon
from . import sharding

# Bound on each collective of a local world.
TIMEOUT = datetime.timedelta(seconds=300)


def _backend(device: torch.device, n: int) -> str:
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, n, store, backend, fn, args):
    torch.set_num_threads(1)
    # Every rank of a local world is on this host: gloo's sockets take the
    # loopback interface.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=n, rank=rank,
        timeout=TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn, n: int, *args, device="cuda") -> None:
    """Run ``fn(*args)`` on ``n`` local ranks (see the module docstring)."""
    dev = check_device(device, "launch")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=n, args=(
            n, os.path.join(tmp, "store"), _backend(dev, n), fn, args))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """A multi-device frame on ``n_devices`` ranks: a row-sharded POINT
    frame; with an even count a (n / 2, 2) mesh whose light-sharded POINT
    and BEAM frames all-reduce over "lights", BEAM's sub-light expansion
    packing only each rank's shard; then a cached MeshRenderer POINT
    session and a PATH session, ``step(2)`` each.  Every image must be
    finite; any failing rank raises.  ``device="cpu"`` runs the ranks on
    the CPU under gloo."""
    launch(_dryrun_rank, n_devices, n_devices, str(device), device=device)


def _dryrun_scene(width: int, height: int, device):
    """The reference dry run's scene (a 32^3 fog sphere, 128 light slots)."""
    grid = procedural.fog_sphere(n=32, center_world=(0.0, 0.0, 10.0),
                                 world_extent=20.0, device=device)
    params = RenderParams.default().replace(
        camera_pos=(0.0, 0.0, -15.0), light_source_world_pos=(0.0, 0.0, 10.0),
        scattering_probability=0.3, ray_max_distance=60.0, max_lights=128)
    config = StaticConfig(width=width, height=height, light_capacity=128,
                          max_events_per_photon=16, max_points_per_segment=64,
                          max_path_segments=8)
    return grid, params, config


def _check_finite(what: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"dryrun: {what} is not finite")


def _dryrun_rank(n: int, device: str) -> None:
    lights_axis = 2 if n % 2 == 0 and n > 1 else 1
    mesh = sharding.make_mesh(lights_axis, device=device)
    dev = sharding.mesh_device(mesh)
    height = max(mesh.shape[0] * 8, 32)
    grid, params, config = _dryrun_scene(32, height, dev)
    steps = color.required_march_steps(grid, 1.0, config.max_march_steps)
    state = RenderState(sharding.shard_rows(
        mesh, torch.zeros((height, 32), dtype=torch.float32)), 0)

    state = sharding.sharded_render_step(
        grid, params, state, algorithm=Algorithm.POINT, config=config,
        max_steps=steps, mesh=mesh)
    full = sharding.gather_rows(mesh, state.accum)
    if tuple(full.shape) != (height, 32):
        raise AssertionError(f"dryrun: frame shape {tuple(full.shape)}")
    _check_finite("the row-sharded frame", full)

    if lights_axis > 1:
        for algo in (Algorithm.POINT, Algorithm.BEAM):
            _check_finite(f"the light-sharded {algo.name} frame",
                          sharding.light_sharded_radiance(
                              grid, params, state, algorithm=algo,
                              config=config, max_steps=steps, mesh=mesh))
        # Each rank expands only its shard's segments: the shards' packed
        # sub-lights add up to the whole frame's.
        expanded = dataclasses.replace(config,
                                       segment_mode="discrete_expanded")
        lights = photon.generate_lights(grid, params, [1], expanded,
                                        max_steps=steps)
        mine = sharding._light_shard(lights, mesh, expanded)
        counts = [color._expanded_lights(x, params, Algorithm.BEAM, expanded,
                                         0)[2].sum() for x in (mine, lights)]
        total = counts[0].clone()
        dist.all_reduce(total, group=mesh.get_group("lights"))
        if int(total) != int(counts[1]) or int(counts[1]) == 0:
            raise AssertionError(
                f"dryrun: the shards pack {int(total)} sub-lights, the frame "
                f"{int(counts[1])}")
        _check_finite("the light-sharded expanded BEAM frame",
                      sharding.light_sharded_radiance(
                          grid, params, state, algorithm=Algorithm.BEAM,
                          config=expanded, max_steps=steps, mesh=mesh))

    for algo in (Algorithm.POINT, Algorithm.PATH):
        mr = sharding.MeshRenderer(grid, mesh, config, params, algo)
        mr.step(2)
        _check_finite(f"the {algo.name} session's image",
                      torch.as_tensor(mr.image()))
