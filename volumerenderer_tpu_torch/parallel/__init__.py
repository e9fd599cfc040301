"""Multi-device rendering over torch.distributed (twin of
volumerenderer_tpu.parallel): row bands and light shards on a
("rows", "lights") DeviceMesh, one process per rank; ``launch.launch``
starts a local world."""

from . import launch, sharding
from .launch import dryrun_multichip
from .sharding import MeshRenderer, make_mesh, sharded_render_step

__all__ = ["MeshRenderer", "dryrun_multichip", "launch", "make_mesh",
           "sharded_render_step", "sharding"]
