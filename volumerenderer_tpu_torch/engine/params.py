"""Scene and render parameters (twin of volumerenderer_tpu.engine.params).

  * ``RenderParams`` — the UBO fields, held on the host: every scalar is a
    Python float rounded to f32 (so arithmetic on device tensors sees the
    reference package's f32 value), vectors are f32 numpy arrays.
  * ``StaticConfig`` — image size and every capacity that sizes an array,
    with the reference package's field names and defaults.

Values the port does not cover yet raise ``NotImplementedError`` naming
the ROADMAP item that will port them.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Algorithm(enum.IntEnum):
    """Algorithm ids, same order as the reference enum (src/main.cpp:65-68)."""

    BEAM = 0
    RAY = 1
    POINT = 2
    SPHERE = 3
    PATH = 4


# Algorithm -> the ROADMAP item that ports it; absent = ported.
UNPORTED_ALGORITHMS: dict = {}


def check_algorithm(algorithm: Algorithm) -> Algorithm:
    algorithm = Algorithm(algorithm)
    if algorithm in UNPORTED_ALGORITHMS:
        raise NotImplementedError(
            f"Algorithm.{algorithm.name} is not ported to PyTorch yet: "
            f"{UNPORTED_ALGORITHMS[algorithm]}"
        )
    return algorithm


class Fidelity(enum.Enum):
    """PATH single-light transmittance handling.

    REFERENCE reproduces path_compute_color.comp:9-31 literally, including
    the frozen march position (the loop attenuates N times by the density
    at one fixed point one step from the light).  CORRECTED marches the
    light->sample segment properly.
    """

    REFERENCE = "reference"
    CORRECTED = "corrected"


_VEC_FIELDS = ("camera_pos", "light_source_world_pos")


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """UBO fields (common_bindings.h:19-34), defaults from src/main.cpp:546-559."""

    camera_pos: np.ndarray = (0.0, 20.0, -75.0)
    # Extension: camera orientation (camera-space +z forward); identity
    # reproduces the reference's fixed +z look.
    camera_rotation: np.ndarray = None
    fov: float = 45.0  # degrees
    photon_initial_intensity: float = 100.0
    scattering_probability: float = 0.05
    absorption_coefficient: float = 0.05
    max_lights: int = 1000  # runtime cap (<= StaticConfig.light_capacity)
    ray_max_distance: float = 2500.0
    ray_marching_step_size: float = 1.0
    light_source_world_pos: np.ndarray = (-20.0, 15.0, -15.0)
    beam_radius: float = 0.1
    light_ray_step_size: float = 0.3
    radius_falloff: float = 0.5  # plumbed but unused, as in the reference

    def __post_init__(self):
        put = lambda k, v: object.__setattr__(self, k, v)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in _VEC_FIELDS:
                put(f.name, np.array(v, np.float32).reshape(3))
            elif f.name == "camera_rotation":
                put(f.name, np.eye(3, dtype=np.float32) if v is None
                    else np.array(v, np.float32).reshape(3, 3))
            elif f.name == "max_lights":
                put(f.name, int(np.asarray(v)))
            else:
                put(f.name, float(np.float32(np.asarray(v))))

    @classmethod
    def default(cls) -> "RenderParams":
        return cls()

    def replace(self, **fields) -> "RenderParams":
        return dataclasses.replace(self, **fields)


# StaticConfig value -> the ROADMAP item that ports it.
_UNPORTED_CONFIG = {
    ("compact_build", "host"): "ROADMAP Queue 1 item 13 (host-banded build)",
    ("interpolation", "trilinear"): "ROADMAP Queue 1 item 14 (slice options)",
    ("accum_dtype", "uint8"): "ROADMAP Queue 1 item 14 (slice options)",
}


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Image size and capacities, with the reference package's field
    names and defaults (see there for each knob).  It holds the fields
    this slice reads and those whose other values raise; later slices add
    theirs.  Knobs that only tuned TPU formulations are not carried over."""

    width: int = 1024
    height: int = 1024
    num_photons: int = 16  # 1x1x1 dispatch x 4x4 local (src/main.cpp:814)
    # Light slots per frame (Point/Sphere); expanded_light_capacity below is
    # Ray/Beam's in "discrete_expanded".  Above 2048 slots (ops.lights.
    # SMEM_LIGHT_LIMIT) the frame takes the many-light gather.
    light_capacity: int = 1000
    max_march_steps: int = 2500
    max_photon_steps: int = 4096
    max_events_per_photon: int = 256
    max_path_segments: int = 8  # PATH: scatter re-origins per camera path
    max_points_per_segment: int = 512  # Ray/Beam sub-light cap per segment
    expanded_light_capacity: int = 16384  # compacted Ray/Beam sub-light slots
    gather_samples: int = 0
    # False: the uncached view (render.color.ViewCache, slots layout) with
    # every ray's full march, shaded by the slot kernels.
    compact_view: bool = True
    # "auto": the compact view is built on the device when its planes fit
    # Renderer.device_view_budget_bytes (else it raises: the host-banded
    # build is not ported); "device": always.
    compact_build: str = "auto"
    # Interactive camera motion: while the camera or march parameters change
    # between consecutive frames, frames render through a cheap path and
    # the settled camera rebuilds the exact view.
    #   "off"       — every frame exact (the default);
    #   "coarse"    — the uncached step at ``motion_stride`` x the march
    #                 step (photon walk included); the settle rebuilds in
    #                 ``settle_chunks`` row chunks, coarse frames between;
    #   "truncated" — the first ``motion_cap`` occupied samples of each ray
    #                 through an identity-order compact build.
    motion_mode: str = "off"
    motion_cap: int = 16
    motion_stride: int = 12
    settle_chunks: int = 4
    # Gather decimation (approximate fast tier): fold each run of
    # ``gather_stride`` march samples into one evaluation point
    # ("centroid"), or each run of 2 x ``gather_stride`` into two
    # ("gauss2"); the weights' sums are kept (render.color.decimate_view).
    gather_stride: int = 1
    gather_fold: str = "centroid"
    interpolation: str = "nearest"
    # Point/Sphere light-loop arithmetic:
    #   "exact"  — one guarded divide per (sample, light), the reference's
    #              term order (the default);
    #   "paired" — one divide per 4 lights via a rational combination;
    #              reassociation-only deviation <= 3e-5 relative.
    gather_eval: str = "exact"
    # Ray/VRL + Beam/VBL sub-light handling:
    #   "discrete"          — the reference's per-lightRayStepSize sub-lights,
    #                         iterated in the kernel from the segment table
    #                         (uncapped; the default);
    #   "discrete_expanded" — the sub-lights materialized and compacted into
    #                         a point/sphere light array (capped by
    #                         max_points_per_segment/expanded_light_capacity);
    #   "analytic"          — the segment integral itself: closed form for
    #                         Ray, a beam_quadrature_rule quadrature for Beam.
    segment_mode: str = "discrete"
    # Segment arithmetic, same contract as gather_eval: "paired" takes one
    # divide per 4 sub-lights or nodes, or shares the per-segment divides
    # of two segments (closed-form VRL, closed-rule VBL).
    segment_eval: str = "exact"
    beam_quadrature_nodes: int = 16
    # Beam analytic quadrature: "midpoint" in arclength, Gauss-Legendre in
    # the "tangent"-transformed variable, or the "closed" antiderivative
    # (quad nodes ignored).
    beam_quadrature_rule: str = "midpoint"
    # PATH (render.path).  REFERENCE reproduces the reference shader's
    # frozen light probe; CORRECTED marches the light segment.
    fidelity: Fidelity = Fidelity.REFERENCE
    # Scatter segments of at most this many rays (all frames of a batch)
    # walk full width; above it they walk the compacted alive rays.
    path_compact_min: int = 4096
    # Rays per chunk of the compacted walk.  Every chunk's sub-block loop
    # runs to its slowest ray and ends with one host read per sub-block;
    # results are bit-identical for any width.  Chosen on the H100 at the
    # 1080p bench config (PERF.md, PATH): the JAX package's 2048 was sized
    # for the TPU's fetch wall.
    path_chunk: int = 262144
    # Order the compacted alive rays by a per-ray bound on their sub-block
    # count before chunking (bit-exact: grouping never changes a ray's
    # arithmetic).  Key: "cells" (selected occupied cells / cell block),
    # "span" (in-box distance / sub-block span) or "auto" ("cells" up to
    # 262,144 rays a frame, "span" above).
    path_sort_chunks: bool = True
    path_sort_key: str = "auto"
    # Scatter-segment empty-space skipping: 0 = the largest exact cell
    # (cell * step <= one 8-voxel brick), 1 = every sample, > 1 that cell.
    path_march_cell: int = 0
    # Approximate fast tier: march at path_stride x the step with the roll
    # probability 1 - (1 - p)^stride; the light term keeps the step.
    path_stride: int = 1
    # The shadow-probe LUT replaces the REFERENCE light term's gather
    # while ceil(step) <= this radius (0 disables).
    shadow_lut_max_radius: int = 2
    probe_tile: int = 262144  # rays per occupancy-count tile
    build_tile: int = 65536  # rays per march tile of the view build
    accum_dtype: str = "float32"

    def __post_init__(self):
        allowed = {
            "motion_mode": {"off", "coarse", "truncated"},
            "gather_fold": {"centroid", "gauss2"},
            "compact_build": {"auto", "host", "device"},
            "gather_eval": {"exact", "paired"},
            "segment_mode": {"discrete", "discrete_expanded", "analytic"},
            "segment_eval": {"exact", "paired"},
            "beam_quadrature_rule": {"midpoint", "tangent", "closed"},
            "interpolation": {"nearest", "trilinear"},
            "accum_dtype": {"float32", "uint8"},
            "path_sort_key": {"auto", "cells", "span"},
        }
        # The reference package's Fidelity, or its value, maps to the port's.
        object.__setattr__(self, "fidelity",
                           Fidelity(getattr(self.fidelity, "value",
                                            self.fidelity)))
        for field, ok in allowed.items():
            v = getattr(self, field)
            if v not in ok:
                raise ValueError(
                    f"StaticConfig.{field}={v!r} — must be one of {sorted(ok)}"
                )
        if self.gather_stride < 1:
            raise ValueError("StaticConfig.gather_stride must be >= 1")
        if self.path_stride < 1:
            raise ValueError("StaticConfig.path_stride must be >= 1")
        for (field, value), item in _UNPORTED_CONFIG.items():
            if getattr(self, field) == value:
                raise NotImplementedError(
                    f"StaticConfig.{field}={value!r} is not ported to "
                    f"PyTorch yet: {item}"
                )
        if self.gather_samples:
            raise NotImplementedError(
                "StaticConfig.gather_samples > 0 needs the host-banded "
                "build, not ported yet: ROADMAP Queue 1 item 13"
            )

    @property
    def photon_grid(self) -> int:
        """Photon thread ids (gid.x, gid.y) for the 4x4 local group."""
        n = int(self.num_photons**0.5)
        if n * n != self.num_photons:
            raise ValueError("num_photons must be a square")
        return n
