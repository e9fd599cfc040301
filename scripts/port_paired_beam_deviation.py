"""How far the paired discrete tier departs from the exact one on
chip_smoke.py's synthetic long segment table, in the JAX package and in the
PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_paired_beam_deviation.py [lanes]

The planes and the table are built as chip_smoke.py's segkernel phase
builds them (``segment_case`` with seed 7, the long table of 11 valid
segments of 318 sub-lights with seed 8), here from the CPU's random stream
and at ``lanes`` lanes (default 2048) of the 144-row planes, since the
JAX kernel runs in interpret mode.  For Ray (point sub-lights) and Beam
(sphere sub-lights of radius 0.3) it prints one JSON line with the maximum
relative deviation, per lane, of

  * JAX's paired tier against its exact tier, both through
    ``gather_segments_discrete(..., layout="lanes", impl="vpu_interpret")``
    (the lane Pallas kernel in interpret mode, as the JAX tests run it);
  * the port's paired plain version against its exact plain version;
  * the port's exact plain version against JAX's exact tier;

and the lane where JAX's pairing departs most, with its sum and how many
of its samples sit within 0.01 of a sub-light's sphere (or, for Ray, of a
sub-light).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from port_many_deviations import rel  # noqa: E402
from volumerenderer_tpu.ops import gather as jgather  # noqa: E402
from volumerenderer_tpu_torch.ops.kernels import (  # noqa: E402
    gather_segments as tseg,
)

STEP, RADIUS = 0.3, 0.3


def long_table(dev):
    """chip_smoke.phase_segment_kernel's second table: 11 valid segments of
    318 sub-lights through the samples' cloud."""
    gen = torch.Generator(device=dev).manual_seed(8)
    pos_from = torch.randn((12, 3), generator=gen, device=dev) * 8 + 15
    u = torch.randn((12, 3), generator=gen, device=dev)
    pos_to = pos_from + 95.5 * u / torch.linalg.vector_norm(u, dim=1,
                                                             keepdim=True)
    return (pos_from, pos_to,
            torch.rand(12, generator=gen, device=dev) * 30,
            torch.arange(12, device=dev) >= 1)


def near_sublights(planes, need, segs, radius):
    """Per lane, the used samples within 0.01 of a sub-light's sphere
    surface (radius None: of a sub-light)."""
    u, ns, _, start, count = tseg.discrete_cols(*segs, STEP)
    ones = torch.ones_like(ns, dtype=torch.float32)
    lx, ly, lz, *_ = tseg._sublight_table(segs[0], u, ns, ones, int(start),
                                         int(count), np.float32(STEP), False)
    use, x, y, z = tseg._active_samples(*planes[:3], need)
    gap = torch.empty_like(x)
    for a in range(0, x.shape[0], 4096):
        d = torch.sqrt((x[a:a + 4096, None] - lx) ** 2
                       + (y[a:a + 4096, None] - ly) ** 2
                       + (z[a:a + 4096, None] - lz) ** 2)
        gap[a:a + 4096] = (d if radius is None
                           else (d - radius).abs()).min(dim=1).values
    full = torch.zeros(use.shape, dtype=torch.int64)
    full[use] = (gap < 0.01).long()
    return full.sum(0).numpy()


def main(argv):
    lanes = int(argv[0]) if argv else 2048
    planes, segs, need = cs.segment_case(cs.SYNTH_CP, lanes, 7, "cpu")
    segs = long_table("cpu")
    np_planes = [p.numpy() for p in planes]
    np_segs = [s.numpy() for s in segs]
    for name, radius in (("ray", None), ("beam", RADIUS)):
        jx = {}
        for paired in (False, True):
            jx[paired] = np.asarray(jgather.gather_segments_discrete(
                *np_planes, *np_segs, STEP, sphere_radius=radius,
                impl="vpu_interpret", layout="lanes",
                lane_need=jnp.asarray(need.numpy()), paired=paired))
        port = {paired: tseg.gather_segments_discrete_lanes_reference(
            *planes, *segs, STEP, sphere_radius=radius, lane_need=need,
            paired=paired).numpy() for paired in (False, True)}
        dev = np.abs(jx[True].astype(np.float64) - jx[False]) / np.maximum(
            np.abs(jx[False].astype(np.float64)), 1e-300)
        worst = int(np.argmax(dev))
        near = near_sublights(planes, need, segs, radius)
        print(json.dumps(dict(
            kernel=f"discrete[{name}]", lanes=lanes,
            sublights=cs.sublights(segs, STEP),
            jax_paired_vs_jax_exact_max_rel=rel(jx[True], jx[False]),
            port_plain_paired_vs_plain_exact_max_rel=rel(port[True],
                                                         port[False]),
            port_plain_exact_vs_jax_exact_max_rel=rel(port[False], jx[False]),
            port_plain_paired_vs_jax_paired_max_rel=rel(port[True], jx[True]),
            worst_lane=worst, worst_lane_sum=float(jx[False][worst]),
            worst_lane_samples_near_a_sublight=int(near[worst]),
            lanes_with_a_sample_near_a_sublight=int((near > 0).sum()))),
            flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
