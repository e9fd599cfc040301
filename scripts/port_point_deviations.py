"""Deviations of the PyTorch port's point/sphere gathers from the JAX
package's Pallas kernels, on the CPU, at the sizes of the port's tests.

    JAX_PLATFORMS=cpu python scripts/port_point_deviations.py

Prints one JSON line per comparison, as a measured maximum relative
deviation (the tests hold the same pairs at rtol 2e-5):
  * the lane plain version (``gather_lanes_reference``, the twin of row 1)
    against JAX's ``gather_lanes`` in interpret mode, per lane, on
    tests/test_torch_gather_lanes.py's cases (37 slots, range (4, 30); 5
    slots, range (1, 3));
  * the slot plain version (``gather_vpu_reference``, row 4) against JAX's
    ``gather_planes(layout="slots", impl="vpu_interpret")``, per sample, on
    tests/test_torch_gather_slots.py's scene and lights with its guard
    margin;
for point and sphere lights, exact and paired; and each paired plain
version against the exact one.  The CUDA kernels against these plain
versions are chip_smoke.py's kernel/shapes and slotkernel/slotshapes; the
sum of the two bounds a kernel's deviation from the JAX kernel.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"), os.path.join(ROOT,
                                                                "scripts")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_gather_lanes as tlanes_t  # noqa: E402
import test_torch_gather_slots as tslot_t  # noqa: E402
from port_many_deviations import rel  # noqa: E402
from volumerenderer_tpu.ops import gather as jgather  # noqa: E402
from volumerenderer_tpu.ops.pallas import gather_lanes as jlanes  # noqa: E402
from volumerenderer_tpu_torch.ops import gather as tgather  # noqa: E402


def main():
    case = tslot_t.case.__wrapped__()
    for sphere in (False, True):
        plain = {}
        for paired in (False, True):
            lanes = []
            for L in (5, 37):
                px, py, pz, w, lpos, lint, need, start, count = c = (
                    tlanes_t.case(L))
                got = tlanes_t.port(*c, sphere=sphere, paired=paired)
                want = np.asarray(jlanes.gather_lanes(
                    px, py, pz, w, lpos, lint, start, count, sphere=sphere,
                    radius=0.3, lane_need=jnp.asarray(need), paired=paired,
                    interpret=True))
                lanes.append(rel(got, want))
                plain[paired, L] = got
            w = tslot_t.point_weights(case, sphere)
            kw = dict(sphere=sphere, radius=0.3, paired=paired)
            got = tslot_t.port_slots(tgather.gather_planes, case["planes"], w,
                                     *case["lights"], **kw)
            want = tslot_t.jax_slots(jgather.gather_planes, case["planes"], w,
                                     *case["lights"], impl="vpu_interpret",
                                     **kw)
            plain[paired, "slots"] = got
            print(json.dumps(dict(
                light="sphere" if sphere else "point", paired=paired,
                lanes_plain_vs_pallas_max_rel=max(lanes),
                slots_plain_vs_pallas_max_rel=rel(got, want),
                slots_live=int(np.count_nonzero(want)))), flush=True)
        print(json.dumps(dict(
            light="sphere" if sphere else "point",
            lanes_plain_paired_vs_exact_max_rel=max(
                rel(plain[True, L], plain[False, L]) for L in (5, 37)),
            slots_plain_paired_vs_exact_max_rel=rel(plain[True, "slots"],
                                                    plain[False, "slots"]))),
            flush=True)


if __name__ == "__main__":
    main()
