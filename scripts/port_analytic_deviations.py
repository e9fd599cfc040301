"""Deviations of the PyTorch port's analytic segment gathers from the JAX
package's Pallas kernels, on the CPU, at the sizes of the port's tests.

    JAX_PLATFORMS=cpu python scripts/port_analytic_deviations.py

Prints one JSON line per comparison, as a measured maximum relative
deviation (the tests hold the same pairs at rtol 2e-5):
  * the lane plain version (``gather_segments_analytic_lanes_reference``,
    the twin of row 3) against JAX's ``gather_segments_analytic_lanes`` in
    interpret mode, per lane, on tests/test_torch_gather_segments.py's
    scene;
  * the slot plain version (``gather_segments_analytic_reference``, rows 6
    and 7) against JAX's ``gather_segments_analytic`` with
    ``impl="vpu_interpret"``, per sample, on tests/test_torch_gather_slots.py's
    scene;
for the closed-form VRL and the three VBL rules, exact and paired, with
the tests' guard margins.  The CUDA kernels against these plain versions
are chip_smoke.py's segkernel/segshapes and slotkernel/slotshapes; the sum
of the two bounds a kernel's deviation from the JAX kernel.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_gather_segments as tseg_t  # noqa: E402
import test_torch_gather_slots as tslot_t  # noqa: E402
from port_many_deviations import rel  # noqa: E402
from volumerenderer_tpu.ops import gather as jgather  # noqa: E402
from volumerenderer_tpu.ops.pallas import gather_lanes as jlanes  # noqa: E402
from volumerenderer_tpu_torch.ops import gather as tgather  # noqa: E402


def main():
    px, py, pz, w0, pf, pt, inten, valid, need = tseg_t.scene()
    dist = tseg_t.segment_distance(px, py, pz, pf, pt, valid)
    for name, radius, rule in tseg_t.ANALYTIC:
        for paired in (False, True):
            # Lanes (row 3), as test_analytic_plain_matches_pallas_interpret.
            margin = (tseg_t.MARGIN_MIDPOINT if name == "vbl-midpoint"
                      else tseg_t.MARGIN)
            w = tseg_t.far_weights(w0, dist, radius, margin)
            got = tseg_t.port_analytic(px, py, pz, w, pf, pt, inten, valid,
                                       need, radius=radius, rule=rule,
                                       paired=paired)
            want = np.asarray(jlanes.gather_segments_analytic_lanes(
                px, py, pz, w, pf, pt, inten, valid, sphere_radius=radius,
                quad_nodes=8, quad_rule=rule, lane_need=jnp.asarray(need),
                paired=paired, interpret=True))
            lanes = rel(got, want)
            # Slots (rows 6 and 7), as
            # test_analytic_plain_matches_pallas_interpret_and_xla.
            margin = (tslot_t.MARGIN_MIDPOINT_SLOTS if name == "vbl-midpoint"
                      else tseg_t.MARGIN)
            w = tseg_t.far_weights(w0, dist, radius, margin)
            kw = dict(sphere_radius=radius, quad_nodes=8, quad_rule=rule,
                      paired=paired)
            got = tslot_t.port_slots(tgather.gather_segments, (px, py, pz),
                                     w, pf, pt, inten, valid, **kw)
            want = tslot_t.jax_slots(jgather.gather_segments, (px, py, pz), w,
                                     pf, pt, inten, valid,
                                     impl="vpu_interpret", **kw)
            print(json.dumps(dict(
                variant=name, paired=paired,
                lanes_plain_vs_pallas_max_rel=lanes,
                slots_plain_vs_pallas_max_rel=rel(got, want),
                slots_live=int(np.count_nonzero(want)))), flush=True)


if __name__ == "__main__":
    main()
