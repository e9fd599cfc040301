"""Deviations of the PyTorch port's many-light route from the JAX package,
on the CPU, at the sizes of the port's tests.

    JAX_PLATFORMS=cpu python scripts/port_many_deviations.py

Prints one JSON line per comparison:
  * the plain version of the many-light gather (``ops.gather.gather``)
    against JAX's ``gather_xla`` oracle (samples more than 0.3 from a
    guard surface) and its Pallas ``gather_mxu`` in interpret mode, for
    the cases of tests/test_torch_gather_many.py;
  * whole frames of the port's Renderer against the JAX Renderer with
    ``gather_impl="xla"`` and ``"vpu_interpret"`` (which routes above 2048
    slots to ``gather_mxu``), for the four configurations of
    tests/test_torch_slice_many.py through both views, after step(1) and
    a batch of step(3).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import numpy as np  # noqa: E402

import test_torch_gather_many as tg  # noqa: E402
import test_torch_slice_many as ts  # noqa: E402
from volumerenderer_tpu.ops import gather as jgather  # noqa: E402


def rel(got, want):
    den = np.abs(want.astype(np.float64))
    diff = np.abs(got.astype(np.float64) - want)
    return float(np.max(np.where(den > 0, diff / np.maximum(den, 1e-300),
                                 np.where(diff > 0, np.inf, 0.0)),
                        initial=0.0))


def main():
    s = tg.samples()
    for sphere in (False, True):
        for L, kind in tg.CASES:
            lpos, lint, valid = tg.lights(L, kind)
            got = tg.port_gather(s, lpos, lint, valid, sphere)
            far = tg.gap(s, lpos, valid, sphere) > tg.MARGIN
            oracle = np.asarray(jgather.gather_xla(
                s, lpos, lint, valid, sphere=sphere, radius=tg.RADIUS))
            pallas = np.asarray(jgather.gather(
                s, lpos, lint, valid, sphere=sphere, radius=tg.RADIUS,
                impl="mxu_interpret", center=tg.CENTER))
            print(json.dumps(dict(
                compare="gather", sphere=sphere, L=L, validity=kind,
                vs_xla_max_rel=rel(got[far], oracle[far]),
                vs_mxu_max_rel=rel(got[far], pallas[far]),
                vs_mxu_max_abs=float(np.abs(got - pallas)[far].max()),
                vs_mxu_max_rel_all=rel(got, pallas))), flush=True)
    for algorithm in ts.ALGOS:
        for compact in (True, False):
            g, p, c = ts.many_scene(algorithm, compact)
            out = dict(compare="frames", algorithm=algorithm.name,
                       compact_view=compact)
            for impl in ("xla", "vpu_interpret"):
                rj, rt = ts.renderers(algorithm, g, p, c, impl)
                rj.frame_batch = rt.frame_batch = 3
                err = 0.0
                for n in (1, 3):
                    rj.step(n)
                    rt.step(n)
                    err = max(err, float(np.abs(
                        rt.image() - np.asarray(rj.image())).max()))
                out[f"vs_{impl}_max_abs"] = err
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
