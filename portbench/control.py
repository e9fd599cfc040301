"""The control of the check: the reference put in the program's place and
computed in bfloat16 (the precision below the configuration's float32),
read by the same comparison as a run.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's inputs, draws the ticks a run of the
cell's traffic would compare (``control_samples`` of its driver: frame
counts a window reaches, the drag's cameras), and prints one JSON line per
seed with each number compared: the bfloat16 reference's frames against the
float32 reference's.  The average's rounding floor (``check.resolution``)
takes the float32 reference's mean frame of the tick as the image, which a
still camera's average converges to.  The benchmark's own runs never run
it."""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(cell: str, seed: int, device, overrides=None) -> dict:
    import torch

    import check
    import drive
    import harness

    spec = harness.load_spec()
    _, config, traffic, _ = harness.cell_files(spec, cell)
    config = harness.override(config, overrides)
    inputs = harness.make_inputs(config, seed, device)
    vol = check.volume_of(inputs, device)
    drv = drive.driver(traffic["kind"])
    out = {}
    for s in drv.control_samples(traffic, inputs, random.Random(int(seed))):
        fcs = list(range(s["n0"] + 1, s["n1"] + 1))
        kw = dict(algorithm=traffic["algorithm"], coarse=s["coarse"])
        want = check.reference_frames(vol, inputs, s["camera"], fcs, **kw)
        got = check.reference_frames(vol, inputs, s["camera"], fcs,
                                     dtype=torch.bfloat16, **kw)
        want = want.double().sum(0).cpu().numpy()
        name = check.number_of(s)
        out[name] = check.rel_l1(
            got.double().sum(0).cpu().numpy(), want, len(fcs),
            check.resolution(want / len(fcs), s["n1"]))
        del want, got
        if device != "cpu":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(Path.cwd()))
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings(args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
