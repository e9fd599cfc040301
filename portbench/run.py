"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It measures ``volumerenderer_tpu_torch`` on
one CUDA card and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit.  The same numbers are
the last lines of standard error.  It exits non-zero, with no result, when
no CUDA card is there, when the program cannot be imported, or when the
process has loaded JAX."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "volumerenderer_tpu")


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, for whatever builds or
    compiles (the port itself builds into build/kernels and build/native),
    and no JAX behind any library's back."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_env(root)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root))

    import torch

    import harness
    import volumerenderer_tpu_torch  # noqa: F401  (the program under test)

    spec = harness.load_spec()
    chips = harness._named(spec["workloads"], args.workload,
                           "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"portbench: card {harness.power_limit()}")
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START, log=log)
    bad = loaded_forbidden()
    if bad:
        log(f"portbench: the process loaded {', '.join(bad)}; no result")
        return 3
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
