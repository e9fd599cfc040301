"""Time the interactive paths of the bench config (``chip_smoke.py``
``phase_drag``: the uncached first frame, coarse drag frames, settle ticks,
truncated drag frames and each drag path's view build) in several
checkouts of the port, on one card, in the order given, so that two or
three commits compare within one call as parent, change, change, parent.
Prints the card's name and power limit, then one line a run:

    python3 scripts/port_drag_ab.py build/a build/b . . build/b build/a

Each directory is a checkout: this one (``.``) or an unpacked
``git archive`` of a commit under a gitignored directory such as
``build/``.  Each runs in its own process through its own
``chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import sys
sys.path.insert(0, '.')
import torch
import chip_smoke as c
torch.cuda.set_device(0)
c.phase_drag()
"""
KEYS = ("first_frame_ms", "first_cached_frame_ms", "coarse_drag_ms",
        "settle_tick_ms", "truncated_drag_ms", "truncated_build_ms",
        "coarse_build_ms", "decimated_centroid_ms_per_frame",
        "decimated_gauss2_ms_per_frame")


def main(dirs: list[str]) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for d in dirs:
        if not (Path(d) / "chip_smoke.py").is_file():
            print(f"{d}: no chip_smoke.py", file=sys.stderr)
            return 2
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=d,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith('{"phase": "drag"'):
                rec = json.loads(line)
                print(json.dumps({"dir": d, **{k: rec[k] for k in KEYS}}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
