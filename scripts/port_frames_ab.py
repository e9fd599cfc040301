"""Time the Ray/Beam discrete exact frames of the bench config in several
checkouts of the port, on one card, in the order given.

Each checkout runs in its own process through its own ``chip_smoke.py``
(``phase_raybeam``: step(8) warm-up, step(16) timed), BEAM, RAY, BEAM, so
that two commits compare within one call as parent, change, change,
parent.  Prints the card's name and power limit, then one line a run:

    python3 scripts/port_frames_ab.py build/a build/b build/b build/a

Each directory is an unpacked ``git archive`` of a commit (under a
gitignored directory such as ``build/``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

RUNS = "(c.RAYBEAM_RUNS[3], c.RAYBEAM_RUNS[0], c.RAYBEAM_RUNS[3])"
CHILD = f"""
import sys
sys.path.insert(0, '.')
import torch
import chip_smoke as c
torch.cuda.set_device(0)
for run in {RUNS}:
    c.phase_raybeam(*run)
"""


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
            if line.startswith('{"phase": "raybeam"'):
                rec = json.loads(line)
                print(json.dumps({"dir": d, "run": rec["run"],
                                  "ms_per_frame": rec["ms_per_frame"]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
