"""One short run of a cell on the card, through the benchmark's command, as
the check runs it.  Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from pbcases import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cloud96-point-converge", "--seed", str(2**31 + 99), "--seconds",
         "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}
