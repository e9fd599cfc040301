"""Each cell end to end on the CPU at a small size: the program's frames
against the reference for every traffic mix, the result line's shape, the
bfloat16 control failing the cell's limits, and the timed path broken in
each way a cell can break, which ``correct`` has to catch."""

from __future__ import annotations

import json

import pytest

import pbcases  # noqa: F401  (puts the harness on the path)
from pbcases import CELLS, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    import harness

    result, checks = run_small(cell)
    assert result["correct"], checks
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    spec = harness.load_spec()
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
    for name, c in checks.items():
        assert 0.0 <= c["value"] <= c["limit"], name
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference in bfloat16, read as a run reads the program, fails
    one of the cell's numbers at least."""
    import control
    import harness

    from pbcases import small

    _, _, _, limits = harness.cell_files(harness.load_spec(), cell)
    got = control.readings(cell, 2**31 + 7, "cpu", small(cell))
    assert any(v > limits[k] for k, v in got.items()), got


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    import volumerenderer_tpu_torch as vt

    monkeypatch.setattr(vt.Renderer, "step", lambda self, n=1: self.state)


def _half_batch(monkeypatch):
    """Half of each batch of frames left out, the mean taken over the rest:
    the first half rendered, each of its frames counted twice."""
    import volumerenderer_tpu_torch as vt
    from volumerenderer_tpu_torch.engine.state import RenderState

    step = vt.Renderer.step

    def half(self, n=1):
        if n < 2:
            return step(self, n)
        m, old = self.state.frame_count, self.state.accum.clone()
        step(self, n // 2)
        done = self.state.accum * (m + n // 2) - old * m
        self.state = RenderState((old * m + done * (n / (n // 2))) / (m + n),
                                 m + n)
        return self.state

    monkeypatch.setattr(vt.Renderer, "step", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: every eighth pixel (or lane)
    of each frame shaded 5% too bright."""
    from volumerenderer_tpu_torch.render import color, path

    def bright(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            flat = out.reshape(-1) if out.dim() < 3 else out.reshape(
                out.shape[0], -1)
            flat[..., ::8] = flat[..., ::8] * 1.05
            return out
        return wrapped

    for mod, name in ((color, "shade_view_compact"), (color, "shade_view"),
                      (path, "render_frame"), (path, "render_frames")):
        monkeypatch.setattr(mod, name, bright(getattr(mod, name)))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}
CASES = [(c, f) for c in CELLS for f in FAULTS
         # A drag frame is a batch of one: nothing to halve.
         if not (f == "half_batch" and "drag" in c)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = run_small(cell)
    assert not result["correct"], checks
