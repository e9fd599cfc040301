"""The cumulus configuration's cell and ``bunny-ray-drag`` on the CPU at a
small size: the program's frames against the reference, the bfloat16
control failing the cells' limits, the cumulus generator (deterministic in
its seed, the same array whatever its slab size, its maximum and its share
of the box), and the readers of the view counts, on synthetic counts and
on a traced run through the host-banded build."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest
import torch

import pbcases  # noqa: F401  (puts the harness on the path)
from pbcases import ROOT, SEED

CELLS = ("cumulus-half-point-converge", "bunny-ray-drag")
SHAPE = [48, 32, 56]
# The full configuration's camera and light in units of the box (index
# space over half its height), at the small shape's voxel of 1.0.
SMALL = {"width": 64, "height": 64,
         "volume": {"shape": SHAPE, "bbox_min": [-24, -16, -28],
                    "voxel_size": 1.0},
         "params": {"camera_pos": [0.0, 20.0, -25.0],
                    "light_source_world_pos": [0.0, 20.0, 14.5]}}
ACTIVE = (0.25, 0.40)  # the configuration's stated share of the box


def small(cell: str) -> dict:
    return SMALL if cell.startswith("cumulus") else pbcases.small(cell)


def run_small(cell: str, traced: bool = False, seconds: float = 0.5):
    import harness

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return harness.run_cell(cell, SEED, seconds, traced, device="cpu",
                                overrides=small(cell), log=lambda s: None)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    import harness

    result, checks = run_small(cell)
    assert result["correct"], checks
    spec = harness.load_spec()
    want = {m["name"] for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want
    for name, c in checks.items():
        assert 0.0 <= c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    import control
    import harness

    _, _, _, limits = harness.cell_files(harness.load_spec(), cell)
    got = control.readings(cell, 2**31 + 7, "cpu", small(cell))
    assert any(v > limits[k] for k, v in got.items()), got


def _cumulus(seed, **kw):
    import volumes

    from volumes import cumulus

    if kw:
        return cumulus.generate({"shape": SHAPE}, seed, "cpu", **kw)
    return volumes.generate({"generator": "cumulus", "shape": SHAPE}, seed,
                            "cpu")


def test_generator_is_deterministic_in_its_seed():
    a, b = _cumulus(SEED), _cumulus(SEED)
    assert torch.equal(a, b)
    assert not torch.equal(a, _cumulus(SEED + 1))


@pytest.mark.parametrize("slab_voxels", [1, 32 * 56 * 5, 1 << 30])
def test_generator_is_independent_of_its_slab(slab_voxels):
    """One x-plane a slab, slabs of 5 planes (the last one shorter), and
    the whole box as one slab give the same array, bit for bit."""
    assert torch.equal(_cumulus(SEED, slab_voxels=slab_voxels),
                       _cumulus(SEED))


@pytest.mark.parametrize("seed", [SEED, 1, 2**31 + 7])
def test_generator_maximum_and_share(seed):
    v = _cumulus(seed)
    assert v.dtype == torch.float32 and list(v.shape) == SHAPE
    assert float(v.max()) == 1.0
    nz = v[v > 0]
    assert float(nz.min()) >= 0.02
    share = float((v > 0).float().mean())
    assert ACTIVE[0] <= share <= ACTIVE[1], share


def _counts_ctx(kind, counts, spans_=()):
    import spans

    from volumerenderer_tpu_torch.utils import profiling

    ns = 1_000_000
    t0 = 1_700_000_000
    drained = dict(
        spans=[profiling.Span(n, (t0 * 1000 + a) * ns, (t0 * 1000 + b) * ns,
                              i + 1, 0, i + 1)
               for i, (n, a, b) in enumerate(spans_)],
        counts=[profiling.Count(k, s, n, (t0 * 1000 + t) * ns, 1)
                for k, s, n, t in counts],
        peak=0, dropped=0)
    ctx = SimpleNamespace(window=(t0, t0 + 0.1), frames=4, kind=kind,
                          algorithm="POINT", cache={})
    ctx.cache["spans"] = spans.window_of(drained, *ctx.window)
    return ctx


def test_view_live_pct_reads_the_counts():
    import harness

    mod = harness.load_metric("view_live_pct.frame")
    counts = [("view", "color.shade.live", 30, 10),
              ("view", "color.shade.held", 100, 10),
              ("view", "color.shade.live", 30, 50),
              ("view", "color.shade.held", 100, 50),
              ("view", "color.shade.live", 99, -5),  # before the window
              ("view", "color.shade.held", 100, -5)]
    assert mod.read(_counts_ctx("converge", counts)) == pytest.approx(30.0)
    assert mod.read(_counts_ctx("converge", [])) is None
    assert mod.read(_counts_ctx("drag", counts)) is None


def test_settle_host_build_ms_reads_the_spans():
    import harness

    mod = harness.load_metric("settle_host_build_ms.drag")
    builds = [("color.build", 10, 40), ("color.build", 60, 70)]
    counts = [("view", "color.build.host", 1, 10),
              ("view", "color.build.host", 1, 60)]
    ctx = _counts_ctx("drag", counts, builds)
    assert mod.read(ctx) == pytest.approx(20.0, abs=1e-3)  # epoch seconds
    assert mod.read(_counts_ctx("drag", [], builds)) is None
    assert mod.read(_counts_ctx("converge", counts, builds)) is None


@pytest.mark.parametrize("cell,metric", [
    ("cumulus-half-point-converge", "view_live_pct.frame"),
    ("bunny-ray-drag", "settle_host_build_ms.drag")])
def test_traced_run_reads_the_view_counts(cell, metric, monkeypatch):
    """With the device budget lowered so that the small views take the
    host-banded build, as the full-size ones do, a traced run reads each
    new metric."""
    import volumerenderer_tpu_torch as vt

    monkeypatch.setattr(vt.Renderer, "device_view_budget_bytes", 1)
    result, checks = run_small(cell, traced=True)
    assert result["correct"], checks
    value = result["metrics"][metric]["value"]
    assert value > 0
    if metric.endswith("pct.frame"):
        assert value <= 100.0
