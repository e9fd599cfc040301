"""The port's command line (``python -m volumerenderer_tpu_torch``) on the
CPU: ``render`` against the JAX package's ``_make_renderer`` session on the
same arguments, stepped the same way, in every ``--fast`` tier; PNG and PPM
output; ``bench`` and ``warmup``; ``view`` opening the viewer."""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from volumerenderer_tpu import __main__ as jcli
from volumerenderer_tpu.grid import ingest as jingest
from volumerenderer_tpu.grid import procedural as jprocedural
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch import __main__ as tcli
from volumerenderer_tpu_torch.io import ppm

ROOT = Path(__file__).resolve().parents[1]
SIZE, FRAMES = 48, 2


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """A small cloud saved by the JAX package as .npz."""
    p = tmp_path_factory.mktemp("cli") / "cloud.npz"
    jingest.save_npz(jprocedural.cloud(n=32), str(p))
    return str(p)


def jax_session(volume, algorithm, fast):
    args = argparse.Namespace(volume=volume, size=SIZE, algorithm=algorithm,
                              fast=fast)
    r = jcli._make_renderer(args)
    r.step(FRAMES)
    return np.asarray(r.image_u8()), np.asarray(r.image())


# The port's whole-frame tolerances against the JAX Renderer
# (tests/test_torch_slice.py, test_torch_slice_segments.py): light
# positions differ by ulps of the photon walk's acos/sin/cos.
FRAME_ATOL = {"POINT": 5e-5, "SPHERE": 5e-5, "RAY": 2e-5, "BEAM": 1e-3}


def to_u8(x):
    return (np.clip(x, 0.0, 1.0) * np.float32(255.0)
            + np.float32(0.5)).astype(np.uint8)


def assert_u8_close(got, want_u8, want, atol):
    """u8 images at most 1 apart, and only where the JAX frame lies within
    the frame tolerance of a rounding boundary (its value atol lower and
    atol higher round to different integers)."""
    assert got.shape == want_u8.shape and got.dtype == want_u8.dtype
    diff = np.abs(got.astype(np.int16) - want_u8.astype(np.int16))
    assert diff.max() <= 1
    near = to_u8(want - np.float32(atol)) != to_u8(want + np.float32(atol))
    assert not (diff.astype(bool) & ~near).any()


RUNS = [("RAY", "off"), ("RAY", "paired"), ("RAY", "decimated"),
        ("POINT", "off"), ("SPHERE", "paired"), ("BEAM", "decimated")]


@pytest.mark.parametrize("algorithm,fast", RUNS,
                         ids=[f"{a.lower()}-{f}" for a, f in RUNS])
def test_render_matches_jax(tmp_path, volume, algorithm, fast):
    out = tmp_path / "out.ppm"
    argv = ["render", "--device", "cpu", "--volume", volume, "--size",
            str(SIZE), "--frames", str(FRAMES), "--out", str(out),
            "--algorithm", algorithm, "--fast", fast]
    assert tcli.main(argv) == 0
    got = ppm.read_ppm(str(out))
    assert got.shape == (SIZE, SIZE, 3) and got.max() > 0
    assert_u8_close(got, *jax_session(volume, algorithm, fast),
                    FRAME_ATOL[algorithm])


def test_render_png_decodes(tmp_path, volume):
    """--out *.png goes through the native encoder; decoded, it is the
    session's image."""
    Image = pytest.importorskip("PIL.Image")
    out = tmp_path / "out.png"
    assert tcli.main(["render", "--device", "cpu", "--volume", volume,
                      "--size", str(SIZE), "--frames", "1", "--out",
                      str(out)]) == 0
    args = argparse.Namespace(volume=volume, size=SIZE, algorithm="RAY",
                              fast="off", device="cpu")
    r = tcli._make_renderer(args)
    r.step(1)
    with Image.open(out) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), r.image_u8())


def test_view_is_not_ported(monkeypatch):
    """The ``view`` command raised until the viewer was ported: it now
    opens InteractiveViewer (its blocking ``run`` patched out here, under
    matplotlib's Agg backend) with --motion and --algorithm applied."""
    import matplotlib

    matplotlib.use("Agg")
    from volumerenderer_tpu_torch import viewer

    seen = []
    monkeypatch.setattr(viewer.InteractiveViewer, "run",
                        lambda self: seen.append(self))
    assert tcli.main(["view", "--device", "cpu", "--size", "16",
                      "--algorithm", "POINT", "--motion", "truncated"]) == 0
    (v,) = seen
    r = v.renderer
    assert r.algorithm is vt.Algorithm.POINT
    assert r.config.motion_mode == "truncated" and r.first_frame_uncached
    assert (r.config.width, r.config.height) == (16, 16)


@pytest.mark.parametrize("cmd", ["bench", "warmup"])
def test_bench_and_warmup(capsys, cmd):
    argv = [cmd, "--device", "cpu"]
    if cmd == "warmup":
        argv += ["--size", "16"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert ("POINT 8 frames" in out) if cmd == "bench" else (
        "[warmup] batched step" in out)


def test_module_entry_point(tmp_path):
    """``python -m volumerenderer_tpu_torch`` runs main and exits 0."""
    out = tmp_path / "m.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "volumerenderer_tpu_torch", "render",
         "--device", "cpu", "--size", "16", "--frames", "1", "--out",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert ppm.read_ppm(str(out)).shape == (16, 16, 3)
