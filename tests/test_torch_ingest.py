"""Volume ingestion of the port (grid.ingest, grid.vdbio_native) against the
JAX package's on the same files (CPU).  The readers and writers are integer
and byte code, so voxels, bbox_min, map_mat and map_vec must be exactly
equal, and the two packages' writers must write the same bytes."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import vdb_writer
from volumerenderer_tpu import grid as jgrid
from volumerenderer_tpu.grid import vdbio_native as jnative
import volumerenderer_tpu_torch as vt
from volumerenderer_tpu_torch.grid import vdbio_native as tnative

ROOT = Path(__file__).resolve().parents[1]
MAP = np.array([[0.8, 0.1, 0.0], [0.0, 0.7, -0.2], [0.05, 0.0, 0.9]],
               np.float32)
SAVES = ["none", "zip", "zip+mask", "blosc", "blosc+mask", "nvdb-zip",
         "nvdb-none"]


def volume(seed=19, shape=(22, 13, 18)):
    rs = np.random.RandomState(seed)
    d = ((rs.rand(*shape) < 0.3) * rs.rand(*shape)).astype(np.float32)
    d[0, 0, 0] = 0.5
    d[-1, -1, -1] = 0.7  # pin the tight bbox to the array bounds
    return d


def assert_same(tg, jg):
    """A port grid and a JAX grid hold the same volume, exactly."""
    np.testing.assert_array_equal(tg.voxels.numpy(), np.asarray(jg.voxels))
    for name in ("bbox_min", "bbox_max", "map_mat", "map_vec",
                 "brick_occ", "brick_max", "brick_occ_dil"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.voxels.device.type == "cpu"


def load_both(path):
    return vt.grid.load(str(path), device="cpu"), jgrid.load(str(path))


WRITER_CASES = {
    "zip-mask": dict(zip_on=True, use_mask_compression=True),
    "zip": dict(zip_on=True, use_mask_compression=False),
    "mask": dict(zip_on=False, use_mask_compression=True),
    "raw": dict(zip_on=False, use_mask_compression=False),
}


@pytest.mark.parametrize("case", [*WRITER_CASES, "multiupper", "negative"])
def test_vdb_writer_files_load_equal(tmp_path, case):
    """Files from the independent Python encoder (tests/vdb_writer.py):
    zip on and off, mask compression on and off, a volume spanning several
    upper nodes, negative coordinates."""
    p = tmp_path / "v.vdb"
    if case == "multiupper":
        d = np.zeros((6, 5, 4), np.float32)
        d[0, 0, 0], d[5, 4, 3] = 1.5, 2.5
        vdb_writer.write_vdb(str(p), d, bbox_min=(4090, -3, -5000))
    elif case == "negative":
        vdb_writer.write_vdb(str(p), volume(23), bbox_min=(-40, -17, -9),
                             voxel_size=0.25, translation=(-3.0, 4.0, 0.5))
    else:
        vdb_writer.write_vdb(str(p), volume(), bbox_min=(-6, 3, -9),
                             voxel_size=0.8, translation=(1.0, -2.0, 3.0),
                             grid_name="dens", **WRITER_CASES[case])
    tg, jg = load_both(p)
    assert_same(tg, jg)
    assert float(tg.voxels.max()) > 0


def _save(mod, g, path, kind):
    if kind.startswith("nvdb"):
        mod.save_nvdb(g, str(path), codec=kind.split("-")[1])
    else:
        mod.save_vdb(g, str(path), compression=kind)


@pytest.mark.parametrize("kind", SAVES)
def test_saved_files_cross_load(tmp_path, kind):
    """Each package's save_vdb (every compression) and save_nvdb of the same
    volume: the same bytes, and each file read by both loaders to the same
    grid, the source's voxels over the reloaded bbox."""
    dense = volume(31)
    jsrc = jgrid.from_dense(dense, bbox_min=(-11, 5, -3),
                            translation=(0.5, -1.5, 2.0), map_mat=MAP)
    tsrc = vt.grid.from_dense(dense, bbox_min=(-11, 5, -3),
                              translation=(0.5, -1.5, 2.0), map_mat=MAP,
                              device="cpu")
    suffix = ".nvdb" if kind.startswith("nvdb") else ".vdb"
    pj, pt = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    _save(jgrid.ingest, jsrc, pj, kind)
    _save(vt.grid.ingest, tsrc, pt, kind)
    assert pt.read_bytes() == pj.read_bytes()
    tg, jg = load_both(pt)
    assert_same(tg, jg)
    lo = (tg.bbox_min - tsrc.bbox_min).tolist()
    n = tg.voxels.shape
    np.testing.assert_array_equal(
        tg.voxels.numpy(),
        tsrc.voxels.numpy()[lo[0]:lo[0] + n[0], lo[1]:lo[1] + n[1],
                            lo[2]:lo[2] + n[2]])
    np.testing.assert_array_equal(tg.map_mat.numpy(), MAP)


def test_blob_round_trip():
    """The in-memory NanoVDB blob: the same bytes from both packages, and
    each blob ingested equal by both."""
    dense = volume(17, (9, 14, 7))
    args = ((4, -8, 100), MAP.astype(np.float64), (1.0, 2.0, -3.0))
    bt = tnative.blob_from_dense(dense, *args)
    bj = jnative.blob_from_dense(dense, *args)
    assert bt == bj
    tg = vt.grid.from_nanovdb_blob(bt, device="cpu")
    assert_same(tg, jgrid.from_nanovdb_blob(bj))
    np.testing.assert_array_equal(tg.voxels.numpy()[:9, :14, :7], dense)
    np.testing.assert_array_equal(tg.bbox_min.numpy(), [4, -8, 100])


@pytest.mark.parametrize("kind", ["npz-port", "npz-jax", "npy"])
def test_load_dispatch_npy_npz(tmp_path, kind):
    """``load`` of .npz files saved by either package and of a bare .npy."""
    dense = volume(5, (10, 9, 8))
    if kind == "npy":
        p = tmp_path / "v.npy"
        np.save(p, dense)
    else:
        p = tmp_path / "v.npz"
        if kind == "npz-port":
            vt.grid.save_npz(vt.grid.from_dense(
                dense, bbox_min=(1, -2, 3), translation=(0.0, 1.0, 2.0),
                map_mat=MAP, device="cpu"), str(p))
        else:
            jgrid.save_npz(jgrid.from_dense(
                dense, bbox_min=(1, -2, 3), translation=(0.0, 1.0, 2.0),
                map_mat=MAP), str(p))
    tg, jg = load_both(p)
    assert_same(tg, jg)


def _bad(tmp_path, case):
    if case == "extension":
        return tmp_path / "v.raw"
    p = tmp_path / "v.vdb"
    vdb_writer.write_vdb(str(p), volume(21), grid_name="clouds")
    if case == "truncated":
        blob = p.read_bytes()
        p.write_bytes(blob[: len(blob) // 2])
    if case == "not-a-file":
        p.write_bytes(b"not a vdb file at all--------")
    if case == "missing":
        p = tmp_path / "missing.nvdb"
    return p


@pytest.mark.parametrize("case", ["extension", "grid-name", "truncated",
                                  "not-a-file", "missing"])
def test_errors_match_jax(tmp_path, case):
    """The same exception type as the JAX package for a bad extension, a
    missing grid name, a truncated or foreign file and a missing file."""
    p = _bad(tmp_path, case)

    def run(mod, **kw):
        if case == "grid-name":
            return mod.from_vdb(str(p), "nonexistent", **kw)
        return mod.load(str(p), **kw)

    with pytest.raises(Exception) as want:
        run(jgrid)
    with pytest.raises(type(want.value)):
        run(vt.grid, device="cpu")
    assert want.type in (ValueError, OSError)


def _tree_digest(path: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.iterdir()) if p.suffix in (".cpp", ".h")}


def test_library_builds_under_build_native(tmp_path):
    """The port builds its own copy of the sources into build/native/ and
    writes nothing into either source tree."""
    jdir = ROOT / "volumerenderer_tpu" / "native"
    tdir = ROOT / "volumerenderer_tpu_torch" / "native"
    before = (_tree_digest(jdir), sorted(p.name for p in tdir.iterdir()))
    tnative.lib()
    p = tmp_path / "v.vdb"
    vt.grid.save_vdb(vt.grid.from_dense(volume(), device="cpu"), str(p))
    vt.grid.load(str(p), device="cpu")
    so = Path(tnative.build_info["path"])
    assert so.parent == ROOT / "build" / "native" and so.is_file()
    assert (_tree_digest(jdir), sorted(p.name for p in tdir.iterdir())) \
        == before
    assert not any(so.name in q.name for q in jdir.iterdir())
    # The port's sources are the JAX package's with only the zlib include
    # changed (native/zlib_api.h).
    for name in ("vdbio.cpp", "vdb_read.cpp", "vdb_write.cpp", "imageio.cpp",
                 "lz4_blosc.h"):
        want = (jdir / name).read_text().replace(
            "#include <zlib.h>", '#include "zlib_api.h"')
        assert (tdir / name).read_text() == want, name


@pytest.mark.parametrize("loader", ["load", "from_vdb", "from_nvdb",
                                    "from_nanovdb_blob"])
def test_loaders_default_to_the_card(tmp_path, loader):
    """Every loader builds on the GPU unless asked for the CPU: without
    CUDA it raises naming its device argument, before reading the file."""
    g = vt.grid.from_dense(volume(), device="cpu")
    p, q = tmp_path / "v.vdb", tmp_path / "v.nvdb"
    vt.grid.save_vdb(g, str(p))
    vt.grid.save_nvdb(g, str(q))
    arg = {"load": str(p), "from_vdb": str(p), "from_nvdb": str(q),
           "from_nanovdb_blob": tnative.blob_from_dense(volume())}[loader]
    fn = getattr(vt.grid, loader)
    if torch.cuda.is_available():
        assert fn(arg).voxels.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device"):
            fn(arg)
