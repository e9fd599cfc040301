"""Volume ingestion (twin of volumerenderer_tpu.grid.ingest): file ->
DenseGrid on the device.

A sparse file is parsed by the native library (grid/vdbio_native.py, C++)
into a dense array on the host, which ``from_dense`` bricks and uploads.
Export to .vdb, .nvdb and .npz goes the other way.  Every loader takes
``device`` (the GPU unless the caller asks for the CPU).

Spans (utils.profiling): "grid.load" (a ``load`` call), and inside it
"grid.load.read" (the native parse into the dense array, or numpy's),
"grid.load.brick" (the brick padding and tables) and "grid.load.upload"
(the copies to the device).
"""

from __future__ import annotations

import numpy as np

from ..utils import profiling
from . import vdbio_native
from .dense import DenseGrid, bricked, check_device, upload


def _grid(dense, bbox_min=(0, 0, 0), mat=None, vec=(0.0, 0.0, 0.0),
          device="cuda") -> DenseGrid:
    """``from_dense`` in two spans: the bricking, then the upload."""
    with profiling.span("grid.load.brick"):
        host = bricked(dense, bbox_min=bbox_min, translation=vec,
                       map_mat=None if mat is None
                       else np.asarray(mat).astype(np.float32))
    with profiling.span("grid.load.upload"):
        return upload(host, device)


@profiling.spanned("grid.load")
def load(path: str, grid_index: int = 0, *, device="cuda") -> DenseGrid:
    """Load a volume file into a DenseGrid: .vdb (OpenVDB), .nvdb
    (NanoVDB), .npy/.npz (dense arrays saved by this package)."""
    lower = str(path).lower()
    if lower.endswith(".nvdb"):
        return from_nvdb(path, grid_index, device=device)
    if lower.endswith(".vdb"):
        return from_vdb(path, device=device)
    if lower.endswith(".npy"):
        check_device(device, "load")
        with profiling.span("grid.load.read"):
            dense = np.load(path)
        return _grid(dense, device=device)
    if lower.endswith(".npz"):
        check_device(device, "load")
        with profiling.span("grid.load.read"), np.load(path) as z:
            a = {k: z[k] for k in ("voxels", "bbox_min", "map_mat",
                                   "map_vec")}
        return _grid(a["voxels"], a["bbox_min"], a["map_mat"], a["map_vec"],
                     device)
    raise ValueError(
        f"unsupported volume format: {path} (.vdb/.nvdb/.npy/.npz)"
    )


def from_vdb(path: str, grid_name: str | None = None, *,
             device="cuda") -> DenseGrid:
    """Read an OpenVDB .vdb file (native reader subset: modern file
    versions, FloatGrid 5-4-3, none/zip/blosc codecs)."""
    check_device(device, "from_vdb")
    with profiling.span("grid.load.read"):
        dense, bbox_min, mat, vec, _name = vdbio_native.read_vdb(path,
                                                                 grid_name)
    return _grid(dense, bbox_min, mat, vec, device)


def from_nvdb(path: str, grid_index: int = 0, *, device="cuda") -> DenseGrid:
    """Read a NanoVDB .nvdb file."""
    check_device(device, "from_nvdb")
    with profiling.span("grid.load.read"):
        dense, bbox_min, mat, vec, _name = vdbio_native.read_nvdb(
            path, grid_index)
    return _grid(dense, bbox_min, mat, vec, device)


def from_nanovdb_blob(blob: bytes, *, device="cuda") -> DenseGrid:
    """Ingest an in-memory NanoVDB grid blob (the byte payload the
    reference uploads to its SSBO, src/main.cpp:1197-1212)."""
    check_device(device, "from_nanovdb_blob")
    dense, bbox_min, mat, vec = vdbio_native.dense_from_blob(blob)
    return _grid(dense, bbox_min, mat, vec, device)


def _host(grid: DenseGrid):
    """(voxels, bbox_min, map_mat, map_vec) on the host."""
    return (grid.voxels.cpu().numpy(), grid.bbox_min.cpu().numpy(),
            grid.map_mat.cpu().numpy().astype(np.float64),
            grid.map_vec.cpu().numpy().astype(np.float64))


def save_nvdb(grid: DenseGrid, path: str, grid_name: str = "density",
              codec: str = "zip") -> None:
    """Export a DenseGrid as a .nvdb file (``codec`` "none" or "zip")."""
    voxels, bbox_min, mat, vec = _host(grid)
    vdbio_native.write_nvdb(path, voxels, bbox_min=bbox_min, mat=mat,
                            vec=vec, grid_name=grid_name, codec=codec)


def save_vdb(grid: DenseGrid, path: str, grid_name: str = "density",
             compression: str = "zip+mask") -> None:
    """Export a DenseGrid as an OpenVDB .vdb file.

    ``compression``: "none" | "zip" | "zip+mask" | "blosc" | "blosc+mask".
    The brick-padded voxel array is written; its zero padding voxels are
    inactive, so a reload has the same active set."""
    voxels, bbox_min, mat, vec = _host(grid)
    vdbio_native.write_vdb(path, (voxels, bbox_min, mat, vec, grid_name),
                           compression)


def save_npz(grid: DenseGrid, path: str) -> None:
    voxels, bbox_min, _, _ = _host(grid)
    np.savez_compressed(
        path, voxels=voxels, bbox_min=bbox_min.astype(np.int32),
        map_mat=grid.map_mat.cpu().numpy(), map_vec=grid.map_vec.cpu().numpy(),
    )
