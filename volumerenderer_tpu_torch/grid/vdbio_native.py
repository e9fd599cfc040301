"""ctypes bindings for the native volume I/O library (twin of
volumerenderer_tpu.grid.vdbio_native).

The library is this package's ``native/`` sources: the NanoVDB reader and
writer (vdbio.cpp), the OpenVDB ``.vdb`` reader and writer (vdb_read.cpp,
vdb_write.cpp) and the PNG/PPM encoder (imageio.cpp).  At first use
``lib()`` compiles them with ``g++`` into ``<checkout>/build/native/``
under a file name that carries a hash of the sources, the flags, the
compiler and the zlib it links, then loads the result.  zlib is linked by
the path of the ``libz`` that Python's own ``zlib`` module loaded (``-lz``
when that is not found); ``native/zlib_api.h`` declares its calls when
the system has no ``zlib.h``.  The build's log beside the library
(``libvdbio-<hash>.json``) holds its command, the compiler's output and
which zlib case held.  A missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("vdbio.cpp", "vdb_read.cpp", "vdb_write.cpp", "imageio.cpp")
CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None
# How the library was built: its path, zlib's link argument, and whether
# the compiler found zlib.h.
build_info: dict = {}


def _compiler() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the native volume I/O "
                           "library is built from source at first use")
    return found


def zlib_link() -> str:
    """The linker argument for zlib: the path of the libz that this
    process loaded for Python's ``zlib`` module, else ``-lz``."""
    import zlib  # noqa: F401  (maps libz into this process)

    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if os.path.basename(path).startswith("libz.so"):
                    return path
    except OSError:
        pass
    return "-lz"


def _has_zlib_header(cxx: str) -> bool:
    out = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                         input="#include <zlib.h>\n", capture_output=True,
                         text=True)
    return out.returncode == 0


def _so_path(cxx: str, link: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(NATIVE.iterdir()):
        if p.suffix in (".cpp", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join([*CXXFLAGS, cxx, link]).encode())
    return BUILD_DIR / f"libvdbio-{h.hexdigest()[:16]}.so"


def _build(cxx: str, link: str, so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, *(str(NATIVE / s) for s in SOURCES),
           "-o", str(tmp), link]
    out = subprocess.run(cmd, capture_output=True, text=True)
    log = dict(command=" ".join(cmd), output=out.stdout + out.stderr,
               zlib=link, zlib_header=_has_zlib_header(cxx))
    if out.returncode == 0:
        os.replace(tmp, so)  # atomic: a reader never sees a partial file
    else:
        tmp.unlink(missing_ok=True)
    tmp_log = tmp.with_suffix(".json")
    tmp_log.write_text(json.dumps(log, indent=1))
    os.replace(tmp_log, so.with_suffix(".json"))
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native volume I/O "
                           f"library (exit {out.returncode}):\n{out.stderr}")


def lib() -> ctypes.CDLL:
    """Build (once per source hash) and load the library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        link = zlib_link()
        so = _so_path(cxx, link)
        log = so.with_suffix(".json")
        if not (so.exists() and log.exists()):
            _build(cxx, link, so)
        log = json.loads(log.read_text())
        build_info.update(path=str(so), zlib=log["zlib"],
                          zlib_header=log["zlib_header"])
        L = ctypes.CDLL(str(so))
        c_int, c_i64, c_char_p = ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_f32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
        c_u8pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_dp = ctypes.POINTER(ctypes.c_double)
        sigs = {
            "vdbio_read_nvdb": [c_char_p, c_int, c_f32pp, c_i64p, c_i32p,
                                c_dp, c_dp, c_char_p, c_int, c_char_p, c_int],
            "vdbio_dense_from_blob": [c_char_p, c_i64, c_f32pp, c_i64p,
                                      c_i32p, c_dp, c_dp, c_char_p, c_int],
            "vdbio_write_nvdb": [c_char_p, ctypes.c_void_p, c_i32p, c_dp,
                                 c_dp, c_char_p, c_int, c_char_p, c_int],
            "vdbio_blob_from_dense": [ctypes.c_void_p, c_i32p, c_dp, c_dp,
                                      c_char_p, c_u8pp, c_i64p],
            "vdbio_read_vdb": [c_char_p, c_char_p, c_f32pp, c_i64p, c_i32p,
                               c_dp, c_dp, c_char_p, c_int, c_char_p, c_int],
            "vdbio_write_vdb": [c_char_p, c_int, c_f32pp, c_i64p, c_i32p,
                                c_dp, c_dp, ctypes.POINTER(c_char_p),
                                ctypes.c_uint32, c_char_p, c_int],
            "vdbio_write_png": [c_char_p, ctypes.c_void_p, ctypes.c_int32,
                                ctypes.c_int32, c_char_p, c_int],
        }
        for name, argtypes in sigs.items():
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = c_int
        L.vdbio_free.argtypes = [ctypes.c_void_p]
        L.vdbio_free.restype = None
        _lib = L
        return L


def free(ptr) -> None:
    """Release a buffer the library allocated."""
    lib().vdbio_free(ptr)


def _out_args():
    """(data pointer, count, bbox, mat, vec) output slots of a read."""
    return (ctypes.POINTER(ctypes.c_float)(), ctypes.c_int64(),
            (ctypes.c_int32 * 6)(), (ctypes.c_double * 9)(),
            (ctypes.c_double * 3)())


def _unpack_dense(data_p, n, bbox, mat, vec):
    nx = bbox[3] - bbox[0] + 1
    ny = bbox[4] - bbox[1] + 1
    nz = bbox[5] - bbox[2] + 1
    if nx * ny * nz != n.value:
        free(data_p)
        raise IOError(f"native reader returned {n.value} voxels for a "
                      f"{nx}x{ny}x{nz} bbox")
    arr = np.ctypeslib.as_array(data_p, shape=(n.value,)).reshape(nx, ny, nz)
    out = np.array(arr, np.float32)  # copy before freeing
    free(data_p)
    return (
        out,
        np.array(bbox[:3], np.int32),
        np.array(mat[:9], np.float64).reshape(3, 3),
        np.array(vec[:3], np.float64),
    )


def read_nvdb(path: str, grid_index: int = 0):
    """Read a .nvdb file -> (dense (nx,ny,nz) f32, bbox_min, mat, vec, name)."""
    L = lib()
    data_p, n, bbox, mat, vec = _out_args()
    name = ctypes.create_string_buffer(256)
    err = ctypes.create_string_buffer(512)
    rc = L.vdbio_read_nvdb(
        str(path).encode(), grid_index, ctypes.byref(data_p),
        ctypes.byref(n), bbox, mat, vec, name, 256, err, 512,
    )
    if rc:
        raise IOError(f"read_nvdb({path}): {err.value.decode()}")
    dense, bmin, m, v = _unpack_dense(data_p, n, bbox, mat, vec)
    return dense, bmin, m, v, name.value.decode()


def read_vdb(path: str, grid_name: str | None = None):
    """Read an OpenVDB .vdb file -> (dense (nx,ny,nz) f32, bbox_min, mat,
    vec, name).  ``grid_name``: pick a grid by name; None takes the first
    FloatGrid."""
    L = lib()
    data_p, n, bbox, mat, vec = _out_args()
    name = ctypes.create_string_buffer(256)
    err = ctypes.create_string_buffer(512)
    rc = L.vdbio_read_vdb(
        str(path).encode(), (grid_name or "").encode(), ctypes.byref(data_p),
        ctypes.byref(n), bbox, mat, vec, name, 256, err, 512,
    )
    if rc:
        raise IOError(f"read_vdb({path}): {err.value.decode()}")
    dense, bmin, m, v = _unpack_dense(data_p, n, bbox, mat, vec)
    return dense, bmin, m, v, name.value.decode()


def dense_from_blob(blob: bytes):
    """Parse an in-memory NanoVDB grid blob -> (dense, bbox_min, mat, vec)."""
    L = lib()
    data_p, n, bbox, mat, vec = _out_args()
    err = ctypes.create_string_buffer(512)
    rc = L.vdbio_dense_from_blob(
        blob, len(blob), ctypes.byref(data_p), ctypes.byref(n), bbox, mat,
        vec, err, 512,
    )
    if rc:
        raise IOError(f"dense_from_blob: {err.value.decode()}")
    return _unpack_dense(data_p, n, bbox, mat, vec)


def _map_args(dense, bbox_min, mat, vec):
    bbox = (ctypes.c_int32 * 6)(
        *[int(b) for b in bbox_min],
        *[int(bbox_min[i]) + dense.shape[i] - 1 for i in range(3)],
    )
    if mat is None:
        mat = np.eye(3)
    m = (ctypes.c_double * 9)(*np.asarray(mat, np.float64).reshape(-1))
    v = (ctypes.c_double * 3)(*np.asarray(vec, np.float64))
    return bbox, m, v


def write_nvdb(path: str, dense: np.ndarray, bbox_min=(0, 0, 0), mat=None,
               vec=(0.0, 0.0, 0.0), grid_name: str = "density",
               codec: str = "zip") -> None:
    """Write a dense array as a single-grid .nvdb file (float fog volume);
    ``codec``: "none" or "zip"."""
    L = lib()
    dense = np.ascontiguousarray(dense, np.float32)
    bbox, m, v = _map_args(dense, bbox_min, mat, vec)
    err = ctypes.create_string_buffer(512)
    codec_id = {"none": 0, "zip": 1}[codec]
    rc = L.vdbio_write_nvdb(
        str(path).encode(), dense.ctypes.data_as(ctypes.c_void_p), bbox, m,
        v, grid_name.encode(), codec_id, err, 512,
    )
    if rc:
        raise IOError(f"write_nvdb({path}): {err.value.decode()}")


def write_vdb(path: str, grids, compression: str = "zip+mask") -> None:
    """Write an OpenVDB ``.vdb`` file.

    ``grids``: one tuple or a list of tuples ``(dense (nx,ny,nz) f32,
    bbox_min, mat 3x3 | None, vec, name)``; several make a multi-grid file.
    ``compression``: "none" | "zip" | "zip+mask" | "blosc" | "blosc+mask",
    each optionally with "+half" (value buffers stored as binary16)."""
    L = lib()
    if isinstance(grids, tuple):
        grids = [grids]
    flags = 0
    for word, bit in (("zip", 1), ("mask", 2), ("blosc", 4), ("half", 8)):
        if word in compression:
            flags |= bit
    n = len(grids)
    keep = []  # the contiguous arrays stay alive for the call
    datas = (ctypes.POINTER(ctypes.c_float) * n)()
    dims = (ctypes.c_int64 * (3 * n))()
    bmins = (ctypes.c_int32 * (3 * n))()
    mats = (ctypes.c_double * (9 * n))()
    vecs = (ctypes.c_double * (3 * n))()
    names = (ctypes.c_char_p * n)()
    for i, (dense, bbox_min, mat, vec, name) in enumerate(grids):
        dense = np.ascontiguousarray(dense, np.float32)
        keep.append(dense)
        datas[i] = dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        dims[3 * i: 3 * i + 3] = [int(s) for s in dense.shape]
        bmins[3 * i: 3 * i + 3] = [int(b) for b in bbox_min]
        m = np.eye(3) if mat is None else np.asarray(mat, np.float64)
        mats[9 * i: 9 * i + 9] = list(m.reshape(-1))
        vecs[3 * i: 3 * i + 3] = list(np.asarray(vec, np.float64))
        names[i] = name.encode()
    err = ctypes.create_string_buffer(512)
    rc = L.vdbio_write_vdb(str(path).encode(), n, datas, dims, bmins, mats,
                           vecs, names, flags, err, 512)
    if rc:
        raise IOError(f"write_vdb({path}): {err.value.decode()}")


def blob_from_dense(dense: np.ndarray, bbox_min=(0, 0, 0), mat=None,
                    vec=(0.0, 0.0, 0.0), grid_name: str = "density") -> bytes:
    """Build an in-memory NanoVDB grid blob from a dense array."""
    L = lib()
    dense = np.ascontiguousarray(dense, np.float32)
    bbox, m, v = _map_args(dense, bbox_min, mat, vec)
    blob_p = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    rc = L.vdbio_blob_from_dense(
        dense.ctypes.data_as(ctypes.c_void_p), bbox, m, v, grid_name.encode(),
        ctypes.byref(blob_p), ctypes.byref(n),
    )
    if rc:
        raise IOError("blob_from_dense failed")
    out = bytes(np.ctypeslib.as_array(blob_p, shape=(n.value,)))
    free(blob_p)
    return out
