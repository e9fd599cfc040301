"""Build and load the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into
``<checkout>/build/kernels/`` under a file name that carries a hash of the
source, the flags and the compiler, then loaded with ``ctypes``.  ``build``
starts one nvcc per missing source, all at once.  A missing compiler or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# -fmad=false: no multiply-add pair is contracted into an FMA, so the
# exact tier rounds term for term like the reference.  No fast math:
# divides and square roots stay IEEE.  (The staged sums and the closed-form
# VRL term of csrc/gather_terms.cuh take explicit FMAs and approximate
# reciprocals and roots, as that header states.)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # kernel name -> compiler output


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source at first use and need the CUDA toolkit"
    )


def _so_path(name: str, nvcc: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile the missing ``csrc/<name>.cu`` libraries, one nvcc process
    each, all started together; raises if any fails."""
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        so = _so_path(name, nvcc)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    so = _so_path(name, nvcc_path())
    log = so.with_suffix(".log")
    build_logs[name] = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
