"""Build and load the port's CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C entry point.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into
``<checkout>/build/kernels/`` under a file name that carries a hash of the
source, the flags and the compiler, then loaded with ``ctypes``.  A missing
compiler or a failed build raises.
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
# divides and square roots stay IEEE.
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


def library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    headers = sorted(CSRC.glob("*.cuh"))
    nvcc = nvcc_path()
    h = hashlib.sha256()
    for p in [src, *headers]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a reader never sees a partial file
    build_logs[name] = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib
