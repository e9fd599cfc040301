"""PPM/PNG image output (twin of volumerenderer_tpu.io.ppm; parity with
CPU_test's writer, CPU_test/main.cpp:128-132).  PNG goes through the
native encoder (native/imageio.cpp, zlib)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..grid import vdbio_native


def write_ppm(path: str, image_u8: np.ndarray) -> None:
    """Binary P6 PPM. ``image_u8``: (H, W, 3) or (H, W) uint8."""
    img = np.asarray(image_u8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img[..., :3].tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM (as written here, no comments) -> (H, W, 3)
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(maxsplit=4)
    if parts[0] != b"P6":
        raise ValueError("not a P6 PPM")
    w, h, maxval = int(parts[1]), int(parts[2]), int(parts[3])
    if maxval != 255:
        raise ValueError("only maxval 255 supported")
    raw = parts[4][: w * h * 3]
    return np.frombuffer(raw, np.uint8).reshape(h, w, 3)


def write_png(path: str, image_u8: np.ndarray) -> None:
    """PNG (RGB8) through the native encoder, whatever the path's suffix.
    ``image_u8``: (H, W, 3) or (H, W) uint8."""
    img = np.asarray(image_u8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    err = ctypes.create_string_buffer(256)
    rc = vdbio_native.lib().vdbio_write_png(
        str(path).encode(), img.ctypes.data_as(ctypes.c_void_p), w, h, err,
        256)
    if rc:
        raise IOError(f"write_png({path}): {err.value.decode()}")
