"""Windowed SSIM for golden-image acceptance (the reference package's
utils.ssim, copied so the port scores images without JAX)."""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win: int = 7) -> float:
    """Mean structural similarity of two grayscale images (float arrays)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = uniform_filter(a, win)
    mu_b = uniform_filter(b, win)
    saa = uniform_filter(a * a, win) - mu_a**2
    sbb = uniform_filter(b * b, win) - mu_b**2
    sab = uniform_filter(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    return float(np.mean(num / den))
