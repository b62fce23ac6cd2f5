"""Image quality metrics; the port of supnerf_tpu/eval/metrics.py.

ssim is skimage.metrics.structural_similarity's default for float images
(a 7 x 7 uniform window, C1 = (0.01 L)^2, C2 = (0.03 L)^2, L = data_range,
the sample covariance, the window's half-width cropped from the mean), the
reference's SSIM log (optimizer_nuscenes.py:18,1657-1666). The window
filter is scipy.ndimage.uniform_filter with mode "reflect", which repeats
the edge sample (numpy's "symmetric"; torch's "reflect" padding does not).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, channel_axis: int | None = None) -> float:
    """Mean structural similarity of two float images (H, W) or (H, W, C)
    (the channels' mean; a 3-D image's last axis is its channels)."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if channel_axis is None and img1.ndim == 3:
        channel_axis = -1
    if channel_axis is not None:
        return float(np.mean([
            ssim(np.take(img1, c, axis=channel_axis), np.take(img2, c, axis=channel_axis),
                 data_range=data_range, win_size=win_size)
            for c in range(img1.shape[channel_axis])]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size ** img1.ndim
    cov_norm = n / (n - 1)

    def mean(x):
        return uniform_filter(x, size=win_size, mode="reflect")

    ux, uy = mean(img1), mean(img2)
    vx = cov_norm * (mean(img1 * img1) - ux * ux)
    vy = cov_norm * (mean(img2 * img2) - uy * uy)
    vxy = cov_norm * (mean(img1 * img2) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[tuple(slice(pad, d - pad) for d in s.shape)].mean())


def psnr_from_mse(mse: float) -> float:
    return float(-10.0 * np.log(mse) / np.log(10.0))
