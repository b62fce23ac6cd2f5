"""ROI and image pre-processing for the host side of the TTO prep and the
readers and the visualisation (numpy in, numpy out); the port of the
helpers of supnerf_tpu/geometry/roi.py that they use. The bilinear resize
runs through torch.nn.functional.interpolate on CPU tensors, so no OpenCV
is needed; resize_linear is jax.image.resize(method="linear")'s
separable triangle filter."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def roi_process(roi, H=None, W=None, roi_margin: int = 0, sq_pad: bool = False):
    """Grow an [xmin, ymin, xmax, ymax] ROI by a margin, optionally pad it to a
    square, and clip it to the image. Integer in and out."""
    roi_new = np.asarray(roi, dtype=np.float64).copy()
    roi_new[0:2] -= roi_margin
    roi_new[2:4] += roi_margin
    if sq_pad:
        cx = (roi_new[0] + roi_new[2]) / 2
        cy = (roi_new[1] + roi_new[3]) / 2
        sz = np.maximum(roi_new[2] - roi_new[0], roi_new[3] - roi_new[1])
        roi_new[0], roi_new[2] = cx - sz / 2, cx + sz / 2
        roi_new[1], roi_new[3] = cy - sz / 2, cy + sz / 2
    if H is not None and W is not None:
        roi_new[0:2] = np.maximum(roi_new[0:2], 0)
        roi_new[2] = np.minimum(roi_new[2], W - 1)
        roi_new[3] = np.minimum(roi_new[3], H - 1)
    return roi_new.astype(np.int32)


def roi_resize(roi, ratio: float = 1.0):
    """Scale an [xmin, ymin, xmax, ymax] ROI about its centre by `ratio`
    (floats out)."""
    min_x, min_y, max_x, max_y = [float(v) for v in roi]
    cx, cy = (min_x + max_x) / 2, (min_y + max_y) / 2
    bw, bh = max_x - min_x, max_y - min_y
    return [cx - bw / 2 * ratio, cy - bh / 2 * ratio, cx + bw / 2 * ratio, cy + bh / 2 * ratio]


def roi_coord_trans(x_vec, y_vec, roi_src, im_sz_tgt: int):
    """Map pixel coordinates in a source ROI crop to the resized
    im_sz_tgt square (reference utils.py:1384)."""
    roi_w = roi_src[2] - roi_src[0]
    roi_h = roi_src[3] - roi_src[1]
    x_new = (x_vec - roi_w / 2) / roi_w * im_sz_tgt + im_sz_tgt / 2
    y_new = (y_vec - roi_h / 2) / roi_h * im_sz_tgt + im_sz_tgt / 2
    return x_new, y_new


def _linear_weights(n_in: int, n_out: int, antialias: bool) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.scale_and_translate's triangle
    kernel, in its float32 arithmetic: half-pixel centres, the kernel
    widened by the downscale factor with antialias, each row renormalised
    to sum 1 (so the image edge reweights rather than pads), rows whose
    sample lies outside the input zero."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[:, None] - np.arange(n_in, dtype=f32)[None, :]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - dist)
    total = w.sum(1, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(np.float64)


def resize_linear(img: np.ndarray, out_hw, antialias: bool = True) -> np.ndarray:
    """jax.image.resize(img, out_hw + img.shape[2:], method="linear",
    antialias=antialias) on an (H, W[, C]) image: upsampling is
    half-pixel-centre bilinear, downsampling with antialias a widened
    triangle. Returns float32."""
    img = np.asarray(img, np.float64)
    wy = _linear_weights(img.shape[0], int(out_hw[0]), antialias)
    wx = _linear_weights(img.shape[1], int(out_hw[1]), antialias)
    return np.einsum("ph,hw...,qw->pq...", wy, img, wx).astype(np.float32)


def resize_bilinear_np(img: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear resize with half-pixel centres and no antialiasing, the
    sampling of cv2.INTER_LINEAR and torchvision's tensor Resize.
    img (H, W, C) or (H, W) -> (out_h, out_w[, C]) float32."""
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    chw = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(int(out_hw[0]), int(out_hw[1])), mode="bilinear",
                        align_corners=False, antialias=False)[0]
    out = out[0] if x.ndim == 2 else out.permute(1, 2, 0)
    return out.contiguous().numpy()


def preprocess_img_square(img: np.ndarray, new_size: int = 128) -> np.ndarray:
    """Resize the longer side to new_size and centre the image on a white
    new_size square. img (H, W, 3) in [0, 1] -> (new_size, new_size, 3)."""
    im_h, im_w = img.shape[:2]
    ratio = new_size / max(im_h, im_w)
    new_h, new_w = int(im_h * ratio), int(im_w * ratio)
    resized = resize_bilinear_np(img, (new_h, new_w))
    out = np.ones((new_size, new_size, 3), dtype=np.float32)
    y0 = int(new_size / 2 - new_h / 2)
    x0 = int(new_size / 2 - new_w / 2)
    out[y0:y0 + new_h, x0:x0 + new_w] = resized.reshape(new_h, new_w, -1)[:, :, :3]
    return out


def crop_and_whiten(img: np.ndarray, mask_occ: np.ndarray, roi) -> tuple:
    """Crop the image and occupancy mask to an ROI and paint everything that
    is not foreground white. Returns (img_crop (h, w, 3), mask_crop (h, w, 1))."""
    x0, y0, x1, y1 = [int(v) for v in roi]
    img_c = np.asarray(img, np.float32)[y0:y1, x0:x1].copy()
    mask_c = np.asarray(mask_occ, np.float32)[y0:y1, x0:x1][..., None]
    return img_c * (mask_c > 0) + (mask_c <= 0), mask_c
