"""The TTO visualisation panels, in numpy; the port of the helpers of
supnerf_tpu/utils/vis.py that the driver uses (reference utils.py:
render_box :1200 and the optimizer's save_img3 panel layout :1597-1641,
save_virtual_img :1643-1655). The drawing is utils/draw.py's, which gives
cv2's pixels."""
from __future__ import annotations

import numpy as np

from supnerf_tpu_torch.utils.draw import line, put_text


def render_box(im: np.ndarray, corners_2d: np.ndarray,
               colors=((0, 0, 1), (1, 0, 0), (0, 0, 0)), linewidth: int = 2) -> np.ndarray:
    """Draw a projected 3D box's wireframe on a contiguous copy of im.
    corners_2d: (2 or 3, 8), the first four corners the front face; colors
    (front, rear, sides) as RGB, drawn channel-reversed as cv2's BGR; the
    corners truncate toward zero. The heading tick runs from the bottom's
    centre to the bottom-front edge's centre. Returns the copy."""
    im = np.ascontiguousarray(im)

    def pt(c):
        return int(c[0]), int(c[1])

    def draw_rect(pts, color):
        prev = pts[-1]
        for corner in pts:
            line(im, pt(prev), pt(corner), color, linewidth)
            prev = corner

    c = np.asarray(corners_2d).T
    for i in range(4):
        line(im, pt(c[i]), pt(c[i + 4]), tuple(colors[2])[::-1], linewidth)
    draw_rect(c[:4], tuple(colors[0])[::-1])
    draw_rect(c[4:], tuple(colors[1])[::-1])
    front = np.mean(c[2:4], axis=0)
    bottom = np.mean(c[[2, 3, 7, 6]], axis=0)
    line(im, pt(bottom), pt(front), tuple(colors[0])[::-1], linewidth)
    return im


def normalize_for_vis(img: np.ndarray) -> np.ndarray:
    """Z-normalise, then min-max to [0, 1] (the depth panel's normalisation,
    reference optimizer_nuscenes.py:1607-1609)."""
    img = np.asarray(img, np.float64)
    img = (img - img.mean()) / (img.std() + 1e-9)
    img = img - img.min()
    return img / (img.max() - img.min() + 1e-9)


def panel_rgb_depth_gt(rendered: np.ndarray, depth: np.ndarray, gt: np.ndarray,
                       psnr=None, depth_err=None, rot_err=None, trans_err=None) -> np.ndarray:
    """[render | normalised depth | target] uint8 panel, (H, 3W, 3), with the
    metrics printed in black at the top left."""
    H, W = rendered.shape[:2]
    out = np.zeros((H, 3 * W, 3), np.float32)
    out[:, :W] = np.clip(rendered, 0, 1)
    out[:, W:2 * W] = np.repeat(normalize_for_vis(depth)[..., None], 3, axis=-1)
    out[:, 2 * W:] = np.clip(gt, 0, 1)
    out = (out * 255).astype(np.uint8)
    ratio = H / 128
    thickness = max(int(ratio), 1)
    if psnr is not None and depth_err is not None:
        put_text(out, f"PSNR: {psnr:.3f},  DE: {depth_err:.3f}",
                 (int(5 * ratio), int(10 * ratio)), 0.35 * ratio, (0, 0, 0), thickness)
    if rot_err is not None and trans_err is not None:
        put_text(out, f"RE: {rot_err:.3f},  TE: {trans_err:.3f}",
                 (int(5 * ratio), int(21 * ratio)), 0.35 * ratio, (0, 0, 0), thickness)
    return out


def virtual_view_sheet(views: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) ring of virtual views -> a two-row uint8 sheet, the
    second row padded white when N is odd."""
    n, H, W = views.shape[:3]
    half = (n + 1) // 2
    rows = []
    for r in range(2):
        imgs = views[r * half:(r + 1) * half]
        if len(imgs) < half:
            pad = np.ones((half - len(imgs), H, W, 3), views.dtype)
            imgs = np.concatenate([imgs, pad]) if len(imgs) else pad
        rows.append(np.concatenate(list(imgs), axis=1))
    sheet = np.concatenate(rows, axis=0)
    return (np.clip(sheet, 0, 1) * 255).astype(np.uint8)
