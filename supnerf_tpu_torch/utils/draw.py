"""The two OpenCV drawing calls of the TTO panels, in numpy: cv2.line at
thickness 1 with 8-connected lines, and cv2.putText with
FONT_HERSHEY_SIMPLEX (supnerf_tpu/utils/vis.py render_box and
panel_rgb_depth_gt). Both give cv2 5.0's pixels exactly
(tests/test_torch_vis.py holds them to it).

line: OpenCV's integer line (imgproc drawing.cpp Line): the segment is
clipped to the image (clipLine, with its truncating float intercepts), run
left to right, and walked by the 8-connected LineIterator, dx + 1 pixels
along the major axis with the Bresenham error err = dx - 2 dy.

put_text: OpenCV 5 draws the Hershey font faces with its built-in sans font
(Rubik), anti-aliased. fontScale s gives the font size round(s * 1000 / 37)
pixels, thickness 1 the weight 400 and thickness 2 or more 600; each glyph
is blended on its own at a whole-pixel pen position as (bg * (255 - a) +
color * a + 127) // 255, a its 8-bit coverage, and the pen moves on by the
glyph's whole-pixel advance. The coverage bitmaps are utils/glyphs.py's
(written by tests/fixtures/make_glyphs.py) at the sizes of the panels of
vis_im_sz 64, 128 and 256 (sizes 5 and 9 at weight 400, 19 at 600), for the
characters their format strings print; other sizes and characters raise.
Thicker lines are queued in ROADMAP.md (A.8).
"""
from __future__ import annotations

import numpy as np

from supnerf_tpu_torch.utils.glyphs import GLYPHS


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine on the image rect [0, w) x [0, h): the clipped
    end points, or None when the segment misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if c1 | c2 else (x1, y1, x2, y2)


def _color(img: np.ndarray, color) -> np.ndarray:
    """A colour as the image stores it (cv2's saturate_cast: rounded and
    clipped for uint8)."""
    c = np.asarray(color, np.float64)
    if img.dtype == np.uint8:
        c = np.clip(np.rint(c), 0, 255)
    return c.astype(img.dtype)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_8) in place on an
    (H, W[, C]) image; the points are integers (x, y)."""
    if thickness != 1:
        raise NotImplementedError("lines thicker than 1 are queued in ROADMAP.md (A.8)")
    h, w = img.shape[:2]
    x1, y1, x2, y2 = int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return img
        x1, y1, x2, y2 = clipped
    if x2 < x1:                                 # walk left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, step = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, step = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    n = dx + 1
    major, minor = np.empty(n, np.int64), np.empty(n, np.int64)
    err, m = dx - 2 * dy, 0
    for i in range(n):
        major[i], minor[i] = i, m
        if err < 0:
            m += 1
            err += 2 * dx
        err -= 2 * dy
    if vert:
        xs, ys = x1 + minor, y1 + step * major
    else:
        xs, ys = x1 + major, y1 + step * minor
    img[ys, xs] = _color(img, color)
    return img


def font_face(font_scale: float, thickness: int) -> tuple:
    """(font size in pixels, weight) of cv2.putText's FONT_HERSHEY_SIMPLEX
    at this scale and thickness."""
    return round(font_scale * 1000.0 / 37.0), (400 if thickness <= 1 else 600)


def put_text(img: np.ndarray, text: str, org, font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, font_scale,
    color, thickness) in place on an (H, W, C) uint8 image; org is the left
    end of the baseline."""
    face = font_face(font_scale, thickness)
    if face not in GLYPHS:
        raise NotImplementedError(f"font size {face[0]} at weight {face[1]}: the port has the "
                                  f"glyphs of {sorted(GLYPHS)} (utils/glyphs.py)")
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"put_text draws on (H, W, C) uint8 images, got {img.dtype} {img.shape}")
    glyphs = GLYPHS[face]
    missing = sorted(set(text) - set(glyphs))
    if missing:
        raise ValueError(f"put_text has no glyph for {missing}")
    col = _color(img, color).astype(np.int64)
    h, w = img.shape[:2]
    pen_x, base_y = int(org[0]), int(org[1])
    for ch in text:
        advance, dx, dy, gw, hexrows = glyphs[ch]
        if gw:
            cov = np.frombuffer(bytes.fromhex(hexrows), np.uint8).reshape(-1, gw)
            x0, y0 = pen_x + dx, base_y + dy
            xa, ya = max(x0, 0), max(y0, 0)
            xb, yb = min(x0 + gw, w), min(y0 + cov.shape[0], h)
            if xa < xb and ya < yb:
                a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int64)[..., None]
                bg = img[ya:yb, xa:xb].astype(np.int64)
                img[ya:yb, xa:xb] = (bg * (255 - a) + col * a + 127) // 255
        pen_x += advance
    return img
