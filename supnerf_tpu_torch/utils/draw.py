"""The OpenCV drawing calls of the panels and the dataset QA images, in
numpy: cv2.line (LINE_8, any thickness), cv2.circle (LINE_8, filled or
thickness 1), cv2.rectangle (LINE_8) and cv2.putText with
FONT_HERSHEY_SIMPLEX (supnerf_tpu/utils/vis.py, supnerf_tpu/data/debug.py).
They give cv2 5.0's pixels exactly (tests/test_torch_vis.py and
tests/test_torch_qa.py hold them to it), on uint8 and float32 images; a
colour is stored as cv2 stores it (_color).

line at thickness 1: OpenCV's integer line (imgproc drawing.cpp Line): the
segment is clipped to the image (clipLine, with its truncating float
intercepts), run left to right, and walked by the 8-connected
LineIterator, dx + 1 pixels along the major axis with the Bresenham error
err = dx - 2 dy.

line at thickness t >= 2: the segment clipped to the image grown by t on
every side (clipLine; cv2 5.0.0's pixels show it does so), then OpenCV's
ThickLine in 16-bit fixed point (XY_SHIFT 16): the segment's rectangle,
offset by round(t/2 * n) along its normal n, filled by FillConvexPoly
(the edges drawn by Line2, the 64-bit fixed-point line, and the scanlines
between the two active edges, stepped by a rounded per-line increment from
each edge's starting vertex), and a filled circle of radius (t + 1) // 2
at each end (the round caps).

circle: OpenCV's Circle, the midpoint walk over one octant; filled
(thickness -1) it sets the horizontal spans between the walk's points,
else the points themselves. Every pixel outside the image is dropped.

rectangle: the closed polyline of the four corners, each side a ThickLine
with a cap at its end only (PolyLine's flags).

put_text: OpenCV 5 draws the Hershey font faces with its built-in sans font
(Rubik), anti-aliased. fontScale s gives the font size round(s * 1000 / 37)
pixels, thickness 1 the weight 400 and thickness 2 or more 600; each glyph
is blended on its own at a whole-pixel pen position as (bg * (255 - a) +
color * a + 127) // 255, a its 8-bit coverage, and the pen moves on by the
glyph's whole-pixel advance. The coverage bitmaps are utils/glyphs.py's
(written by tests/fixtures/make_glyphs.py) at the sizes of the panels of
vis_im_sz 64, 128 and 256 (sizes 5 and 9 at weight 400, 19 at 600), for the
characters their format strings print; other sizes and characters raise.
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


XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, col) -> None:
    """The thickness-1 LINE_8 line between integer points, clipped."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
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
    img[ys, xs] = col


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(img: np.ndarray, p1, p2, col) -> None:
    """OpenCV's Line2: the line between two XY_SHIFT fixed-point points,
    clipped to the scaled image, one pixel per step of the major axis
    (its starting point's fraction kept on the minor axis) and the end
    point's pixel."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    i = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + i
        ys = (y1 + i * y_step) >> XY_SHIFT
    else:
        xs = (x1 + i * x_step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + i
    xs = np.append(xs, (x2 + (XY_ONE >> 1)) >> XY_SHIFT)
    ys = np.append(ys, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = col


def _fill_convex_poly(img: np.ndarray, v, col) -> None:
    """OpenCV's FillConvexPoly at LINE_8 on XY_SHIFT fixed-point vertices:
    the edges by Line2, then one span a scanline between the two edges
    that run down from the top vertex."""
    h, w = img.shape[:2]
    npts, delta = len(v), XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, col)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = int(np.argmin(ys))                   # the first of the lowest y
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges, y = npts, ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        e["ye"], e["x"], e["idx"] = ty, xs0, idx
                        e["dx"] = _tdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0, idx = idx, (idx + e["di"]) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = col
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_offsets(radius: int, fill: bool):
    """The (dx, dy) offsets of OpenCV's Circle of this radius about its
    centre: the midpoint walk's points, or with fill the spans between
    them."""
    pts = set()
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for a, b in ((dx, dy), (dy, dx)):     # rows +-b span -a..a
            for yy in (-b, b):
                if fill:
                    pts.update((x, yy) for x in range(-a, a + 1))
                else:
                    pts.update(((-a, yy), (a, yy)))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.array(sorted(pts), np.int64).reshape(-1, 2)


def _thick_line(img: np.ndarray, p0, p1, thickness: int, col, flags: int) -> None:
    """OpenCV's ThickLine at LINE_8 for thickness >= 2 on integer points;
    flags bit 0 caps p0, bit 1 caps p1."""
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx, ddy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                                (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)], col)
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            circles(img, [((p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)],
                    (t + (XY_ONE >> 1)) >> XY_SHIFT, [col], -1)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_8) in place on an
    (H, W[, C]) image; the points are integers (x, y)."""
    if thickness < 1:
        raise ValueError(f"line thickness {thickness}: 1 or more")
    x1, y1, x2, y2 = int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])
    if thickness == 1:
        _line8(img, x1, y1, x2, y2, _color(img, color))
        return img
    # cv2 5.0.0 first clips a thick line to the image grown by the thickness
    # on every side (its pixels show it: tests/test_torch_qa.py)
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, x1 + t, y1 + t, x2 + t, y2 + t)
    if clipped is not None:
        x1, y1, x2, y2 = (c - t for c in clipped)
        _thick_line(img, (x1, y1), (x2, y2), thickness, _color(img, color), 3)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """cv2.circle(img, center, radius, color, thickness, cv2.LINE_8) in place:
    thickness -1 (filled) or 1."""
    return circles(img, [(int(center[0]), int(center[1]))], radius, [color], thickness)


def circles(img: np.ndarray, centers, radius: int, colors, thickness: int = 1) -> np.ndarray:
    """cv2.circle called once per row of centers (N, 2) with colors (N, C)
    in order, in place: where circles overlap, the later one's colour
    stays."""
    if thickness not in (-1, 1):
        raise NotImplementedError(f"circle thickness {thickness}: the port draws -1 (filled) "
                                  "and 1, the thicknesses the JAX package calls")
    centers = np.asarray(centers, np.int64).reshape(-1, 2)
    h, w = img.shape[:2]
    off = _circle_offsets(int(radius), thickness < 0)
    xs = (centers[:, 0:1] + off[None, :, 0]).ravel()
    ys = (centers[:, 1:2] + off[None, :, 1]).ravel()
    order = np.repeat(np.arange(len(centers)), len(off))
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat, order = (ys * w + xs)[keep], order[keep]
    if not len(flat):
        return img
    idx = np.lexsort((order, flat))               # by pixel, then drawing order
    flat, order = flat[idx], order[idx]
    last = np.append(flat[1:] != flat[:-1], True)
    cols = np.asarray(colors, np.float64).reshape(len(centers), -1)
    img.reshape(h * w, -1)[flat[last]] = _color(img, cols[order[last]])
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness, cv2.LINE_8) in place:
    its four sides as a closed polyline, thickness 1 or more."""
    if thickness < 1:
        raise NotImplementedError(f"rectangle thickness {thickness}: the port draws outlines")
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    col = _color(img, color)
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    prev = corners[-1]
    for p in corners:
        if thickness == 1:
            _line8(img, prev[0], prev[1], p[0], p[1], col)
        else:
            _thick_line(img, prev, p, thickness, col, 2)
        prev = p
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
