"""Writes nusc_cam_1600x900.jpg beside this file: a synthetic street scene
at nuScenes' camera size, saved by PIL as a baseline 4:2:0 JPEG at its
default quality (75); with --progressive, nusc_cam_1600x900_progressive.jpg
instead: the same scene saved as a progressive JPEG (PIL's progressive=True,
libjpeg's simple progression script), the same sampling and quality.

    python tests/fixtures/make_nusc_cam.py [--progressive]

The committed files are the ones the tests and chip_smoke.py decode; running
this again with another PIL or numpy may write other bytes, and the pinned
hashes of their decoded pixels (tests/test_torch_image_io.py) then change.
"""
import os
import sys

import numpy as np
from PIL import Image

H, W = 900, 1600


def street_scene(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float64)
    img = np.zeros((H, W, 3))
    horizon = 380
    # sky: a vertical gradient
    t = yy / horizon
    img[:] = np.stack([110 + 80 * t, 160 + 60 * t, 235 - 20 * t], -1)
    # buildings with rows of windows
    x = 0
    while x < W:
        bw = int(rng.integers(120, 260))
        top = int(rng.integers(80, 300))
        colour = rng.integers(70, 200, 3)
        img[top:horizon + 40, x:x + bw] = colour
        for wy in range(top + 20, horizon, 45):
            for wx in range(x + 15, x + bw - 25, 40):
                lit = rng.random() >= 0.7
                img[wy:wy + 22, wx:wx + 18] = (230, 210, 140) if lit else (40, 60, 90)
        x += bw + int(rng.integers(0, 30))
    # road: a trapezoid widening towards the camera, with lane dashes
    below = yy >= horizon + 40
    half = (yy - horizon) / (H - horizon) * W * 0.75
    road = below & (np.abs(xx - W / 2) < half)
    img[road] = (95, 95, 100)
    img[below & ~road] = (120, 140, 90)
    for k in range(8):
        y0 = horizon + 60 + 60 * k
        dash = (yy >= y0) & (yy < y0 + 25 + 4 * k) & (np.abs(xx - W / 2) < 3 + k)
        img[dash] = (235, 235, 225)
    # three cars: body, windows, wheels
    for cx, cy, s, colour in ((520, 640, 1.0, (180, 30, 35)), (1050, 600, 0.8, (30, 60, 160)),
                              (800, 760, 1.4, (210, 210, 215))):
        bw, bh = 260 * s, 110 * s
        body = (np.abs(xx - cx) < bw / 2) & (yy > cy - bh / 2) & (yy < cy + bh / 2)
        img[body] = colour
        cabin = (np.abs(xx - cx) < bw / 3) & (yy > cy - bh) & (yy <= cy - bh / 2)
        img[cabin] = np.asarray(colour) * 0.8
        glass = (np.abs(xx - cx) < bw / 3.6) & (yy > cy - bh * 0.92) & (yy <= cy - bh * 0.55)
        img[glass] = (60, 80, 100)
        for wx in (cx - bw / 3, cx + bw / 3):
            wheel = (xx - wx) ** 2 + (yy - cy - bh / 2) ** 2 < (28 * s) ** 2
            img[wheel] = (25, 25, 25)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


if __name__ == "__main__":
    progressive = "--progressive" in sys.argv[1:]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "nusc_cam_1600x900_progressive.jpg" if progressive
                       else "nusc_cam_1600x900.jpg")
    Image.fromarray(street_scene()).save(out, "JPEG", progressive=progressive)
    print(out, os.path.getsize(out), "bytes")
