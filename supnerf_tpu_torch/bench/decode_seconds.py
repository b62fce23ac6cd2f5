"""Host seconds of the port's image decoders at the datasets' sizes.

    python -m supnerf_tpu_torch.bench.decode_seconds [--repeats 3]

Prints one JSON object: the median seconds of
- read_jpeg on the committed 1600 x 900 baseline 4:2:0 street scene
  (tests/fixtures/nusc_cam_1600x900.jpg, a nuScenes camera image's size),
  and on the same scene saved progressive
  (tests/fixtures/nusc_cam_1600x900_progressive.jpg, which decodes to the
  same pixels);
- read_png on a 1600 x 900 greyscale mask (an ellipse) written with every
  row Paeth-filtered, the decoder's slowest case (the wavefront), and on the
  same mask with every row unfiltered (write_png's files);
- read_png on a 1242 x 375 RGB image (a KITTI image's size, the street
  scene's crop) with every row Paeth-filtered.
chip_smoke.py calls measure() on the card's host; the machine is the one
the script runs on.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import struct
import tempfile
import time
import zlib

import numpy as np

from supnerf_tpu_torch.data.jpeg import read_jpeg
from supnerf_tpu_torch.utils.image_io import PNG_SIGNATURE, _chunk, read_png, write_png

FIXTURE_JPEG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "nusc_cam_1600x900.jpg")
FIXTURE_PROGRESSIVE = FIXTURE_JPEG[:-len(".jpg")] + "_progressive.jpg"


def write_png_paeth(path: str, img: np.ndarray):
    """An 8-bit greyscale (H, W) or RGB (H, W, 3) PNG with every row
    Paeth-filtered (filter 4)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * bpp).astype(np.int32)
    a = np.concatenate([np.zeros((h, bpp), np.int32), x[:, :-bpp]], 1)
    b = np.concatenate([np.zeros((1, w * bpp), np.int32), x[:-1]], 0)
    c = np.concatenate([np.zeros((h, bpp), np.int32), b[:, :-bpp]], 1)
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((h, 1), 4, np.uint8), ((x - pred) & 255).astype(np.uint8)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _median_seconds(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def jpeg_seconds(repeats: int = 3) -> dict:
    """Median seconds of read_jpeg on the baseline and the progressive
    fixture; checks that both decode to the same pixels."""
    if not np.array_equal(read_jpeg(FIXTURE_JPEG), read_jpeg(FIXTURE_PROGRESSIVE)):
        raise RuntimeError("the progressive fixture does not decode to the baseline's pixels")
    return {"jpeg_1600x900_s": _median_seconds(lambda: read_jpeg(FIXTURE_JPEG), repeats),
            "jpeg_progressive_1600x900_s": _median_seconds(
                lambda: read_jpeg(FIXTURE_PROGRESSIVE), repeats)}


def measure(repeats: int = 3) -> dict:
    """Median seconds per decode (see the module's docstring); also checks
    that every decode gives back its image."""
    street = read_jpeg(FIXTURE_JPEG)
    yy, xx = np.mgrid[:900, :1600]
    mask = np.where(((yy - 450) / 260.0) ** 2 + ((xx - 800) / 420.0) ** 2 < 1, 255, 0)
    mask = mask.astype(np.uint8)
    kitti = np.ascontiguousarray(street[450:825, 179:1421])
    out = jpeg_seconds(repeats)
    with tempfile.TemporaryDirectory() as d:
        cases = (("png_mask_1600x900_paeth_s", mask, write_png_paeth),
                 ("png_mask_1600x900_unfiltered_s", mask, write_png),
                 ("png_rgb_1242x375_paeth_s", kitti, write_png_paeth))
        for name, img, writer in cases:
            path = os.path.join(d, name + ".png")
            writer(path, img)
            if not np.array_equal(read_png(path), img):
                raise RuntimeError(f"{name}: read_png does not give the image back")
            out[name] = _median_seconds(lambda p=path: read_png(p), repeats)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("supnerf_tpu_torch decode_seconds")
    p.add_argument("--repeats", type=int, default=3)
    print(json.dumps(measure(p.parse_args(argv).repeats)))


if __name__ == "__main__":
    main()
