"""Image output of the port's entry points, with numpy and zlib only.

The JAX demo writes input.png and an animated scene.gif through imageio
(supnerf_tpu/cli/demo.py). imageio, PIL and cv2 are not installed where the
port runs, and a GIF needs an LZW coder and a 256-colour palette, so the
port writes every frame as its own 8-bit RGB PNG (scene_00.png, ...) with
this writer: a signature, an IHDR chunk, one zlib-compressed IDAT chunk of
unfiltered scanlines (filter byte 0) and an IEND chunk.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp [0, 1] floats and convert to uint8 (the port's own copy of
    supnerf_tpu/geometry/roi.py image_float_to_uint8; reference utils.py:686)."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
