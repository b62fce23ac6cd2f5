"""PNG input and output of the port, with numpy and zlib only.

The JAX package reads its masks and KITTI images through PIL and writes the
demo's input.png and scene.gif through imageio (supnerf_tpu/cli/demo.py).
PIL, imageio and cv2 are not installed where the port runs, so:

- read_png decodes what PIL writes and what the datasets ship: 8-bit
  greyscale, greyscale + alpha, RGB, RGBA and palette images, non-interlaced,
  with all five scanline filters. It returns what np.asarray(Image.open(f))
  returns, or with mode="RGB" what Image.open(f).convert("RGB") returns.
- write_png writes an (H, W, 3) uint8 image as 8-bit RGB or an (H, W) one
  as 8-bit greyscale: a signature, an IHDR chunk, one zlib-compressed IDAT
  chunk of unfiltered scanlines (filter byte 0) and an IEND chunk. The demo
  writes every frame as its own PNG (scene_00.png, ...), since a GIF needs an
  LZW coder and a 256-colour palette.

The filters Average and Paeth predict a byte from the decoded byte to its
left and the decoded row above, so they do not vectorise along a row. Rows
of None, Sub (a running sum in uint8) and Up decode one numpy step per row;
the span of rows from the first Average or Paeth row to the last decodes as
a wavefront over the anti-diagonals of pixels (span + W numpy steps, each
over every pixel of its diagonal, with each row's own filter).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes per pixel at 8 bits (0 grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp [0, 1] floats and convert to uint8 (the port's own copy of
    supnerf_tpu/geometry/roi.py image_float_to_uint8; reference utils.py:686)."""
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG, or an (H, W)
    uint8 one as an 8-bit greyscale PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W, 3) or (H, W) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _chunks(data: bytes, name: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _unfilter_rows(raw, out, rows, bpp):
    """Rows of filters None (0), Sub (1) and Up (2), one numpy step each."""
    for y in rows:
        f, x = raw[y, 0], raw[y, 1:]
        if f == 0:
            out[y] = x
        elif f == 1:
            out[y] = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = x + out[y - 1] if y > 0 else x


def _unfilter_wavefront(raw, out, y0, y1, bpp):
    """Rows y0..y1-1 of any filter as a wavefront over the anti-diagonals of
    pixels: the pixel (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), which lie
    on earlier diagonals. out must hold row y0-1 decoded (if y0 > 0).

    The rows sit in a zero-padded (h + 1) x (w + 1) grid of pixels stored
    flat, so a diagonal and its left, upper and upper-left neighbours are
    strided views (step w pixels) and each step is a few numpy operations."""
    h, w = y1 - y0, (raw.shape[1] - 1) // bpp
    n = (h + 1) * (w + 1)

    def padded(rows, dtype):
        grid = np.zeros((h + 1, w + 1, bpp), dtype)
        grid[1:, 1:] = rows.reshape(h, w, bpp)
        return grid.reshape(n, bpp)

    dec = np.zeros((n, bpp), np.int16)
    if y0 > 0:
        dec.reshape(h + 1, w + 1, bpp)[0, 1:] = out[y0 - 1].reshape(w, bpp)
    x = padded(raw[y0:y1, 1:], np.int16)
    filt = padded(np.repeat(raw[y0:y1, :1], w * bpp, 1), np.int16)
    is_sub, is_up, is_avg, is_paeth = (filt == k for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        ya, yb = max(0, d - w + 1), min(h - 1, d)
        # flat index of the pixel (y, d - y) in the padded grid: y * w + d + w + 2
        lo, hi = ya * w + d + w + 2, yb * w + d + w + 3
        cur = slice(lo, hi, w)
        a = dec[lo - 1:hi - 1:w]                  # left
        b = dec[lo - w - 1:hi - w - 1:w]          # up
        c = dec[lo - w - 2:hi - w - 2:w]          # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (np.where(is_sub[cur], a, 0) + np.where(is_up[cur], b, 0)
                + np.where(is_avg[cur], (a + b) >> 1, 0) + np.where(is_paeth[cur], paeth, 0))
        dec[cur] = (x[cur] + pred) & 255
    out[y0:y1] = dec.reshape(h + 1, w + 1, bpp)[1:, 1:].reshape(h, w * bpp).astype(np.uint8)


def read_png(path: str, mode: str | None = None) -> np.ndarray:
    """Decode a PNG file. mode None: (H, W) uint8 for greyscale and palette
    (the indices) images, (H, W, 2) for greyscale + alpha, (H, W, 3) for RGB,
    (H, W, 4) for RGBA, as np.asarray(PIL.Image.open(path)). mode "RGB":
    (H, W, 3), greyscale replicated, alpha dropped and palette indices looked
    up, as Image.open(path).convert("RGB"). Refuses 16-bit samples, samples
    under 8 bits and Adam7 interlace with the reason."""
    with open(path, "rb") as f:
        data = f.read()
    hdr, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth == 16:
        raise ValueError(f"{path}: 16-bit samples are not read (8-bit images only)")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not read (samples under 8 bits are "
                         "packed several to a byte; 8-bit images only)")
    if interlace:
        raise ValueError(f"{path}: Adam7 interlace is not read (non-interlaced images only)")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {ctype}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError(f"{path}: image data too short for {w} x {h}")
    raw = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    if (raw[:, 0] > 4).any():
        raise ValueError(f"{path}: unknown scanline filter {int(raw[:, 0].max())}")
    out = np.empty((h, w * bpp), np.uint8)
    slow = np.flatnonzero(raw[:, 0] >= 3)
    if slow.size:
        _unfilter_rows(raw, out, range(slow[0]), bpp)
        _unfilter_wavefront(raw, out, slow[0], slow[-1] + 1, bpp)
        _unfilter_rows(raw, out, range(slow[-1] + 1, h), bpp)
    else:
        _unfilter_rows(raw, out, range(h), bpp)
    img = out.reshape(h, w, bpp)
    if mode is None:
        return img[..., 0] if bpp == 1 else img
    if mode != "RGB":
        raise ValueError(f"mode {mode!r}: read_png converts to 'RGB' only")
    if ctype == 3:
        idx = img[..., 0]
        if idx.max() >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[idx]
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])

