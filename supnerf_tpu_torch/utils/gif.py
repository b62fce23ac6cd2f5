"""An animated GIF89a writer in numpy, for the frame videos
(cli/generate_video_vis.py) where no ffmpeg is installed; the port's
counterpart of the imageio GIF that scripts/generate_video_vis.py writes.

Each frame gets its own 256-colour palette (a local colour table): the
frame's own colours where it has at most 256, else a median cut of its
colours refined by a few k-means steps, each pixel mapped to its nearest
palette colour (no dithering). The indices are LZW-compressed as GIF
defines it (variable codes from 9 to 12 bits, a clear code when the table
is full, LSB-first packing) and split into sub-blocks of 255 bytes. Each
frame has a Graphic Control Extension with its delay in centiseconds
(round(100 / fps)); the file loops forever (the NETSCAPE2.0 extension).
"""
from __future__ import annotations

import struct

import numpy as np

KMEANS_STEPS = 3


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Up to n palette colours (float64) for the distinct colours (U, 3)
    with their pixel counts: the box of most pixels times its widest
    channel range is split at its weighted median along that channel, until
    n boxes; each box gives its pixel-weighted mean."""
    def box(idx):
        rng = colors[idx].max(0) - colors[idx].min(0)
        ch = int(np.argmax(rng))
        score = float(rng[ch]) * float(counts[idx].sum()) if len(idx) > 1 else 0.0
        return [score, idx, ch]

    boxes = [box(np.arange(len(colors)))]
    while len(boxes) < n:
        best = max(range(len(boxes)), key=lambda i: boxes[i][0])
        if boxes[best][0] <= 0.0:
            break
        _, idx, ch = boxes.pop(best)
        idx = idx[np.argsort(colors[idx, ch], kind="stable")]
        cum = np.cumsum(counts[idx])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)) + 1, 1), len(idx) - 1)
        boxes += [box(idx[:cut]), box(idx[cut:])]
    return np.stack([np.average(colors[idx], axis=0, weights=counts[idx])
                     for _, idx, _ in boxes])


def _nearest(colors: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """The index of each colour's nearest palette entry (squared distance,
    |c|^2 - 2 c.p + |p|^2 with the constant |c|^2 dropped)."""
    return np.argmin((palette ** 2).sum(1)[None, :] - 2.0 * colors @ palette.T, axis=1)


def quantize(frame: np.ndarray):
    """(H, W, 3) uint8 -> (palette (256, 3) uint8, indices (H, W) uint8)."""
    flat = frame.reshape(-1, 3).astype(np.int64)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
    palette = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        palette[:len(uniq)] = colors
        return palette, inverse.reshape(frame.shape[:2]).astype(np.uint8)
    cf = colors.astype(np.float64)
    pal = _median_cut(cf, counts, 256)
    for _ in range(KMEANS_STEPS):
        assign = _nearest(cf, pal)
        w = np.bincount(assign, weights=counts, minlength=len(pal))
        for ch in range(3):
            s = np.bincount(assign, weights=counts * cf[:, ch], minlength=len(pal))
            pal[:, ch] = np.where(w > 0, s / np.maximum(w, 1), pal[:, ch])
    pal = np.clip(np.rint(pal), 0, 255)
    assign = _nearest(cf, pal)
    palette[:len(pal)] = pal.astype(np.uint8)
    return palette, assign[inverse].reshape(frame.shape[:2]).astype(np.uint8)


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's LZW of a stream of palette indices: a clear code first, codes
    widening from min_code_size + 1 to 12 bits as the table grows, a clear
    code and a fresh table when it holds 4096 entries, the end code last;
    the codes packed least significant bit first."""
    data = np.asarray(indices, np.uint8).ravel().tolist()
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    width, next_code, table = min_code_size + 1, end + 1, {}
    codes, widths = [clear], [width]
    prefix = data[0]
    for b in data[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        widths.append(width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            codes.append(clear)
            widths.append(width)
            width, next_code, table = min_code_size + 1, end + 1, {}
        prefix = b
    codes += [prefix, end]
    widths += [width, width]
    codes, widths = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    bits = (codes[:, None] >> np.arange(12)) & 1
    bits = bits[np.arange(12)[None, :] < widths[:, None]]
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for s in range(0, len(data), 255):
        chunk = data[s:s + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def write_gif(path: str, frames, fps: float) -> None:
    """Write frames ((H, W, 3) uint8, one size) as a looping GIF89a with a
    delay of round(100 / fps) centiseconds a frame."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) or f.dtype != np.uint8 for f in frames):
        raise ValueError("write_gif takes (H, W, 3) uint8 frames of one size")
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, 0x70, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for f in frames:
        palette, idx = quantize(f)
        out += b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, delay, 0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + palette.tobytes()
        out += b"\x08" + _sub_blocks(lzw_encode(idx))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(out))
