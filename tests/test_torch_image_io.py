"""The port's image decoders against PIL on the CPU: read_png
(supnerf_tpu_torch/utils/image_io.py) on PIL-written greyscale, greyscale +
alpha, RGB, RGBA and palette files whose rows use all five scanline filters,
write_png's greyscale files, and files written here (write_png_any) at bit
depths 1, 2 and 4 and with Adam7 interlace, through the masks' reader
(data/common.py) too; the JPEG decoder (supnerf_tpu_torch/data/jpeg.py) on
PIL-written baseline and progressive 4:4:4, 4:2:2 and 4:2:0 files with and
without restart intervals and optimised Huffman tables, greyscale files and
the committed 1600 x 900 street scene, baseline and progressive, whose
decoded pixels' sha256 is pinned (the same for both: the progressive file
sends every bit of the same coefficients). Both decoders give PIL's bytes
exactly here (PIL decodes JPEG with libjpeg-turbo); the refusals name their
reason."""
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401
from supnerf_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from supnerf_tpu_torch.utils.image_io import _chunks, read_png, write_png

FIXTURE_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                            "nusc_cam_1600x900.jpg")
FIXTURE_PROGRESSIVE = os.path.join(os.path.dirname(FIXTURE_JPEG),
                                   "nusc_cam_1600x900_progressive.jpg")
# sha256 of the port decoder's (900, 1600, 3) uint8 output on FIXTURE_JPEG
# and on FIXTURE_PROGRESSIVE
FIXTURE_SHA256 = "f6fb7108f44ca32a052627fc004188009e20f3de1b5a4cc5d1940f0942d3f078"


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def filter_showcase(h, w, bpp, seed=0):
    """(h, w * bpp) uint8 rows built so that PIL's adaptive filter choice
    (with optimize=True) takes each of the five filters: after a random row
    come a row of small signed values (None), a ramp (Sub), a copy of the row
    above (Up), a row that is exactly the Average prediction, and one that
    is exactly the Paeth prediction."""
    rng = np.random.default_rng(seed)
    rows = []
    kinds = ["random", "none", "random", "sub", "random", "up", "random", "avg", "random",
             "paeth"]
    for y in range(h):
        kind = kinds[y % len(kinds)]
        up = rows[-1].astype(int) if rows else np.zeros(w * bpp, int)
        if kind == "random":
            r = rng.integers(0, 256, w * bpp)
        elif kind == "none":
            r = rng.choice([0, 1, 2, 254, 255], w * bpp)
        elif kind == "sub":
            r = (np.arange(w * bpp) * 3 + y) % 256
        elif kind == "up":
            r = up.copy()
        else:
            r = np.zeros(w * bpp, int)
            for i in range(w * bpp):
                a = r[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                r[i] = (a + up[i]) >> 1 if kind == "avg" else _paeth(a, up[i], c)
        rows.append(np.asarray(r, np.uint8))
    return np.stack(rows)


def _filters_of(path):
    data = open(path, "rb").read()
    chunks = list(_chunks(data, path))
    w, h, _, ctype, _, _, _ = struct.unpack(">IIBBBBB", dict(chunks)[b"IHDR"])
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    return set(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)[:, 0].tolist())


@pytest.mark.parametrize("mode,bpp", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_read_png_matches_pil_over_all_filters(tmp_path, mode, bpp):
    h, w = 47, 33
    img = filter_showcase(h, w, bpp, seed=bpp).reshape(h, w, bpp)
    path = str(tmp_path / f"{mode}.png")
    # PIL tries the Average filter only when optimising
    Image.fromarray(img[..., 0] if bpp == 1 else img, mode).save(path, optimize=True)
    assert _filters_of(path) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(read_png(path, mode="RGB"),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_read_png_palette_and_row_filters_only(tmp_path):
    """A palette image (the indices, and their colours with mode "RGB") and
    an image whose rows use None, Sub and Up only (no wavefront)."""
    rng = np.random.default_rng(1)
    pal = Image.fromarray(rng.integers(0, 256, (30, 41, 3)).astype(np.uint8)).quantize(200)
    path = str(tmp_path / "p.png")
    pal.save(path)
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(read_png(path, mode="RGB"),
                                  np.asarray(Image.open(path).convert("RGB")))
    mask = np.zeros((90, 160), np.uint8)
    mask[20:60, 30:120] = 255
    path = str(tmp_path / "mask.png")
    Image.fromarray(mask).save(path)
    assert _filters_of(path) <= {0, 1, 2}
    np.testing.assert_array_equal(read_png(path), mask)


def test_write_png_greyscale_reads_back_in_pil(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (13, 29)).astype(np.uint8)
    write_png(str(tmp_path / "g.png"), img)
    back = Image.open(tmp_path / "g.png")
    assert back.mode == "L"
    np.testing.assert_array_equal(np.asarray(back), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "g.png")), img)


def _set_ihdr(path, out, **fields):
    """Copy a PNG with IHDR fields (depth, interlace) replaced, CRC redone."""
    data = open(path, "rb").read()
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    depth, interlace = fields.get("depth", depth), fields.get("interlace", interlace)
    body = struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt, interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    open(out, "wb").write(data[:16] + body + crc + data[33:])


def test_read_png_refusals_name_their_reason(tmp_path):
    i16 = np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000
    Image.fromarray(i16).save(tmp_path / "i16.png")
    with pytest.raises(ValueError, match="16-bit"):
        read_png(str(tmp_path / "i16.png"))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "rgb.png")
    _set_ihdr(str(tmp_path / "rgb.png"), str(tmp_path / "rgb4.png"), depth=4)
    with pytest.raises(ValueError, match="bit depth 4 is not valid for colour type 2"):
        read_png(str(tmp_path / "rgb4.png"))
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "g.png")
    _set_ihdr(str(tmp_path / "g.png"), str(tmp_path / "interlace2.png"), interlace=2)
    with pytest.raises(ValueError, match="unknown interlace method 2"):
        read_png(str(tmp_path / "interlace2.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(FIXTURE_JPEG)


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _filtered(rows, bpp, first_filter):
    """rows (h, n) uint8 as PNG scanlines: row y takes filter
    (first_filter + y) % 5, predicted from the unfiltered row above."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = (first_filter + y) % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row])[:len(row)]
        c = np.concatenate([np.zeros(bpp, np.int32), prev])[:len(row)]
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        pred = [0, a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))][f]
        out.append(np.concatenate([[f], (row - pred) & 255]).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png_any(path, samples, depth, ctype, interlace=0, palette=None, first_filter=0):
    """A PNG of samples (h, w[, channels]) at any bit depth (samples under 8
    bits packed most significant first, each row padded to a byte), colour
    type and interlace, its rows cycling through the five filters."""
    samples = np.asarray(samples)
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)

    def packed(s):
        if depth == 8:
            return s.reshape(len(s), -1).astype(np.uint8)
        bits = (s.reshape(len(s), -1, 1).astype(np.uint8)
                >> np.arange(depth - 1, -1, -1).astype(np.uint8)) & 1
        return np.packbits(bits.reshape(len(s), -1), axis=1)

    if interlace:
        raw = b"".join(_filtered(packed(samples[y0::dy, x0::dx]), bpp, first_filter + i)
                       for i, (x0, y0, dx, dy) in enumerate(ADAM7) if x0 < w and y0 < h)
    else:
        raw = _filtered(packed(samples), bpp, first_filter)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk_bytes(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                  interlace)))
        if palette is not None:
            f.write(_chunk_bytes(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
        f.write(_chunk_bytes(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk_bytes(b"IEND", b""))


def _chunk_bytes(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
def test_read_png_bit_depths_and_adam7_match_pil(tmp_path, interlace):
    """Greyscale and palette images at 1, 2, 4 and 8 bits, and greyscale +
    alpha, RGB and RGBA at 8, plain and Adam7-interlaced, at sizes whose
    Adam7 passes are partly empty (1 x 1, 3 x 2) and odd: the array and its
    RGB conversion as PIL's (1-bit greyscale as bool, 2- and 4-bit greyscale
    scaled to 8 bits)."""
    rng = np.random.default_rng(interlace)
    kinds = [(0, 1), (0, 2), (0, 4), (0, 8), (3, 1), (3, 2), (3, 4), (3, 8), (2, 8), (4, 8),
             (6, 8)]
    for h, w in ((1, 1), (3, 2), (5, 9), (17, 13)):
        for ctype, depth in kinds:
            channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
            top = min(1 << depth, 7) if ctype == 3 else 1 << depth
            path = str(tmp_path / f"{h}x{w}_{ctype}_{depth}.png")
            write_png_any(path, rng.integers(0, top, (h, w, channels)), depth, ctype, interlace,
                          rng.integers(0, 256, (7, 3)) if ctype == 3 else None, first_filter=h)
            im = Image.open(path)
            for mode, ref in ((None, np.asarray(im)), ("RGB", np.asarray(im.convert("RGB")))):
                got = read_png(path, mode=mode)
                assert got.dtype == ref.dtype and got.shape == ref.shape, (path, mode)
                np.testing.assert_array_equal(got, ref, err_msg=f"{path} {mode}")


def test_masks_of_bit_depths_and_adam7_match_jax(tmp_path):
    """The segmentation's instance masks as 1-bit, 4-bit, Adam7-interlaced
    and palette PNGs: load_instance_masks and get_mask_occ_from_ins of the
    port (read_png) and of the JAX package (PIL) give the same masks and
    occupancy."""
    from supnerf_tpu.data import common as jax_common
    from supnerf_tpu_torch.data import common

    yy, xx = np.mgrid[:37, :53]
    shapes = [((yy - 18) ** 2 + (xx - 20) ** 2 < 100), (np.abs(yy - 10) < 6) & (xx > 30),
              (xx + yy) % 7 == 0, (yy > 25) & (xx < 12)]
    writes = [(1, 0, 0, 1), (4, 0, 1, 15), (8, 0, 1, 255), (2, 3, 1, 3)]
    for k, (mask, (depth, ctype, interlace, top)) in enumerate(zip(shapes, writes)):
        write_png_any(str(tmp_path / f"img_{k}.png"), mask.astype(np.uint8) * top, depth, ctype,
                      interlace, [[0, 0, 0], [9, 9, 9], [0, 0, 0], [255, 255, 255]]
                      if ctype == 3 else None, first_filter=k)
    (tmp_path / "img.json").write_text(json.dumps({"boxes": [[0, 0, 1, 1]] * len(shapes),
                                                   "labels": ["car"] * len(shapes)}))
    _, ours = common.load_instance_masks(str(tmp_path), "img")
    _, theirs = jax_common.load_instance_masks(str(tmp_path), "img")
    assert [m.dtype for m in ours] == [m.dtype for m in theirs] == [bool, np.uint8, np.uint8,
                                                                     np.uint8]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for k in range(len(shapes)):
        occ = common.get_mask_occ_from_ins(ours, k)
        np.testing.assert_array_equal(occ, jax_common.get_mask_occ_from_ins(theirs, k))
        assert (occ == 1).sum() == shapes[k].sum()


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11), 128 + 90 * np.cos(xx / 5 - yy / 9),
                    (xx * yy / 3) % 256], -1)
    img[h // 3:h // 2, w // 4:w // 2] = [200, 30, 40]
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("restart", [{}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}],
                         ids=["no-restart", "restart-blocks", "restart-rows"])
def test_jpeg_matches_pil(subsampling, restart):
    """Odd sizes (partial MCUs at the right and bottom edges), the three
    chroma samplings PIL writes, and restart intervals."""
    for h, w, q in ((37, 53, 85), (64, 80, 95), (121, 99, 60)):
        data = _jpeg_bytes(_scene(h, w, h), quality=q, subsampling=subsampling, **restart)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_jpeg(data)
        assert got.shape == ref.shape == (h, w, 3)
        np.testing.assert_array_equal(got, ref)


def test_jpeg_greyscale_matches_pil():
    for h, w in ((37, 53), (90, 160)):
        data = _jpeg_bytes(_scene(h, w, 5)[..., 1], quality=90)
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_jpeg(data)
        assert got.shape == ref.shape == (h, w)
        np.testing.assert_array_equal(got, ref)


def test_committed_fixture_decodes_as_pil_and_pinned():
    im = Image.open(FIXTURE_JPEG)
    assert im.size == (1600, 900) and "progressive" not in im.info
    assert os.path.getsize(FIXTURE_JPEG) <= 300_000
    got = read_jpeg(FIXTURE_JPEG)
    np.testing.assert_array_equal(got, np.asarray(im))
    assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURE_SHA256


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("options", [{}, {"optimize": True}, {"restart_marker_blocks": 3},
                                     {"restart_marker_rows": 1}],
                         ids=["plain", "optimize", "restart-blocks", "restart-rows"])
def test_progressive_jpeg_matches_pil(subsampling, options):
    """PIL's progressive files (DC first and refinement scans, AC first scans
    with end-of-band runs, AC refinement): odd sizes, the three chroma
    samplings, optimised Huffman tables, restart intervals."""
    for h, w, q in ((37, 53, 85), (64, 80, 95), (121, 99, 60), (1, 1, 75)):
        data = _jpeg_bytes(_scene(h, w, h), quality=q, subsampling=subsampling,
                           progressive=True, **options)
        assert b"\xff\xc2" in data
        ref = np.asarray(Image.open(io.BytesIO(data)))
        got = decode_jpeg(data)
        assert got.shape == ref.shape == (h, w, 3)
        np.testing.assert_array_equal(got, ref)


def test_progressive_greyscale_and_fixture_match_pil():
    for h, w in ((37, 53), (90, 160)):
        data = _jpeg_bytes(_scene(h, w, 5)[..., 1], quality=90, progressive=True)
        np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))
    im = Image.open(FIXTURE_PROGRESSIVE)
    assert im.size == (1600, 900) and im.info.get("progressive")
    assert os.path.getsize(FIXTURE_PROGRESSIVE) <= 300_000
    got = read_jpeg(FIXTURE_PROGRESSIVE)
    np.testing.assert_array_equal(got, np.asarray(im))
    assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURE_SHA256


def test_quantisation_tables_latch_at_a_components_first_scan():
    """A DQT that redefines a table between two scans changes neither scan's
    component (libjpeg latches a component's table when its first scan
    starts): the same pixels as without the second DQT, as PIL decodes."""
    img = _scene(24, 40, 3)
    data = _jpeg_bytes(img, quality=80, progressive=True)
    second_sos = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    dqt = b"\xff\xdb\x00\x43\x00" + bytes(range(1, 65))
    patched = data[:second_sos] + dqt + data[second_sos:]
    np.testing.assert_array_equal(decode_jpeg(patched), decode_jpeg(data))
    np.testing.assert_array_equal(decode_jpeg(patched), np.asarray(Image.open(io.BytesIO(patched))))


def _first_scans(data, n):
    """A progressive file cut after its first n scans, with an EOI."""
    at = -1
    for _ in range(n + 1):
        at = data.index(b"\xff\xda", at + 2)
    return data[:at] + b"\xff\xd9"


def test_jpeg_refusals_name_the_marker():
    img = _scene(32, 32, 7)
    with pytest.raises(ValueError, match="block smoothing"):
        decode_jpeg(_first_scans(_jpeg_bytes(img, progressive=True), 2))
    data = bytearray(_jpeg_bytes(img))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9                                  # arithmetic-coded sequential
    with pytest.raises(ValueError, match="SOF9"):
        decode_jpeg(bytes(data))
    data = bytearray(_jpeg_bytes(img))
    data[sof + 4] = 12                                    # sample precision
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="4 components"):
        decode_jpeg(buf.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    data = open(FIXTURE_JPEG, "rb").read()
    with pytest.raises(ValueError, match="ends before its last block"):
        decode_jpeg(data[:len(data) // 2] + b"\xff\xd9")
