"""The port's image decoders against PIL on the CPU: read_png
(supnerf_tpu_torch/utils/image_io.py) on PIL-written greyscale, greyscale +
alpha, RGB, RGBA and palette files whose rows use all five scanline filters,
write_png's greyscale files, and the baseline JPEG decoder
(supnerf_tpu_torch/data/jpeg.py) on PIL-written 4:4:4, 4:2:2 and 4:2:0
files with and without restart intervals, greyscale files and the committed
1600 x 900 street scene, whose decoded pixels' sha256 is pinned. Both
decoders give PIL's bytes exactly here (PIL decodes JPEG with
libjpeg-turbo); the refusals name their reason."""
import hashlib
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from supnerf_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from supnerf_tpu_torch.utils.image_io import _chunks, read_png, write_png

FIXTURE_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                            "nusc_cam_1600x900.jpg")
# sha256 of the port decoder's (900, 1600, 3) uint8 output on FIXTURE_JPEG
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
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)).quantize(8).save(
        tmp_path / "p4.png")
    with pytest.raises(ValueError, match="under 8 bits"):
        read_png(str(tmp_path / "p4.png"))
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "g.png")
    _set_ihdr(str(tmp_path / "g.png"), str(tmp_path / "adam7.png"), interlace=1)
    with pytest.raises(ValueError, match="Adam7"):
        read_png(str(tmp_path / "adam7.png"))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(FIXTURE_JPEG)


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


def test_jpeg_refusals_name_the_marker():
    img = _scene(32, 32, 7)
    with pytest.raises(ValueError, match="SOF2"):
        decode_jpeg(_jpeg_bytes(img, progressive=True))
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
