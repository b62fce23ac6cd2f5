"""Baseline JPEG decoder in numpy, for nuScenes' camera images
(samples/CAM_*/*.jpg), where the JAX package decodes through PIL.

The target is the bytes PIL gives, which decodes with libjpeg-turbo's
defaults, so every step after the entropy decode is that library's integer
arithmetic, vectorised over all blocks of a component:
- the "islow" inverse DCT (jidctint.c: 13 constant bits, 2 pass-1 bits, the
  post-IDCT range limit that wraps at 1024);
- "fancy" triangle upsampling of chroma sampled h2v1, h1v2 or h2v2
  (jdsample.c, with its alternating rounding biases), edge samples
  replicated at the component's own width and height; any other integer
  ratio replicates samples (int_upsample);
- YCbCr -> RGB through the fixed-point tables of jdcolor.c (16 scale bits).
Integer arithmetic also makes the result the same on every machine.

Read: SOI, APPn (APP14 for Adobe's colour transform flag), COM, DQT (8 and
16-bit tables), SOF0 and SOF1 at 8 bits, DHT, DRI with RSTn, SOS (one or
several scans, interleaved or not), DNL-free EOI. Refused with the marker
named: progressive (SOF2), lossless, hierarchical and arithmetic-coded
frames, 12-bit samples, and four-component (CMYK) images.

The entropy decode is one Python loop per Huffman symbol. It peeks 16 bits
from a list of 64-bit big-endian windows, one per byte offset, and looks the
peek up in a 65,536-entry table per Huffman table; an AC entry whose code
and magnitude bits both fit in the peek carries the decoded run and value.
"""
from __future__ import annotations

import struct

import numpy as np

# natural (row-major) index of each zig-zag position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_REFUSED_SOF = {
    0xC2: "SOF2 (progressive DCT)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic-coded sequential)",
    0xCA: "SOF10 (arithmetic-coded progressive)", 0xCB: "SOF11 (arithmetic-coded lossless)",
    0xCD: "SOF13 (arithmetic-coded differential sequential)",
    0xCE: "SOF14 (arithmetic-coded differential progressive)",
    0xCF: "SOF15 (arithmetic-coded differential lossless)",
}

# jidctint.c constants: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_range_table():
    """libjpeg's post-IDCT range limit indexed by (x & 1023), x the centred
    sample: x + 128 clamped to 0..255 for x in -512..511, wrapping beyond."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_IDCT_RANGE = _idct_range_table()


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table, 16 scale bits."""
    one_half, x = 1 << 15, np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _idct_1d(v):
    """One jidctint.c pass over axis -2 of v (..., 8, 8) (int64): returns the
    eight undescaled outputs stacked on that axis."""
    s = [v[..., k, :] for k in range(8)]
    z1 = (s[2] + s[6]) * _F0541
    tmp2 = z1 - s[6] * _F1847
    tmp3 = z1 + s[2] * _F0765
    tmp0 = (s[0] + s[4]) << _CONST_BITS
    tmp1 = (s[0] - s[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3], axis=-2)


def idct_islow(coef, qtable):
    """Dequantise and inverse-transform blocks as jpeg_idct_islow: coef (N,
    64) int in natural order, qtable (64,) natural order. Returns (N, 8, 8)
    uint8 samples."""
    v = (np.asarray(coef, np.int64) * np.asarray(qtable, np.int64)).reshape(-1, 8, 8)
    n1 = _CONST_BITS - _PASS1_BITS
    ws = (_idct_1d(v) + (1 << (n1 - 1))) >> n1                   # pass 1: columns
    n2 = _CONST_BITS + _PASS1_BITS + 3
    out = (_idct_1d(ws.swapaxes(-1, -2)) + (1 << (n2 - 1))) >> n2   # pass 2: rows
    return _IDCT_RANGE[out.swapaxes(-1, -2) & 1023]


def _fancy_h2(x, bias_lo, bias_hi, shift):
    """Horizontal triangle interpolation of (H, W) int sums: even outputs
    (3 * x + left + bias_lo) >> shift, odd (3 * x + right + bias_hi) >> shift,
    edges replicated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + bias_lo) >> shift
    out[:, 1::2] = (3 * x + right + bias_hi) >> shift
    return out


def _vertical_sums(x):
    """h2v2 / h1v2 column sums: output row 2y takes 3 * x[y] + x[y-1], row
    2y+1 3 * x[y] + x[y+1], edge rows replicated."""
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int64)
    out[0::2] = 3 * x + up
    out[1::2] = 3 * x + down
    return out


def upsample(plane, h_ratio: int, v_ratio: int):
    """libjpeg-turbo's default upsampling of one component plane (H, W)
    uint8 (its true downsampled size) by integer ratios."""
    x = plane.astype(np.int64)
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    if (h_ratio, v_ratio) == (2, 1):          # h2v1_fancy_upsample
        return _fancy_h2(x, 1, 2, 2).astype(np.uint8)
    if (h_ratio, v_ratio) == (1, 2):          # h1v2_fancy_upsample
        sums = _vertical_sums(x)
        sums[0::2] += 1
        sums[1::2] += 2
        return (sums >> 2).astype(np.uint8)
    if (h_ratio, v_ratio) == (2, 2):          # h2v2_fancy_upsample
        return _fancy_h2(_vertical_sums(x), 8, 7, 4).astype(np.uint8)
    return np.repeat(np.repeat(plane, v_ratio, 0), h_ratio, 1)   # int_upsample


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    cb, cr = cb.astype(np.intp), cr.astype(np.intp)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class _Huffman:
    """A DHT table as a 65,536-entry lookup on a 16-bit peek.

    DC entries: (code length, magnitude category). AC entries: (bits, run,
    value, extra): bits to skip, the zero run before the coefficient, and
    its value when the magnitude bits fit in the peek (extra 0), else the
    magnitude bit count to read next (extra > 0). End of block has run 64."""

    def __init__(self, counts, symbols, is_ac: bool, where: str):
        lengths = np.repeat(np.arange(1, 17), counts)
        codes, code = [], 0
        for n in range(1, 17):
            for _ in range(counts[n - 1]):
                codes.append(code)
                code += 1
            if code > (1 << n):
                raise ValueError(f"{where}: bad Huffman table (over-subscribed codes)")
            code <<= 1
        peek = np.arange(1 << 16)
        length = np.zeros(1 << 16, np.int64)
        sym = np.zeros(1 << 16, np.int64)
        for c, n, s in zip(codes, lengths, symbols):
            lo = c << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            sym[lo:lo + (1 << (16 - n))] = s
        if not is_ac:
            self.lut = list(zip(length.tolist(), sym.tolist()))
            return
        run, size = sym >> 4, sym & 15
        fits = (length + size <= 16) & (size > 0)
        bits = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
        value = np.where(bits < (1 << np.maximum(size - 1, 0)), bits - (1 << size) + 1, bits)
        value = np.where(fits, value, 0)
        nbits = np.where(fits, length + size, length)
        extra = np.where(fits | (size == 0), 0, size)
        run = np.where(sym == 0, 64, run)                       # end of block
        nbits = np.where(length == 0, 0, nbits)                 # no code: invalid data
        self.lut = list(zip(nbits.tolist(), run.tolist(), value.tolist(), extra.tolist()))


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _entropy_segments(buf, start):
    """Split the entropy-coded data that begins at `start` at its RSTn
    markers and remove the stuffed zero bytes. Returns (data bytes of all
    intervals back to back, bit offset of each interval, end position of the
    scan's data in buf)."""
    arr = np.frombuffer(buf, np.uint8, offset=start)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    marker = ff[(nxt != 0) & ~rst & (nxt != 0xFF)]
    end = int(marker[0]) if marker.size else len(arr)
    keep = np.ones(end, bool)
    inside = ff < end
    keep[ff[inside & (nxt == 0)] + 1] = False                # stuffed zero bytes
    cuts = ff[inside & rst]
    keep[np.concatenate([cuts, cuts + 1])] = False           # the RSTn markers
    while end > 0 and arr[end - 1] == 0xFF and keep[end - 1]:   # fill bytes before a marker
        keep[end - 1] = False
        end -= 1
    pos = np.cumsum(keep) - keep                              # kept bytes before each index
    starts = [0] + [int(pos[c]) for c in cuts]
    return arr[:end][keep[:end]], starts, start + end


def _windows(data):
    """64-bit big-endian windows at every byte offset, as a list of ints."""
    pad = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.uint64)
    w = np.zeros(len(data), np.uint64)
    for j in range(8):
        w |= pad[j:j + len(data)] << np.uint64(56 - 8 * j)
    return w.tolist()


def _decode_scan(win, starts, n_bits, plan, n_mcu, restart, dc_luts, ac_luts):
    """The Huffman decode of one scan. plan: per block of an MCU, (component
    slot, dc table, ac table); the block's index in the coefficient store is
    bases[m * len(plan) + j]. Returns (flat coefficient positions
    block * 64 + zigzag position, values) of the nonzero symbols, and the DC
    values per block."""
    pos_out, val_out = [], []
    pos_append, val_append = pos_out.append, val_out.append
    n_slots = max(s for s, _, _ in plan) + 1
    blocks = [(slot, dc_luts[dc].lut, ac_luts[ac].lut) for slot, dc, ac in plan]
    masks = [(1 << s) - 1 for s in range(17)]
    halves = [1 << (s - 1) if s else 0 for s in range(17)]
    dc_vals = []
    dc_append = dc_vals.append
    p, interval = starts[0] * 8, 0
    pred = [0] * n_slots
    base = 0
    for m in range(n_mcu):
        if restart and m and m % restart == 0:
            interval += 1
            if interval >= len(starts):
                raise ValueError("JPEG: fewer RSTn markers than the restart interval needs")
            p = starts[interval] * 8
            pred = [0] * n_slots
        for slot, dc, ac in blocks:
            n, s = dc[(win[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if n == 0:
                raise ValueError("JPEG: corrupt entropy-coded data (no Huffman code matches)")
            p += n
            if s:
                v = (win[p >> 3] >> (64 - (p & 7) - s)) & masks[s]
                p += s
                if v < halves[s]:
                    v -= masks[s]
                pred[slot] += v
            dc_append(pred[slot])
            k = 1
            while k < 64:
                n, r, v, s = ac[(win[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if n == 0:
                    raise ValueError("JPEG: corrupt entropy-coded data (no Huffman code matches)")
                p += n
                if s:
                    v = (win[p >> 3] >> (64 - (p & 7) - s)) & masks[s]
                    p += s
                    if v < halves[s]:
                        v -= masks[s]
                k += r
                if k > 63:
                    break
                pos_append(base + k)
                val_append(v)
                k += 1
            base += 64
    if p > n_bits + 64:
        raise IndexError("past the scan's data")
    return pos_out, val_out, dc_vals


def decode_jpeg(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode baseline JPEG bytes; see read_jpeg."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame, restart, adobe_transform = None, None, 0, None
    coef = {}
    pos = 2
    while True:
        while pos < len(buf) and buf[pos] == 0xFF and pos + 1 < len(buf) and buf[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(buf) or buf[pos] != 0xFF:
            raise ValueError(f"{name}: truncated or malformed marker at byte {pos}")
        mk = buf[pos + 1]
        if mk == 0xD9:                                        # EOI
            break
        if pos + 4 > len(buf):
            raise ValueError(f"{name}: truncated marker 0x{mk:02X} at byte {pos}")
        seg_len = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        seg = buf[pos + 4:pos + 2 + seg_len]
        where = f"{name}: marker 0x{mk:02X}"
        if mk in _REFUSED_SOF:
            raise ValueError(f"{name}: {_REFUSED_SOF[mk]} is not decoded "
                             "(baseline and extended sequential Huffman only)")
        if mk == 0xCC:
            raise ValueError(f"{name}: DAC (arithmetic coding) is not decoded")
        if mk in (0xC0, 0xC1):                                # SOF0 / SOF1
            depth, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if depth != 8:
                raise ValueError(f"{name}: SOF{mk - 0xC0} with {depth}-bit samples is not "
                                 "decoded (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{name}: {nc} components are not decoded (greyscale and "
                                 "three-component images only)")
            if height == 0:
                raise ValueError(f"{name}: a DNL-defined height is not decoded")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                                seg[8 + 3 * i]) for i in range(nc)]
            frame = (height, width)
        elif mk == 0xC4:                                      # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                symbols = list(seg[i + 17:i + 17 + sum(counts)])
                (ac_tabs if tc else dc_tabs)[th] = _Huffman(counts, symbols, bool(tc), where)
                i += 17 + sum(counts)
        elif mk == 0xDB:                                      # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
        elif mk == 0xDD:                                      # DRI
            restart = struct.unpack(">H", seg[:2])[0]
        elif mk == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif mk == 0xDA:                                      # SOS
            if frame is None:
                raise ValueError(f"{name}: SOS before SOF")
            ns = seg[0]
            sel = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
            pos = _read_scan(buf, pos + 2 + seg_len, frame, comps, sel, restart, dc_tabs,
                             ac_tabs, coef, name)
            continue
        elif mk in (0xD8, 0x01) or 0xD0 <= mk <= 0xD7:
            raise ValueError(f"{name}: unexpected marker 0x{mk:02X} at byte {pos}")
        pos += 2 + seg_len
    if frame is None or not coef:
        raise ValueError(f"{name}: no frame or no scan")
    return _reconstruct(frame, comps, coef, qt, adobe_transform, name)


def _grid(frame, comps):
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux = -(-frame[1] // (8 * hmax))
    mcuy = -(-frame[0] // (8 * vmax))
    return hmax, vmax, mcux, mcuy


def _read_scan(buf, start, frame, comps, sel, restart, dc_tabs, ac_tabs, coef, name):
    hmax, vmax, mcux, mcuy = _grid(frame, comps)
    by_id = {c.id: c for c in comps}
    plan, base_rows = [], []
    for slot, (cid, td, ta) in enumerate(sel):
        if cid not in by_id:
            raise ValueError(f"{name}: SOS names an unknown component {cid}")
        if td not in dc_tabs or ta not in ac_tabs:
            raise ValueError(f"{name}: SOS uses an undefined Huffman table")
        c = by_id[cid]
        bw, bh = mcux * c.h, mcuy * c.v                      # the component's block grid
        coef.setdefault(cid, np.zeros((bh * bw, 64), np.int64))
        if len(sel) == 1:                                    # non-interleaved: raster order
            cw = -(-frame[1] * c.h // hmax)
            ch = -(-frame[0] * c.v // vmax)
            nbx, nby = -(-cw // 8), -(-ch // 8)
            rows = (np.arange(nby)[:, None] * bw + np.arange(nbx)[None]).reshape(-1, 1)
            plan.append((slot, td, ta))
            base_rows.append(rows)
        else:
            my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
            for v in range(c.v):
                for h in range(c.h):
                    idx = ((my * c.v + v) * bw + mx * c.h + h).reshape(-1, 1)
                    plan.append((slot, td, ta))
                    base_rows.append(idx)
    block_ids = np.concatenate(base_rows, 1)                 # (n_mcu, blocks per MCU)
    n_mcu = block_ids.shape[0]
    data, starts, end = _entropy_segments(buf, start)
    try:
        pos, val, dc = _decode_scan(_windows(data), starts, 8 * len(data), plan, n_mcu,
                                    restart, dc_tabs, ac_tabs)
    except IndexError:
        raise ValueError(f"{name}: the scan's data ends before its last block") from None
    pos = np.asarray(pos, np.int64)
    val = np.asarray(val, np.int64)
    dc = np.asarray(dc, np.int64)
    order = block_ids.reshape(-1)                            # decode order -> block id
    slot_of = np.tile(np.array([s for s, _, _ in plan]), n_mcu)
    for slot, (cid, _, _) in enumerate(sel):
        store = coef[cid]
        mine = slot_of == slot
        store[order[mine], 0] = dc[mine]
        blk = pos >> 6
        sel_ac = mine[blk]
        store[order[blk[sel_ac]], ZIGZAG[pos[sel_ac] & 63]] = val[sel_ac]
    return end


def _reconstruct(frame, comps, coef, qt, adobe_transform, name):
    height, width = frame
    hmax, vmax, mcux, mcuy = _grid(frame, comps)
    planes = []
    for c in comps:
        if c.id not in coef:
            raise ValueError(f"{name}: component {c.id} has no scan")
        if c.tq not in qt:
            raise ValueError(f"{name}: component {c.id} uses an undefined quantisation table")
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"{name}: non-integer sampling ratio of component {c.id}")
        bw, bh = mcux * c.h, mcuy * c.v
        blocks = idct_islow(coef[c.id], qt[c.tq]).reshape(bh, bw, 8, 8)
        plane = blocks.swapaxes(1, 2).reshape(bh * 8, bw * 8)
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        up = upsample(plane[:ch, :cw], hmax // c.h, vmax // c.v)
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if adobe_transform == 0:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def is_jpeg(head: bytes) -> bool:
    return head[:3] == b"\xff\xd8\xff"


def read_jpeg(path: str) -> np.ndarray:
    """Decode a baseline JPEG file to what np.asarray(PIL.Image.open(path))
    gives: (H, W, 3) uint8 RGB, or (H, W) for a greyscale image."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
