"""Baseline JPEG decoder in numpy (no libjpeg, no cv2).

Own copy of ``multimodal_av_model_tpu/data/jpeg.py``: baseline sequential
DCT, 8-bit, greyscale or YCbCr with any sampling factors, restart markers and
0xFF00 stuffing.  Progressive, arithmetic and 12-bit streams raise, naming
the feature.  Huffman symbols decode through a 65536-entry peek-16 table;
dequantisation, de-zigzag, the 2-D IDCT (scipy's orthonormal IDCT-II, which
is the JPEG IDCT), chroma upsampling (nearest) and the colour transform run
over all blocks of a component at once.  Within +-2 of libjpeg's fixed-point
IDCT.  It decodes the frames of MJPEG AVIs (``data/avi.py``).
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int32)


class JpegError(ValueError):
    pass


class _HuffTable:
    """Canonical Huffman table with a peek-16 fast path: ``lut_sym[p]`` /
    ``lut_len[p]`` give the symbol and code length for any 16-bit window
    ``p`` whose prefix is a valid code."""

    def __init__(self, counts, symbols):
        self.lut_sym = np.zeros(1 << 16, np.uint8)
        self.lut_len = np.zeros(1 << 16, np.uint8)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                sym = symbols[k]
                k += 1
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                self.lut_sym[lo:hi] = sym
                self.lut_len[lo:hi] = length
                code += 1
            code <<= 1


class _BitReader:
    """MSB-first bit reader over unstuffed entropy bytes."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data + b"\x00\x00\x00\x00"   # peek slack past the end
        self.pos = 0
        self.nbits = len(data) * 8

    def peek16(self) -> int:
        byte, sh = self.pos >> 3, self.pos & 7
        v = int.from_bytes(self.data[byte : byte + 4], "big")
        return (v >> (16 - sh)) & 0xFFFF

    def skip(self, n: int) -> None:
        self.pos += n

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v


def _extend(v: int, n: int) -> int:
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def _decode_huffman(reader: _BitReader, table: _HuffTable) -> int:
    p = reader.peek16()
    length = int(table.lut_len[p])
    if length == 0:
        raise JpegError("invalid Huffman code in entropy stream")
    reader.skip(length)
    return int(table.lut_sym[p])


def _split_entropy(data: bytes):
    """Unstuff 0xFF00 and split on restart markers: list of clean segments."""
    segments, cur, i, n = [], bytearray(), 0, len(data)
    while i < n:
        b = data[i]
        if b != 0xFF:
            cur.append(b)
            i += 1
            continue
        nxt = data[i + 1] if i + 1 < n else 0xD9
        if nxt == 0x00:
            cur.append(0xFF)
            i += 2
        elif 0xD0 <= nxt <= 0xD7:          # RSTn
            segments.append(bytes(cur))
            cur = bytearray()
            i += 2
        else:                               # EOI or next marker
            break
    segments.append(bytes(cur))
    return segments, i


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a baseline JPEG; returns ``[H, W, 3]`` uint8 RGB (or
    ``[H, W]`` for grayscale streams)."""
    from scipy.fft import idctn

    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")
    qt: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _HuffTable] = {}
    huff_ac: dict[int, _HuffTable] = {}
    frame = None
    restart_interval = 0
    i = 2
    n = len(data)

    while i < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        i += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:                  # EOI
            break
        (seg_len,) = struct.unpack(">H", data[i : i + 2])
        seg = data[i + 2 : i + seg_len]
        i += seg_len

        if marker == 0xDB:                  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 0xF
                j += 1
                if pq == 0:
                    tbl = np.frombuffer(seg[j : j + 64], np.uint8).astype(np.int32)
                    j += 64
                else:
                    tbl = np.frombuffer(seg[j : j + 128], ">u2").astype(np.int32)
                    j += 128
                qt[tq] = tbl
        elif marker == 0xC4:                # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 0xF
                counts = list(seg[j + 1 : j + 17])
                total = sum(counts)
                symbols = list(seg[j + 17 : j + 17 + total])
                (huff_dc if tc == 0 else huff_ac)[th] = _HuffTable(counts, symbols)
                j += 17 + total
        elif marker == 0xC0 or marker == 0xC1:   # SOF0/1 (baseline)
            precision = seg[0]
            if precision != 8:
                raise JpegError(f"{precision}-bit precision unsupported")
            H, W = struct.unpack(">HH", seg[1:5])
            ncomp = seg[5]
            comps = []
            for c in range(ncomp):
                cid, hv, tq = seg[6 + 3 * c : 9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 0xF, "tq": tq})
            frame = {"H": H, "W": W, "comps": comps}
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JpegError(
                f"non-baseline JPEG (SOF{marker - 0xC0}: progressive/"
                f"arithmetic/hierarchical) unsupported")
        elif marker == 0xDD:                # DRI
            (restart_interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:                # SOS
            if frame is None:
                raise JpegError("SOS before SOF")
            ns = seg[0]
            scan = []
            for c in range(ns):
                cs, tables = seg[1 + 2 * c], seg[2 + 2 * c]
                comp = next(x for x in frame["comps"] if x["id"] == cs)
                scan.append((comp, tables >> 4, tables & 0xF))
            segments, consumed = _split_entropy(data[i:])
            i += consumed
            return _decode_scan(frame, scan, qt, huff_dc, huff_ac,
                                segments, restart_interval, idctn)
    raise JpegError("no scan data found")


def _decode_scan(frame, scan, qt, huff_dc, huff_ac, segments,
                 restart_interval, idctn):
    H, W = frame["H"], frame["W"]
    comps = [s[0] for s in scan]
    hmax = max(c["h"] for c in frame["comps"])
    vmax = max(c["v"] for c in frame["comps"])
    interleaved = len(scan) > 1
    if interleaved:
        mcus_x = -(-W // (8 * hmax))
        mcus_y = -(-H // (8 * vmax))
        per_mcu = [(c["h"], c["v"]) for c in comps]
    else:
        # Single-component scan: one 8x8 block per MCU over the component's
        # own (subsampled) pixel grid.
        c = comps[0]
        cw = -(-W * c["h"] // hmax)
        ch = -(-H * c["v"] // vmax)
        mcus_x = -(-cw // 8)
        mcus_y = -(-ch // 8)
        per_mcu = [(1, 1)]
    n_mcus = mcus_x * mcus_y

    # Per-component coefficient stores [n_blocks, 64]
    coeffs = []
    for c, (bh, bv) in zip(comps, per_mcu):
        coeffs.append(np.zeros((n_mcus * bh * bv, 64), np.int32))

    seg_idx = 0
    reader = _BitReader(segments[seg_idx])
    pred = [0] * len(comps)
    block_counters = [0] * len(comps)
    for m in range(n_mcus):
        if restart_interval and m and m % restart_interval == 0:
            seg_idx += 1
            if seg_idx >= len(segments):
                raise JpegError("missing restart segment")
            reader = _BitReader(segments[seg_idx])
            pred = [0] * len(comps)
        for ci, ((comp, td, ta), (bh, bv)) in enumerate(zip(scan, per_mcu)):
            dc_tbl, ac_tbl = huff_dc[td], huff_ac[ta]
            for _ in range(bh * bv):
                blk = coeffs[ci][block_counters[ci]]
                block_counters[ci] += 1
                t = _decode_huffman(reader, dc_tbl)
                pred[ci] += _extend(reader.receive(t), t)
                blk[0] = pred[ci]
                k = 1
                while k < 64:
                    rs = _decode_huffman(reader, ac_tbl)
                    r, s = rs >> 4, rs & 0xF
                    if s == 0:
                        if r == 15:          # ZRL
                            k += 16
                            continue
                        break                # EOB
                    k += r
                    if k > 63:
                        raise JpegError("AC run past block end")
                    blk[k] = _extend(reader.receive(s), s)
                    k += 1

    # Vectorized reconstruction per component.
    planes = []
    for ci, (c, (bh, bv)) in enumerate(zip(comps, per_mcu)):
        q = qt[c["tq"]]
        deq = coeffs[ci] * q[None, :]
        blocks = np.zeros((deq.shape[0], 64), np.float64)
        blocks[:, ZIGZAG] = deq
        blocks = blocks.reshape(-1, 8, 8)
        # The JPEG IDCT (Annex A.3.3) is exactly the 2-D orthonormal IDCT-II:
        # both carry the 1/4 scale and the C(0)=1/sqrt(2) factors.
        pix = idctn(blocks, axes=(1, 2), norm="ortho") + 128.0
        pix = np.clip(np.round(pix), 0, 255).astype(np.uint8)

        if interleaved:
            # Blocks are in MCU order: [mcus_y, mcus_x, bv, bh, 8, 8].
            grid = pix.reshape(mcus_y, mcus_x, bv, bh, 8, 8)
            plane = grid.transpose(0, 2, 4, 1, 3, 5).reshape(
                mcus_y * bv * 8, mcus_x * bh * 8)
            # Upsample to full resolution (nearest — chroma only).
            ry, rx = vmax // c["v"], hmax // c["h"]
            if ry > 1 or rx > 1:
                plane = np.repeat(np.repeat(plane, ry, 0), rx, 1)
        else:
            grid = pix.reshape(mcus_y, mcus_x, 8, 8)
            plane = grid.transpose(0, 2, 1, 3).reshape(mcus_y * 8, mcus_x * 8)
        planes.append(plane[:H, :W].astype(np.float64))

    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)
