"""JPEG decoding in numpy and the standard library: what `Image.open(path)`
gives, bit for bit, with the libjpeg-turbo that Pillow calls and Pillow's
defaults (the integer "islow" IDCT, fancy upsampling, no block smoothing
left to do on a complete file, no EXIF orientation).

Read: baseline and extended Huffman frames of 8 bits a sample (SOF0,
SOF1), progressive Huffman frames (SOF2: DC first and refine, AC first and
refine with end-of-band runs), 1 or 3 components (the colour space guessed
as libjpeg does: a JFIF marker means YCbCr, then the Adobe marker's
transform, then the component ids), restart intervals, the sampling layouts
4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2) and any other made of those two
upsamplings; APPn, COM and other segments are skipped.

After entropy decoding every stage runs on all blocks at once, in integer
numpy: dequantisation, `jidctint.c`'s islow IDCT with its range limit,
`jdsample.c`'s fancy h2v1 / h2v2 upsampling (box replication where the
downsampled width is 2 or less, as libjpeg chooses) and `jdcolor.c`'s
YCbCr -> RGB tables.  Entropy decoding is a Python loop over the symbols
with a 16-bit lookahead table for each Huffman table.

What is refused, with the reason (`Refused`, a NotImplementedError):
12-bit samples, arithmetic coding, lossless and hierarchical frames, 2 or
4 components (CMYK / YCCK), a DNL marker, other sampling layouts, and a
progressive file whose scans leave an AC coefficient unfinished (libjpeg
smooths such blocks).  A corrupt or truncated file raises ValueError.
"""
from __future__ import annotations

import re
from array import array
import struct

import numpy as np

from .raster import Refused

SOI, EOI, SOS, DHT, DQT, DRI, DNL = 0xD8, 0xD9, 0xDA, 0xC4, 0xDB, 0xDD, 0xDC
APP0, APP14 = 0xE0, 0xEE

# position in the block (row-major) of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_NATURAL = ZIGZAG.tolist()

# entropy-coded data ends at a marker that is neither a stuffed 0x00 nor RSTn
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")

# the SOFn markers that are not read (SOF0-SOF2 are), by what they are
_SOF_REFUSED = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA:
    "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless", 0xCD:
    "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}


def _corrupt(why: str) -> ValueError:
    return ValueError(f"corrupt JPEG data: {why}")


# ------------------------------------------------------------ the markers
def _next_segment(data: bytes, pos: int):
    """(marker, payload, offset after the payload) of the marker segment at
    or after `pos`; an SOS payload is its header alone (the entropy-coded
    data follows at the offset).  Stray bytes before a marker are skipped,
    as libjpeg skips them."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            raise _corrupt("the file ends before its EOI marker (truncated)")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            raise _corrupt("the file ends before its EOI marker (truncated)")
        marker = data[pos]
        pos += 1
        if marker in (SOI, EOI):
            return marker, b"", pos
        if marker in (0x00, 0x01) or 0xD0 <= marker <= 0xD7:
            continue  # a stuffed byte, TEM, a stray RSTn
        if pos + 2 > n:
            raise _corrupt("the file ends inside a marker segment (truncated)")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        if length < 2 or pos + length > n:
            raise _corrupt(f"marker 0x{marker:02X}'s segment is truncated")
        return marker, data[pos + 2:pos + length], pos + length


def _is_sof(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (DHT, 0xC8, 0xCC)


def _frame(marker: int, payload: bytes) -> dict:
    if len(payload) < 6:
        raise _corrupt("a short SOF segment")
    precision, height, width, nf = struct.unpack(">BHHB", payload[:6])
    if len(payload) < 6 + 3 * nf or nf == 0:
        raise _corrupt("a short SOF segment")
    comps = []
    for i in range(nf):
        cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    return {"marker": marker, "precision": precision, "height": height, "width": width,
            "comps": comps}


def _frame_refusal(frame: dict) -> str | None:
    """Why a frame with this SOF is not read, or None."""
    marker = frame["marker"]
    if marker in _SOF_REFUSED:
        return f"{_SOF_REFUSED[marker]} JPEG (SOF{marker - 0xC0}) is not read"
    if frame["precision"] != 8:
        return f"{frame['precision']}-bit JPEG samples are not read (8 bits only)"
    nf = len(frame["comps"])
    if nf == 4:
        return "4-component JPEG (CMYK / YCCK) is not read"
    if nf not in (1, 3):
        return f"{nf}-component JPEG is not read (1 or 3 only)"
    if frame["height"] == 0:
        return "a JPEG whose height comes in a DNL marker is not read"
    if nf == 3:
        hmax = max(c["h"] for c in frame["comps"])
        vmax = max(c["v"] for c in frame["comps"])
        for c in frame["comps"]:
            if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
                return None  # corrupt: reported by the decoder
            if (hmax, vmax) not in ((c["h"], c["v"]), (2 * c["h"], c["v"]),
                                    (2 * c["h"], 2 * c["v"])):
                layout = "x".join(f"{k['h']}{k['v']}" for k in frame["comps"])
                return (f"JPEG sampling factors {layout} are not read (4:4:4, 4:2:2 "
                        f"and 4:2:0 only)")
    return None


def jpeg_refusal(path: str) -> str | None:
    """The reason `decode_jpeg` refuses a well-formed JPEG that Pillow
    reads, from its markers up to the frame header; None where it reads the
    file or where the file is not a well-formed JPEG (reported as such)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"\xff\xd8":
        return None
    pos = 2
    try:
        while True:
            marker, payload, pos = _next_segment(data, pos)
            if marker == DNL:
                return f"{path}: a JPEG with a DNL marker is not read"
            if _is_sof(marker):
                reason = _frame_refusal(_frame(marker, payload))
                return None if reason is None else f"{path}: {reason}"
            if marker in (SOS, EOI, SOI):
                return None
    except ValueError:
        return None


# ------------------------------------------------------- Huffman decoding
def _huffman_tables(payload: bytes, tables: dict) -> None:
    """Each table of a DHT segment as a 16-bit lookahead list: entry x is
    (code length << 8) | symbol for the code that starts the 16 bits x, 0
    where no code does."""
    pos = 0
    while pos < len(payload):
        if pos + 17 > len(payload):
            raise _corrupt("a short DHT segment")
        tc_th = payload[pos]
        counts = payload[pos + 1:pos + 17]
        total = sum(counts)
        symbols = payload[pos + 17:pos + 17 + total]
        if len(symbols) < total or total > 256:
            raise _corrupt("a short DHT segment")
        look = np.zeros(1 << 16, np.int32)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise _corrupt("a Huffman table with too many codes")
                shift = 16 - length
                look[code << shift:(code + 1) << shift] = (length << 8) | symbols[k]
                code += 1
                k += 1
            code <<= 1
        tables[(tc_th >> 4, tc_th & 15)] = look.tolist()
        pos += 17 + total


def _windows(segment: bytes) -> list:
    """The 32 bits from each byte of `segment` on (zeros past its end), so
    that any 25 bits from bit p are one shift of entry p >> 3."""
    b = np.frombuffer(segment + b"\0\0\0\0", np.uint8).astype(np.int64)
    return (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()


class _Scan:
    """One scan's entropy-coded data from `start` on: where it ends (the
    next marker but RSTn), and its restart intervals, each (first MCU, MCU
    past the last, the interval's bytes with the stuffed zeros taken out)."""

    def __init__(self, data: bytes, start: int, n_mcu: int, restart: int):
        m = _SCAN_END.search(data, start)
        if m is None:
            raise _corrupt("the file ends inside a scan (truncated)")
        self.end = m.start()
        raw = _RST.split(data[start:self.end])
        per = restart or n_mcu
        want = -(-n_mcu // per)
        if len(raw) < want:
            raise _corrupt("a scan has fewer restart intervals than MCUs (truncated)")
        self.intervals = [(j * per, min(n_mcu, (j + 1) * per), raw[j].replace(b"\xff\x00", b"\xff"))
                          for j in range(want)]


def _check_end(p: int, seg: bytes) -> None:
    if p > 8 * len(seg):
        raise _corrupt("a scan's entropy-coded data runs out (truncated)")


def _sequential(scan, order, bpm, coefs, dc_tabs, ac_tabs):
    """A baseline / extended scan: each block's DC difference and its AC
    run-length pairs."""
    nat = _NATURAL
    for m0, m1, seg in scan.intervals:
        win = _windows(seg)
        p = 0
        pred = [0] * len(coefs)
        for b in range(m0 * bpm, m1 * bpm):
            slot, base = order[b]
            coef = coefs[slot]
            look = dc_tabs[slot]
            e = look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise _corrupt("a bad Huffman code")
            p += e >> 8
            s = e & 15
            diff = 0
            if s:
                diff = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if diff < 1 << (s - 1):
                    diff += 1 - (1 << s)
            pred[slot] += diff
            coef[base] = pred[slot]
            look = ac_tabs[slot]
            k = 1
            while k < 64:
                e = look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise _corrupt("a bad Huffman code")
                p += e >> 8
                rs = e & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    coef[base + nat[k]] = v
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
            if k > 64:
                raise _corrupt("an AC run past the end of a block")
        _check_end(p, seg)


def _dc_first(scan, order, bpm, coefs, dc_tabs, al):
    for m0, m1, seg in scan.intervals:
        win = _windows(seg)
        p = 0
        pred = [0] * len(coefs)
        for b in range(m0 * bpm, m1 * bpm):
            slot, base = order[b]
            e = dc_tabs[slot][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise _corrupt("a bad Huffman code")
            p += e >> 8
            s = e & 15
            diff = 0
            if s:
                diff = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if diff < 1 << (s - 1):
                    diff += 1 - (1 << s)
            pred[slot] += diff
            coefs[slot][base] = pred[slot] << al
        _check_end(p, seg)


def _dc_refine(scan, order, bpm, coefs, al):
    bit = 1 << al
    for m0, m1, seg in scan.intervals:
        win = _windows(seg)
        p = 0
        for b in range(m0 * bpm, m1 * bpm):
            slot, base = order[b]
            if (win[p >> 3] >> (31 - (p & 7))) & 1:
                coefs[slot][base] |= bit
            p += 1
        _check_end(p, seg)


def _ac_first(scan, order, coef, look, ss, se, al):
    nat = _NATURAL
    for m0, m1, seg in scan.intervals:
        win = _windows(seg)
        p = 0
        eobrun = 0
        for b in range(m0, m1):
            if eobrun:
                eobrun -= 1
                continue
            base = order[b][1]
            k = ss
            while k <= se:
                e = look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise _corrupt("a bad Huffman code")
                p += e >> 8
                rs = e & 255
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    if k > se:
                        raise _corrupt("an AC run past the end of a band")
                    coef[base + nat[k]] = v << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
                k += 1
        _check_end(p, seg)


def _ac_refine(scan, order, coef, look, ss, se, al):
    """jdphuff.c's decode_mcu_AC_refine: new coefficients of magnitude
    1 << al and a correction bit for each coefficient already nonzero."""
    nat = _NATURAL
    p1, m1 = 1 << al, -1 << al
    for first, stop, seg in scan.intervals:
        win = _windows(seg)
        p = 0
        eobrun = 0
        for b in range(first, stop):
            base = order[b][1]
            k = ss
            if not eobrun:
                while k <= se:
                    e = look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise _corrupt("a bad Huffman code")
                    p += e >> 8
                    rs = e & 255
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                            p += r
                        break
                    while k <= se:
                        i = base + nat[k]
                        c = coef[i]
                        if c:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                coef[i] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        if k > se:
                            raise _corrupt("a new coefficient past the end of a band")
                        coef[base + nat[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    i = base + nat[k]
                    c = coef[i]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coef[i] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1
        _check_end(p, seg)


# ------------------------------------------------ IDCT, upsampling, colour
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# jdmaster.c's range-limit table as the IDCT indexes it (x & 1023, x the
# output less its 128 centre): 128..255, then 255, then 0, then 0..127
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(128)]).astype(np.uint8)


def _idct_1d(x, descale: int):
    """jidctint.c's islow pass on the 8 inputs x[0..7] (int64 arrays):
    the 8 outputs, descaled by `descale` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 += z1 + z3
    tmp1 += z2 + z4
    tmp2 += z2 + z3
    tmp3 += z1 + z4

    half = 1 << (descale - 1)
    return [(tmp10 + tmp3 + half) >> descale, (tmp11 + tmp2 + half) >> descale,
            (tmp12 + tmp1 + half) >> descale, (tmp13 + tmp0 + half) >> descale,
            (tmp13 - tmp0 + half) >> descale, (tmp12 - tmp1 + half) >> descale,
            (tmp11 - tmp2 + half) >> descale, (tmp10 - tmp3 + half) >> descale]


def _idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[n, 64] coefficients (row-major in the block) and their quantisation
    table [64] -> [n, 8, 8] uint8 samples, as jpeg_idct_islow writes them
    (its all-zero column and row shortcuts give the same values)."""
    x = coef.astype(np.int64) * quant.astype(np.int64)
    x = x.reshape(-1, 8, 8)
    # pass 1: columns, from the rows of coefficients
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS), axis=1)
    # pass 2: rows
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            CONST_BITS + PASS1_BITS + 3), axis=2)
    return _IDCT_LIMIT[out & 1023]


def _h2_fancy(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: each sample becomes two, 3/4 of it and 1/4 of
    its left / right neighbour (edges replicated), rounded with biases 1
    and 2. x: [rows, width] int32."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    # the edges are the samples themselves, as the special cases write them
    out[:, 0], out[:, -1] = x[:, 0], x[:, -1]
    return out


def _h2v2_fancy(x: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3 * nearer row + farther row (rows
    replicated at the edges), then 3/4 and 1/4 across, biases 8 and 7."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, near in ((0, 3 * x + up), (1, 3 * x + down)):
        last = np.concatenate([near[:, :1], near[:, :-1]], axis=1)
        nxt = np.concatenate([near[:, 1:], near[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * near + last + 8) >> 4
        out[v::2, 1::2] = (3 * near + nxt + 7) >> 4
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's [height, width] samples at its downsampled size, up by
    (fh, fv) in (1, 1), (2, 1), (2, 2), as jdsample.c chooses: fancy where
    the downsampled width exceeds 2, else box replication."""
    if (fh, fv) == (1, 1):
        return plane
    x = plane.astype(np.int32)
    if x.shape[1] <= 2:
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    return (_h2_fancy(x) if fv == 1 else _h2v2_fancy(x)).astype(np.uint8)


# jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)
def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_CB = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CB + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CB + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CB
_CB_G = -_fix(0.34414) * _CB + (1 << 15)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """ycc_rgb_convert: uint8 planes -> [..., 3] uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ------------------------------------------------------------ the decoder
def _geometry(frame: dict) -> list:
    """Each component's sampling: its factors, its size at its own
    resolution (cw, ch), the blocks a non-interleaved scan codes (nbx, nby)
    and the blocks stored, whole MCUs (bw, bh)."""
    x, y = frame["width"], frame["height"]
    hmax = max(c["h"] for c in frame["comps"])
    vmax = max(c["v"] for c in frame["comps"])
    mcux, mcuy = -(-x // (8 * hmax)), -(-y // (8 * vmax))
    out = []
    for c in frame["comps"]:
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            raise _corrupt("a sampling factor outside 1..4")
        cw, ch = -(-x * c["h"] // hmax), -(-y * c["v"] // vmax)
        out.append({"h": c["h"], "v": c["v"], "fh": hmax // c["h"], "fv": vmax // c["v"],
                    "cw": cw, "ch": ch, "nbx": -(-cw // 8), "nby": -(-ch // 8),
                    "bw": mcux * c["h"], "bh": mcuy * c["v"], "mcux": mcux, "mcuy": mcuy})
    return out


def _block_order(slots: list, geometry: list):
    """(list of (slot, coefficient offset) in coding order, blocks an MCU,
    MCUs) of a scan over the components `slots`."""
    if len(slots) == 1:
        g = geometry[slots[0]]
        by, bx = np.meshgrid(np.arange(g["nby"]), np.arange(g["nbx"]), indexing="ij")
        base = ((by * g["bw"] + bx) * 64).reshape(-1)
        return [(slots[0], b) for b in base.tolist()], 1, base.size
    g0 = geometry[slots[0]]
    my, mx = np.meshgrid(np.arange(g0["mcuy"]), np.arange(g0["mcux"]), indexing="ij")
    slot_cols, base_cols = [], []
    for slot in slots:
        g = geometry[slot]
        for v in range(g["v"]):
            for h in range(g["h"]):
                slot_cols.append(np.full(my.shape, slot))
                base_cols.append(((my * g["v"] + v) * g["bw"] + mx * g["h"] + h) * 64)
    slot_arr = np.stack(slot_cols, -1).reshape(-1)
    base_arr = np.stack(base_cols, -1).reshape(-1)
    return list(zip(slot_arr.tolist(), base_arr.tolist())), len(slot_cols), my.size


def _decode_scan(data: bytes, pos: int, header: bytes, state: dict) -> int:
    """Decode the scan whose SOS header is `header` and whose entropy-coded
    data starts at `pos` into the coefficient lists; the offset of the
    marker after it."""
    frame, geometry, coefs = state["frame"], state["geometry"], state["coefs"]
    if not header:
        raise _corrupt("a short SOS segment")
    ns = header[0]
    if not 1 <= ns <= 4 or len(header) < 4 + 2 * ns:
        raise _corrupt("a short SOS segment")
    ids = [c["id"] for c in frame["comps"]]
    slots, dc_ids, ac_ids = [], [], []
    for i in range(ns):
        cid, t = header[1 + 2 * i:3 + 2 * i]
        if cid not in ids:
            raise _corrupt(f"a scan names component {cid}, which the frame lacks")
        slots.append(ids.index(cid))
        dc_ids.append(t >> 4)
        ac_ids.append(t & 15)
    ss, se, a = header[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    for slot in slots:  # libjpeg latches a component's table at its first scan
        if slot not in state["latched"]:
            tq = frame["comps"][slot]["tq"]
            if tq not in state["quant"]:
                raise _corrupt(f"quantisation table {tq} is not defined")
            state["latched"][slot] = state["quant"][tq]
    order, bpm, n_mcu = _block_order(slots, geometry)
    scan = _Scan(data, pos, n_mcu, state["restart"])

    def table(kind, tid):
        if (kind, tid) not in state["tables"]:
            raise _corrupt(f"Huffman table {kind}/{tid} is not defined")
        return state["tables"][(kind, tid)]

    try:
        _decode_entropy(scan, order, bpm, slots, dc_ids, ac_ids, ss, se, ah, al, state, table)
    except (IndexError, OverflowError):  # a run or a read past a block or the data
        raise _corrupt("entropy-coded data past a block or a scan") from None
    return scan.end


def _decode_entropy(scan, order, bpm, slots, dc_ids, ac_ids, ss, se, ah, al, state, table):
    coefs = state["coefs"]
    if not state["progressive"]:
        dc = [None] * len(coefs)
        ac = [None] * len(coefs)
        for slot, d, t in zip(slots, dc_ids, ac_ids):
            dc[slot], ac[slot] = table(0, d), table(1, t)
        _sequential(scan, order, bpm, coefs, dc, ac)
        return
    if ss > se or se > 63 or (ss == 0) != (se == 0) or (ss > 0 and len(slots) != 1) or al > 13:
        raise _corrupt(f"a progressive scan with bands {ss}..{se}, {len(slots)} components")
    for slot in slots:
        bits = state["coef_bits"][slot]
        for k in range(ss, se + 1):
            if (bits[k] < 0) != (ah == 0) or (ah and bits[k] != ah):
                raise _corrupt("a progressive scan out of order")
            bits[k] = al
    if ss == 0:
        if ah == 0:
            dc = [None] * len(coefs)
            for slot, d in zip(slots, dc_ids):
                dc[slot] = table(0, d)
            _dc_first(scan, order, bpm, coefs, dc, al)
        else:
            _dc_refine(scan, order, bpm, coefs, al)
    elif ah == 0:
        _ac_first(scan, order, coefs[slots[0]], table(1, ac_ids[0]), ss, se, al)
    else:
        _ac_refine(scan, order, coefs[slots[0]], table(1, ac_ids[0]), ss, se, al)


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """The file's bytes -> uint8 [H, W] (one component, Pillow's mode "L")
    or [H, W, 3] (three, mode "RGB"), bit for bit as Pillow decodes it.
    Raises Refused for what is not read, ValueError for a corrupt file."""
    if data[:2] != b"\xff\xd8":
        raise _corrupt("no SOI marker")
    state = {"quant": {}, "tables": {}, "restart": 0, "latched": {}, "frame": None,
             "progressive": False}
    jfif = adobe = False
    transform = None
    pos, scans = 2, 0
    while True:
        marker, payload, pos = _next_segment(data, pos)
        if marker == EOI:
            break
        if marker == SOI:
            raise _corrupt("a second SOI marker")
        if marker == DQT:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                size = 128 if pq else 64
                raw = payload[i + 1:i + 1 + size]
                if len(raw) < size:
                    raise _corrupt("a short DQT segment")
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = np.frombuffer(raw, ">u2" if pq else np.uint8)
                state["quant"][tq] = table
                i += 1 + size
        elif marker == DHT:
            _huffman_tables(payload, state["tables"])
        elif marker == DRI:
            if len(payload) < 2:
                raise _corrupt("a short DRI segment")
            state["restart"] = struct.unpack(">H", payload[:2])[0]
        elif marker == DNL:
            raise Refused(f"{name}: a JPEG with a DNL marker is not read")
        elif marker == APP0 and payload[:5] == b"JFIF\0":
            jfif = True
        elif marker == APP14 and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe, transform = True, payload[11]
        elif _is_sof(marker):
            if state["frame"] is not None:
                raise _corrupt("a second frame header")
            frame = _frame(marker, payload)
            reason = _frame_refusal(frame)
            if reason is not None:
                raise Refused(f"{name}: {reason}")
            if frame["width"] == 0:
                raise _corrupt("a frame of width 0")
            geometry = _geometry(frame)
            # every block costs its DC code, a bit at least
            if sum(g["nbx"] * g["nby"] for g in geometry) > 8 * len(data):
                raise _corrupt("a frame larger than the file's data")
            state.update(frame=frame, geometry=geometry, progressive=marker == 0xC2,
                         coefs=[array("i", bytes(4 * g["bh"] * g["bw"] * 64)) for g in geometry],
                         coef_bits=[[-1] * 64 for _ in geometry])
        elif marker == SOS:
            if state["frame"] is None:
                raise _corrupt("a scan before the frame header")
            pos = _decode_scan(data, pos, payload, state)
            scans += 1
    if not scans:
        raise _corrupt("no scan")
    frame, geometry = state["frame"], state["geometry"]
    if state["progressive"]:
        for slot, bits in enumerate(state["coef_bits"]):
            if any(b != 0 for b in bits[1:10]):
                raise Refused(f"{name}: a progressive JPEG whose scans leave AC coefficients "
                              f"unfinished is not read (libjpeg smooths its blocks)")
    planes = []
    for slot, g in enumerate(geometry):
        if slot not in state["latched"]:
            raise _corrupt(f"component {frame['comps'][slot]['id']} is in no scan")
        coef = np.frombuffer(state["coefs"][slot], np.int32).reshape(-1, 64)
        blocks = _idct_islow(coef, state["latched"][slot])
        plane = blocks.reshape(g["bh"], g["bw"], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(g["bh"] * 8, g["bw"] * 8)[:g["ch"], :g["cw"]]
        planes.append(_upsample(plane, g["fh"], g["fv"])[:frame["height"], :frame["width"]])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c["id"] for c in frame["comps"])
    if jfif:
        ycc = True
    elif adobe:
        ycc = transform != 0
    else:
        ycc = ids != (82, 71, 66)  # 'R', 'G', 'B'
    if not ycc:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)
