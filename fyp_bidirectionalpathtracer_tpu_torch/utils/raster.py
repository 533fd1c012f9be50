"""Decoded images in Pillow's modes, Pillow's `convert("RGB")` and
`convert("RGBA")` of them, and the TGA and BMP decoders, in numpy and the
standard library, bit for bit as Pillow's `Image.open` reads the files.

`Raster` holds what `Image.open` holds: the mode ("1", "L", "LA", "I;16",
"P", "RGB", "RGBA"), the samples, the palette of a "P" image and the
`transparency` entry of its info.  `convert` copies Pillow's conversions,
quirks included: "I;16" clips at 255; a grey or RGB transparency key is
compared with the samples as stored (so a 2-bit grey PNG's key, which
Pillow does not scale, matches the scaled samples only where they agree);
palette indices past the palette are black and opaque.

TGA (TgaImagePlugin): colour-mapped (16- and 24-bit maps; Pillow fails on
32-bit ones), true-colour and grey images, raw and RLE (types 1, 2, 3, 9,
10, 11) at 8, 16, 24 and 32 bits and raw 1-bit grey, the origin bits; the
type and depth pairs Pillow cannot load fail here too.
BMP (BmpImagePlugin): 1-, 4- and 8-bit palettes (a grey palette read as
Pillow's "1" / "L"), 16-, 24- and 32-bit BI_RGB and the BI_BITFIELDS masks
Pillow takes, bottom-up and top-down rows.  What Pillow reads and these do
not raises `Refused` with the reason; a corrupt or truncated file raises
ValueError.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


class Refused(NotImplementedError):
    """A well-formed file that Pillow reads and the port's decoders do not."""


@dataclass
class Raster:
    mode: str
    pixels: np.ndarray
    palette: np.ndarray | None = None    # [n, 3] or [n, 4] uint8, mode "P"
    transparency: int | tuple | bytes | None = None


def convert(img: Raster, mode: str) -> np.ndarray:
    """Pillow's `convert(mode)` for mode "RGB" or "RGBA": uint8 [H, W, 3 or 4]."""
    px = img.pixels
    trns = img.transparency
    if img.mode == "P":
        cols = img.palette.shape[1]
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:min(256, len(img.palette)), :cols] = img.palette[:256]
        if isinstance(trns, bytes):
            alphas = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alphas), 3] = alphas
        elif isinstance(trns, int) and 0 <= trns < 256:
            table[trns, 3] = 0
        rgba = table[px]
    elif img.mode in ("1", "L", "I;16"):
        grey = np.minimum(px, 255).astype(np.uint8)
        alpha = np.full(px.shape, 255, np.uint8)
        if trns is not None:
            alpha[grey == trns] = 0
        rgba = np.stack([grey, grey, grey, alpha], -1)
    elif img.mode == "LA":
        rgba = px[..., [0, 0, 0, 1]]
    elif img.mode == "RGB":
        alpha = np.full(px.shape[:2], 255, np.uint8)
        if trns is not None:
            alpha[(px.astype(np.int64) == np.asarray(trns, np.int64)).all(-1)] = 0
        rgba = np.concatenate([px, alpha[..., None]], -1)
    elif img.mode == "RGBA":
        rgba = px
    else:
        raise ValueError(f"no conversion from mode {img.mode}")
    return np.ascontiguousarray(rgba[..., :3] if mode == "RGB" else rgba)


# ------------------------------------------------------------- unpackers
def _bgr15(v: np.ndarray) -> np.ndarray:
    """Unpack.c's BGR;15 (5-5-5, the top bit ignored) -> [..., 3] RGB."""
    v = v.astype(np.int64)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31], -1).astype(np.uint8)


def _bgr16(v: np.ndarray) -> np.ndarray:
    """BGR;16 (5-6-5) -> [..., 3] RGB."""
    v = v.astype(np.int64)
    return np.stack([((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63,
                     (v & 31) * 255 // 31], -1).astype(np.uint8)


def _bgra15z(v: np.ndarray) -> np.ndarray:
    """BGRA;15Z: BGR;15 and an alpha of 0 where the top bit is set."""
    alpha = np.where(v.astype(np.int64) >> 15, 0, 255).astype(np.uint8)
    return np.concatenate([_bgr15(v), alpha[..., None]], -1)


def _bytes_order(raw: np.ndarray, order: str) -> np.ndarray:
    """Samples [..., len(order)] stored in the byte order `order` (e.g.
    "BGRA", "XBGR") -> [..., 3] RGB or [..., 4] RGBA."""
    want = "RGBA" if "A" in order else "RGB"
    return raw[..., [order.index(c) for c in want]]


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """[h, stride] bytes of packed 1-, 2- or 4-bit samples, most significant
    first -> [h, width] uint8 values."""
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)


# ------------------------------------------------------------------- TGA
# (image type & 7, depth) -> Pillow's raw mode (TgaImagePlugin.MODES)
_TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
                 (2, 24): "BGR", (2, 32): "BGRA"}


def tga_header_ok(data: bytes) -> bool:
    """Whether Pillow's TGA plugin takes the file (its header checks; TGA
    has no magic bytes)."""
    if len(data) < 18:
        return False
    w, h = struct.unpack("<HH", data[12:16])
    return data[1] in (0, 1) and w > 0 and h > 0 and data[16] in (1, 8, 16, 24, 32) \
        and data[2] in (1, 2, 3, 9, 10, 11)


def _tga_unpack(raw: np.ndarray, rawmode: str) -> np.ndarray:
    """[n, bytes a pixel] -> samples of the image's mode."""
    if rawmode in ("P", "L", "1"):
        return raw[:, 0]
    if rawmode == "LA":
        return raw
    if rawmode == "BGRA;15Z":
        return _bgra15z(raw[:, 0].astype(np.uint16) | raw[:, 1].astype(np.uint16) << 8)
    return _bytes_order(raw, rawmode)


def _tga_rle(data: bytes, pos: int, w: int, h: int, bpp: int) -> np.ndarray:
    """TgaRleDecode.c: packets of a run (the header's top bit: one pixel
    repeated) or of raw pixels, (header & 0x7F) + 1 pixels each; a packet
    that crosses the end of a row is an error there too -> [w * h, bpp]."""
    out = bytearray()
    for _ in range(h):
        x = 0
        while x < w:
            if pos >= len(data):
                raise ValueError("TGA RLE data is truncated")
            head = data[pos]
            count = (head & 0x7F) + 1
            if x + count > w:
                raise ValueError("a TGA RLE packet crosses a row (Pillow's buffer overrun)")
            n = bpp if head & 0x80 else count * bpp
            chunk = data[pos + 1:pos + 1 + n]
            if len(chunk) < n:
                raise ValueError("TGA RLE data is truncated")
            out += chunk * count if head & 0x80 else chunk
            pos += 1 + n
            x += count
    return np.frombuffer(bytes(out), np.uint8).reshape(w * h, bpp)


def decode_tga(data: bytes, name: str = "TGA") -> Raster:
    if not tga_header_ok(data):
        raise ValueError(f"{name}: not a TGA file")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    start, size, map_depth = struct.unpack("<HHB", data[3:8])
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    rawmode = _TGA_RAWMODES.get((itype & 7, depth))
    if rawmode is None or (rawmode == "1" and itype & 8):  # Pillow cannot load these either
        raise ValueError(f"{name}: a TGA of type {itype} at {depth} bits")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        entry = {16: 2, 24: 3}.get(map_depth)
        if entry is None:  # Pillow fails on a 32-bit map too ("unrecognized raw mode")
            raise ValueError(f"{name}: TGA map depth {map_depth} is not read by Pillow either")
        raw = data[pos:pos + entry * size]
        pos += entry * size
        raw = np.frombuffer(bytes(entry * start) + raw, np.uint8)
        raw = raw[:len(raw) // entry * entry].reshape(-1, entry)
        if entry == 2:
            palette = _bgra15z(raw[:, 0].astype(np.uint16) | raw[:, 1].astype(np.uint16) << 8)
        else:
            palette = _bytes_order(raw, "BGR")
    bpp = depth // 8
    if rawmode == "1":  # rows of packed bits, the most significant first
        stride = (w + 7) // 8
        body = data[pos:pos + stride * h]
        if len(body) < stride * h:
            raise ValueError(f"{name}: TGA image data is truncated")
        raw = unpack_bits(np.frombuffer(body, np.uint8).reshape(h, stride), w, 1)
        raw = (raw * np.uint8(255)).reshape(w * h, 1)
    elif itype & 8:
        raw = _tga_rle(data, pos, w, h, bpp)
    else:
        body = data[pos:pos + w * h * bpp]
        if len(body) < w * h * bpp:
            raise ValueError(f"{name}: TGA image data is truncated")
        raw = np.frombuffer(body, np.uint8).reshape(w * h, bpp)
    px = _tga_unpack(raw, rawmode)
    px = px.reshape((h, w) + px.shape[1:])
    if not flags & 0x20:  # rows stored bottom-up
        px = px[::-1]
    if flags & 0x10:  # right to left
        px = px[:, ::-1]
    return Raster(mode, np.ascontiguousarray(px), palette)


# ------------------------------------------------------------------- BMP
_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BI_BITFIELDS masks Pillow takes -> its raw mode
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def decode_bmp(data: bytes, name: str = "BMP") -> Raster:
    def i32(pos):
        if pos + 4 > len(data):
            raise ValueError(f"{name}: BMP header is truncated")
        return struct.unpack("<I", data[pos:pos + 4])[0]

    def i16(pos):
        if pos + 2 > len(data):
            raise ValueError(f"{name}: BMP header is truncated")
        return struct.unpack("<H", data[pos:pos + 2])[0]

    if data[:2] != b"BM":
        raise ValueError(f"{name}: not a BMP file")
    offset, header_size = i32(10), i32(14)
    pos = 14 + header_size  # the file position after the header
    direction = -1
    if header_size == 12:
        w, h, bits = i16(18), i16(20), i16(24)
        compression, colors, padding = 0, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        if pos > len(data):
            raise ValueError(f"{name}: BMP header is truncated")
        y_flip = data[25] == 0xFF
        direction = 1 if y_flip else -1
        w = i32(18)
        h = 2 ** 32 - i32(22) if y_flip else i32(22)
        bits, compression, colors, padding = i16(28), i32(30), i32(46), 4
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({header_size})")
    masks = None
    if header_size != 12 and compression == 3:  # BI_BITFIELDS
        if header_size >= 52:
            masks = (i32(54), i32(58), i32(62), i32(66) if header_size >= 56 else 0)
        else:  # a 40-byte header: three masks after it
            masks = (i32(pos), i32(pos + 4), i32(pos + 8), 0)
            pos += 12
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, rawmode = _BMP_BITS[bits]
    if compression == 3:
        if bits == 32 and masks in [k[1] for k in _BMP_MASKS if k[0] == 32]:
            rawmode = _BMP_MASKS[(32, masks)]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits in (24, 16) and (bits, masks[:3]) in _BMP_MASKS:
            rawmode = _BMP_MASKS[(bits, masks[:3])]
        else:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
    elif compression in (1, 2):
        raise Refused(f"{name}: RLE-compressed BMP is not read")
    elif compression != 0:
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    if w <= 0 or h <= 0 or w >= 1 << 31 or h >= 1 << 31:
        raise ValueError(f"{name}: a BMP of size {w}x{h}")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        pal = data[pos:pos + padding * colors]
        indices = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(indices))
        if grey:
            mode = "1" if colors == 2 else "L"
            if bits == 4:
                raise Refused(f"{name}: a 4-bit BMP with a grey palette is not read "
                              f"(Pillow reads its samples as 8-bit)")
        else:
            pal = np.frombuffer(pal[:len(pal) // padding * padding], np.uint8)
            palette = pal.reshape(-1, padding)[:, [2, 1, 0]]
    stride = ((w * bits + 31) >> 3) & ~3
    body = data[offset:offset + stride * h]
    if len(body) < stride * h:
        raise ValueError(f"{name}: BMP image data is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    if bits < 8:
        px = unpack_bits(rows, w, bits)
        if mode == "1":
            px = px * np.uint8(255)
    elif bits == 8:
        px = rows[:, :w]
    elif bits == 16:
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16)
        v = v[..., 0] | v[..., 1] << 8
        px = _bgr16(v) if rawmode == "BGR;16" else _bgr15(v)
    else:
        px = _bytes_order(rows[:, :w * bits // 8].reshape(h, w, bits // 8), rawmode)
    if direction < 0:
        px = px[::-1]
    return Raster(mode, np.ascontiguousarray(px), palette)
