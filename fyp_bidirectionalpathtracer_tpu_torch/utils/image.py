"""Image I/O and quality metrics (PNG, JPEG, TGA, BMP, Radiance HDR,
PSNR): the test harness's analogue of Falcor's screenshot capture +
ImageMagick compare (RunTestsSet.py:262-289).

Port of `fyp_bidirectionalpathtracer_tpu/utils/image.py`.  Every function
works on numpy, as JAX's do; a torch tensor is taken through
`.detach().cpu().numpy()` first, so 8-bit output is bit-equal to JAX's.
No PIL: `write_png` writes 8-bit RGB (or grey for a 2-D image) with filter
0 through `zlib` and `struct`, and the readers decode with numpy and the
standard library, bit for bit as JAX's PIL calls do.  As `Image.open`, a
reader picks the decoder by the file's first bytes, not its name: PNG
(every colour type and bit depth, tRNS, Adam7 interlacing, here), JPEG
(`utils/jpeg.py`), BMP and TGA (`utils/raster.py`, which also holds
Pillow's mode conversions).  `read_png` is JAX's reader of any format,
PIL's `convert("RGB")`; `read_rgba` is `convert("RGBA")`, what the scene
loaders' texture maps take.  A well-formed file that PIL reads and the
port does not (TIFF, GIF, WebP, DDS, ..., and the cases `refusal` names)
raises `Refused`, a NotImplementedError; a corrupt or truncated one
ValueError (or `zlib.error`), as PIL raises in JAX.  `read_image` reads
`.hdr` by its suffix, as JAX does.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg, jpeg_refusal
from .raster import (
    Raster,
    Refused,
    convert,
    decode_bmp,
    decode_tga,
    tga_header_ok,
    unpack_bits,
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel by PNG colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths of each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# what a corrupt or truncated file raises (a refused one raises Refused)
DECODE_ERRORS = (OSError, ValueError, struct.error, zlib.error)
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# formats PIL opens and the port does not decode, by their first bytes (not
# ICO and CUR, whose magic bytes begin many TGA files)
_OTHER_FORMATS = (
    (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"II+\0", "BigTIFF"), (b"MM\0+", "BigTIFF"),
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"DDS ", "DDS"), (b"8BPS", "PSD"),
    (b"qoif", "QOI"),
    (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"P1", "PNM"), (b"P2", "PNM"), (b"P3", "PNM"), (b"P4", "PNM"), (b"P5", "PNM"),
    (b"P6", "PNM"), (b"P7", "PAM"))


def _numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):  # a torch tensor, on any device
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_u8(img) -> np.ndarray:
    arr = _numpy(img)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """8-bit PNG of `img` (float [H, W, 3 or 4] in [0, 1], alpha dropped, or
    [H, W] grey), every row with filter 0 (none)."""
    u8 = to_u8(img)
    if u8.ndim == 2:
        ctype = 0
    elif u8.ndim == 3 and u8.shape[-1] == 3:
        ctype = 2
    else:
        raise ValueError(f"write_png takes [H, W, 3 or 4] or [H, W], got {u8.shape}")
    h, w = u8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, -1)], axis=1)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))


def _unfilter_walk(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte needs its decoded left
    neighbour, so these walk the row."""
    out = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            out[i] = (out[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of h rows of `stride` bytes, each led by its
    filter byte: [h, stride] uint8.  None, Sub (a cumulative sum mod 256
    per byte of the pixel) and Up (one add) are vectorised."""
    data = data.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_walk(kind, line, prev, bpp)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """[h, stride] unfiltered bytes -> [h, w, channels] samples (uint8, or
    uint16 at 16 bits); 1-, 2- and 4-bit samples are packed from the most
    significant bit."""
    h = rows.shape[0]
    if depth < 8:
        return unpack_bits(rows, w, depth)[..., None]
    if depth == 8:
        return rows[:, :w * channels].reshape(h, w, channels)
    pairs = rows[:, :2 * w * channels].reshape(h, w, channels, 2).astype(np.uint16)
    return pairs[..., 0] << 8 | pairs[..., 1]


def _png_samples(raw: bytes, w: int, h: int, depth: int, channels: int,
                 interlace: int) -> np.ndarray:
    """The decompressed IDAT stream -> [h, w, channels] samples, one image or
    Adam7's seven passes scattered into their pixels."""
    data = np.frombuffer(raw, np.uint8)
    bpp = max(1, channels * depth // 8)
    passes = []
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            stride = -(-pw * channels * depth // 8)
            passes.append((x0, y0, dx, dy, pw, ph, stride, pos))
            pos += ph * (stride + 1)
    if pos > data.size:
        raise ValueError("PNG image data is truncated")
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    for x0, y0, dx, dy, pw, ph, stride, pos in passes:
        rows = _unfilter(data[pos:pos + ph * (stride + 1)], ph, stride, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, channels)
    return out


def _png_raster(data: bytes, name: str) -> Raster:
    """A PNG's bytes -> the image `Image.open` holds: PngImagePlugin's mode
    for the colour type and depth (1-, 2- and 4-bit grey scaled to 8 bits,
    16-bit grey as "I;16", other 16-bit samples cut to their high byte),
    the palette, and the tRNS chunk as its `transparency` entry."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG")
    pos, idat, hdr, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if len(payload) < n:
            raise ValueError(f"{name}: PNG chunk {kind!r} is truncated")
        if not idat and kind != b"IDAT":  # PIL checks the chunks before the data
            crc = data[pos + 8 + n:pos + 12 + n]
            if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(kind + payload):
                raise ValueError(f"{name}: broken PNG file (bad checksum in {kind!r})")
        if kind == b"IHDR":
            if n < 13:
                raise ValueError(f"{name}: a short IHDR chunk")
            hdr = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(payload[:n // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{name}: unknown PNG mode (colour type {ctype}, {depth} bits)")
    if w == 0 or h == 0 or interlace > 1:
        raise ValueError(f"{name}: a PNG header of {w}x{h}, interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    if not idat:
        raise ValueError(f"{name}: no IDAT chunk")
    px = _png_samples(zlib.decompress(b"".join(idat)), w, h, depth, _CHANNELS[ctype], interlace)

    def key(count):
        if trns is None:
            return None
        if len(trns) < 2 * count:
            raise ValueError(f"{name}: a tRNS chunk of {len(trns)} bytes for colour type {ctype}")
        return struct.unpack(f">{count}H", trns[:2 * count])

    if ctype == 0:
        grey = px[..., 0]
        k = key(1)
        if depth == 16:
            return Raster("I;16", grey, transparency=None if k is None else k[0])
        if depth == 1:
            return Raster("1", grey * np.uint8(255),
                          transparency=None if k is None else (255 if k[0] else 0))
        scale = {2: 85, 4: 17, 8: 1}[depth]
        return Raster("L", grey * np.uint8(scale), transparency=None if k is None else k[0])
    if ctype == 3:  # the tRNS chunk's alphas; PIL keeps a single 0 entry's index, same alphas
        return Raster("P", px[..., 0], palette, trns)
    hi = (px >> 8).astype(np.uint8) if depth == 16 else px
    if ctype == 2:
        return Raster("RGB", hi, transparency=key(3))
    if ctype == 4:
        return Raster("LA", hi) if depth == 8 else Raster("RGBA", hi[..., [0, 0, 0, 1]])
    return Raster("RGBA", hi)


def _other_format(data: bytes) -> str | None:
    for magic, fmt in _OTHER_FORMATS:
        if data.startswith(magic):
            return fmt
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"heic", b"heix", b"mif1"):
        return "AVIF / HEIF"
    return None


def decode(path: str) -> Raster:
    """The image file at `path` as `Image.open(path)` holds it, the decoder
    chosen by the file's first bytes."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] == _PNG_SIGNATURE:
        return _png_raster(data, path)
    if data[:3] == b"\xff\xd8\xff":
        px = decode_jpeg(data, path)
        return Raster("L" if px.ndim == 2 else "RGB", px)
    if data[:2] == b"BM":
        return decode_bmp(data, path)
    fmt = _other_format(data)
    if fmt is not None:
        raise Refused(f"{path}: {fmt} images are not read (PNG, JPEG, BMP, TGA and .hdr)")
    if tga_header_ok(data):
        return decode_tga(data, path)
    raise ValueError(f"cannot identify image file {path!r}")


def refusal(path: str) -> str | None:
    """The reason the readers refuse a well-formed file that PIL reads, from
    its first bytes and headers (the JPEG decoder may find one more: a
    progressive file whose scans stop short); None where they read it or
    where the file is not a well-formed image (reported as such)."""
    with open(path, "rb") as fh:
        head = fh.read(32)
    if head[:3] == b"\xff\xd8\xff":
        return jpeg_refusal(path)
    if head[:8] == _PNG_SIGNATURE:
        return None
    fmt = _other_format(head)
    if fmt is not None:
        return f"{path}: {fmt} images are not read (PNG, JPEG, BMP, TGA and .hdr)"
    if head[:2] == b"BM" or tga_header_ok(head):
        try:
            decode(path)
        except Refused as e:
            return str(e)
        except (ValueError, struct.error):
            return None
    return None


def read_png(path: str) -> np.ndarray:
    """An image file -> float32 [H, W, 3] in [0, 1]: PIL's
    `Image.open(path).convert("RGB")` of it, as JAX's `read_png`."""
    return convert(decode(path), "RGB").astype(np.float32) / 255.0


def read_rgba(path: str) -> np.ndarray:
    """An image file -> float32 [H, W, 4] in [0, 1]: PIL's
    `convert("RGBA")` of it (a palette's or a colour key's transparency
    applied), what the scene loaders' texture maps take."""
    return convert(decode(path), "RGBA").astype(np.float32) / 255.0


def mse(a, b) -> float:
    a = np.asarray(_numpy(a), np.float64)
    b = np.asarray(_numpy(b), np.float64)
    if a.shape[-1] == 4:
        a = a[..., :3]
    if b.shape[-1] == 4:
        b = b[..., :3]
    return float(np.mean((a - b) ** 2))


def psnr(a, b, peak: float = 1.0) -> float:
    m = mse(a, b)
    if m <= 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))


def read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> [h, w, 4] float32 (a=1).

    Handles the 32-bit_rle_rgbe format: new-style RLE scanlines (0x02 0x02
    length marker, per-component runs) and flat scanlines.  Decode follows
    Radiance's ldexp((c + 0.5) / 256, e - 128).
    """
    with open(path, "rb") as fh:
        if not fh.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance file")
        while True:
            line = fh.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = fh.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported resolution line {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = fh.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 \
                and (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:  # flat scanline
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4

    mant = rgbe[..., :3].astype(np.float32) + 0.5
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0 / 256.0, e - 128)).astype(np.float32)
    rgb = mant * scale[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)


def write_hdr(path: str, img) -> None:
    """Minimal Radiance RGBE writer (flat scanlines) for fixtures/tests."""
    rgb = np.asarray(_numpy(img), np.float32)[..., :3]
    h, w = rgb.shape[:2]
    m = rgb.max(-1)
    e = np.zeros((h, w), np.int32)
    nz = m > 1e-32
    e[nz] = np.frexp(m[nz])[1]
    scale = np.zeros((h, w), np.float32)
    scale[nz] = np.ldexp(256.0, -e[nz])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())


def read_image(path: str) -> np.ndarray:
    """Any image -> [h, w, 4] float32 rgba: .hdr (by its suffix) via the
    RGBE reader (linear radiance), everything else through `read_png` as
    [0, 1] sRGB-as-stored (the reference samples its PNG/JPG probes without
    conversion, lightProbeGBuffer.rt.hlsl:64-75)."""
    if path.lower().endswith(".hdr"):
        return read_hdr(path)
    rgb = read_png(path)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
