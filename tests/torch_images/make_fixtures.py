"""Writes the image fixtures of the port's decoders into this folder: one
file of each kind the port decodes, made by PIL (or, where PIL writes no
such file, by the small encoders here) from numpy seeds, and beside each
`<name>.pil.png`, PIL's `Image.open(<name>).convert("RGBA")` as an 8-bit
RGBA PNG, which the port's PNG decoder reads bit for bit.

    python tests/torch_images/make_fixtures.py

`tests/test_torch_image.py` runs `pil_decode` on every fixture and holds
the result to the checked-in `.pil.png`; `chip_smoke.py` (phase 12), on a
machine without PIL, holds the port's decode of every fixture to it.
"""
from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
DECODE_SUFFIX = ".pil.png"


def smooth(h: int, w: int, seed: int, noise: float = 12.0) -> np.ndarray:
    """A seeded [h, w, 3] uint8 picture: sums of sines, some noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    freq = rs.uniform(0.05, 0.4, (3, 2))
    phase = rs.uniform(0, 6.3, (3, 2))
    img = np.stack([100 * np.sin(xx * f[0] + p[0]) * np.cos(yy * f[1] + p[1]) + 128
                    for f, p in zip(freq, phase)], -1)
    return np.clip(img + rs.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def latlong(h: int = 512, w: int = 1024, seed: int = 12) -> np.ndarray:
    """The 1024x512 env map: a sky-to-ground gradient with a sun and mild
    noise, as phase 8d's lat-long probe."""
    rs = np.random.RandomState(seed)
    v = (np.arange(h)[:, None] + 0.5) / h
    u = (np.arange(w)[None, :] + 0.5) / w
    sky = np.stack([0.4 + 0.5 * (1 - v), 0.55 + 0.35 * (1 - v), 0.9 + 0.1 * (1 - v)], -1)
    ground = np.stack([0.35 + 0.2 * v, 0.3 + 0.15 * v, 0.25 + 0.1 * v], -1)
    img = np.where(v[..., None] < 0.5, sky, ground) * np.ones((1, w, 1))
    sun = np.exp(-((u - 0.3) ** 2 + (v - 0.25) ** 2) / 0.002)[..., None]
    img = img + sun * np.array([1.0, 0.9, 0.6]) + rs.normal(0, 0.01, img.shape)
    return np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def encode_png(samples: np.ndarray, ctype: int, depth: int, palette=None,
               interlace: int = 0) -> bytes:
    """A PNG of `samples` [h, w, channels] (values < 2**depth) with filter
    0, Adam7-interlaced if asked: the kinds PIL does not write."""
    h, w, ch = samples.shape

    def rows(sub):
        sh, sw = sub.shape[:2]
        if depth < 8:
            bits = (sub[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            packed = np.packbits(bits.reshape(sh, sw * depth).astype(np.uint8), axis=1)
        elif depth == 16:
            packed = sub.astype(">u2").view(np.uint8).reshape(sh, sw * ch * 2)
        else:
            packed = sub.reshape(sh, sw * ch).astype(np.uint8)
        return b"".join(b"\0" + r.tobytes() for r in packed)

    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                  (1, 0, 2, 2), (0, 1, 1, 2))
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = rows(samples)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b"")


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _tga16(rgba5551: np.ndarray) -> bytes:
    """A bottom-up, raw 16-bit TGA (A1R5G5B5, little-endian words)."""
    h, w = rgba5551.shape
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, 16, 0)
    return head + rgba5551[::-1].astype("<u2").tobytes()


def _bmp(pixels: bytes, w: int, h: int, bits: int, header_size: int = 40,
         compression: int = 0, masks=(), palette: bytes = b"") -> bytes:
    """A BMP with the given info header size, rows as given (bottom-up
    unless h < 0), masks written into a V4/V5 header or after a 40-byte one."""
    info = struct.pack("<IiiHHIIiiII", header_size, w, h, 1, bits, compression,
                       len(pixels), 2835, 2835, len(palette) // 4, 0)
    if header_size > 40:
        info += struct.pack(f"<{len(masks)}I", *masks)
        info += bytes(header_size - len(info))
    else:
        info += struct.pack(f"<{len(masks)}I", *masks)
    offset = 14 + len(info) + len(palette)
    head = b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
    return head + info + palette + pixels


def fixtures() -> dict[str, bytes]:
    """File name -> bytes of every fixture."""
    out = {}
    pic = smooth(48, 64, 1)
    out["baseline_420.jpg"] = _pil(Image.fromarray(pic), "JPEG", quality=75)
    out["progressive_420.jpg"] = _pil(Image.fromarray(smooth(48, 64, 2)), "JPEG", quality=85,
                                      progressive=True, subsampling=2)
    out["baseline_444.jpg"] = _pil(Image.fromarray(smooth(37, 23, 3)), "JPEG", quality=95,
                                   subsampling=0)
    out["restart_422.jpg"] = _pil(Image.fromarray(smooth(29, 45, 4)), "JPEG", quality=60,
                                  subsampling=1, restart_marker_blocks=3)
    out["grey_progressive.jpg"] = _pil(Image.fromarray(smooth(40, 33, 5)[..., 1]), "JPEG",
                                       quality=80, progressive=True, optimize=True)
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate; Image.open applies none
    out["exif_comment.jpg"] = _pil(Image.fromarray(smooth(24, 40, 6)), "JPEG", quality=70,
                                   exif=exif, comment=b"a COM segment")
    out["env_1024x512.jpg"] = _pil(Image.fromarray(latlong()), "JPEG", quality=90)

    rgba = np.concatenate([smooth(48, 64, 7), np.full((48, 64, 1), 255, np.uint8)], -1)
    rgba[10:30, 20:44, 3] = 0  # the cutout
    out["cutout_rle32.tga"] = _pil(Image.fromarray(rgba), "TGA", rle=True)
    out["rgb24_top.tga"] = _pil(Image.fromarray(smooth(21, 30, 8)), "TGA", orientation=1)
    out["grey_rle.tga"] = _pil(Image.fromarray(smooth(20, 26, 9)[..., 0] // 32 * 32), "TGA",
                               rle=True)
    pal_img = Image.fromarray(smooth(18, 22, 10)).quantize(12)
    out["palette.tga"] = _pil(pal_img, "TGA")
    word = np.random.RandomState(11).randint(0, 1 << 16, (13, 17))
    out["argb1555.tga"] = _tga16(word)

    out["rgb24.bmp"] = _pil(Image.fromarray(smooth(19, 27, 12)), "BMP")
    out["palette8.bmp"] = _pil(Image.fromarray(smooth(20, 21, 13)).quantize(40), "BMP")
    out["mono1.bmp"] = _pil(Image.fromarray(smooth(17, 35, 14)[..., 0] > 128), "BMP")
    out["grey8.bmp"] = _pil(Image.fromarray(smooth(16, 18, 15)[..., 2]), "BMP")
    bgra = smooth(14, 19, 16)
    alpha = np.random.RandomState(16).randint(0, 256, (14, 19, 1)).astype(np.uint8)
    px = np.concatenate([bgra[..., ::-1], alpha], -1)
    out["bgra32_v5_topdown.bmp"] = _bmp(px.tobytes(), 19, -14, 32, 124, 3,
                                        (0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    w565 = np.random.RandomState(17).randint(0, 1 << 16, (9, 12)).astype("<u2")
    out["rgb565.bmp"] = _bmp(w565.tobytes(), 12, 9, 16, 40, 3, (0xF800, 0x7E0, 0x1F))
    nib = np.random.RandomState(18).randint(0, 16, (11, 16)).astype(np.uint8)
    pal16 = np.random.RandomState(19).randint(0, 256, (16, 4)).astype(np.uint8).tobytes()
    out["palette4.bmp"] = _bmp((nib[:, 0::2] << 4 | nib[:, 1::2]).tobytes(), 16, 11, 4,
                               palette=pal16)

    rs = np.random.RandomState(20)
    out["grey4.png"] = encode_png(rs.randint(0, 16, (15, 21, 1)), 0, 4)
    out["palette2_interlaced.png"] = encode_png(rs.randint(0, 4, (19, 13, 1)), 3, 2,
                                                rs.randint(0, 256, (4, 3)), interlace=1)
    out["grey16.png"] = encode_png(rs.randint(0, 600, (12, 10, 1)), 0, 16)
    out["rgba16_interlaced.png"] = encode_png(rs.randint(0, 1 << 16, (11, 9, 4)), 6, 16,
                                              interlace=1)
    return out


def pil_decode(path: str) -> np.ndarray:
    """PIL's convert("RGBA") of the file, [H, W, 4] uint8."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def main() -> None:
    for name, data in fixtures().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as fh:
            fh.write(data)
        Image.fromarray(pil_decode(path), "RGBA").save(path + DECODE_SUFFIX, optimize=True)
    total = sum(os.path.getsize(os.path.join(HERE, f)) for f in os.listdir(HERE))
    print(f"{len(fixtures())} fixtures, {total} bytes in {HERE}")


if __name__ == "__main__":
    main()
