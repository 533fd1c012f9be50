"""Image I/O and quality metrics (PNG, Radiance HDR, PSNR): the test
harness's analogue of Falcor's screenshot capture + ImageMagick compare
(RunTestsSet.py:262-289).

Port of `fyp_bidirectionalpathtracer_tpu/utils/image.py`.  Every function
works on numpy, as JAX's do; a torch tensor is taken through
`.detach().cpu().numpy()` first, so 8-bit output is bit-equal to JAX's.
PNGs are written and read with `zlib` and `struct` alone (no PIL):
`write_png` writes 8-bit RGB (or grey for a 2-D image) with filter 0;
`read_png` returns what `Image.open(path).convert("RGB")` does for grey,
grey + alpha, RGB, RGBA and palette PNGs of 8 bits a sample, under all
five row filters, and `read_png_rgba` what `convert("RGBA")` does (the
tRNS chunk applied to grey, RGB and palette images); both raise
ValueError on other bit depths and on interlaced files, the reason that
`png_refusal` gives from the header alone.
`read_image` reads `.hdr` and `.png` only.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel by PNG colour type: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters: [h, stride] uint8.  None, Sub (a cumulative sum
    mod 256 per byte of the pixel) and Up (one add) are vectorised."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
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


def _refusal(path: str, hdr) -> str | None:
    """Why a PNG with this IHDR is not read although PIL reads it
    (interlaced, or other than 8 bits a sample), or None."""
    _, _, depth, ctype, _, _, interlace = hdr
    if interlace:
        return f"{path}: interlaced PNGs are not read"
    if ctype in _CHANNELS and depth != 8:
        return f"{path}: {depth}-bit PNGs are not read (8 bits a sample only)"
    return None


def png_refusal(path: str) -> str | None:
    """The reason `read_png` / `read_png_rgba` refuse a well-formed PNG
    that PIL reads, from its IHDR chunk alone; None where they read it or
    where the file is not a well-formed PNG (which they report as such)."""
    with open(path, "rb") as fh:
        head = fh.read(29)
    if len(head) < 29 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    return _refusal(path, struct.unpack(">IIBBBBB", head[16:29]))


def _decode_png(path: str):
    """(samples [H, W, channels] uint8, colour type, palette [n, 3] or None,
    the tRNS chunk's bytes or None) of an 8-bit, non-interlaced PNG."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, _, ctype, _, _, _ = hdr
    reason = _refusal(path, hdr)
    if reason is not None:
        raise ValueError(reason)
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    return rows.reshape(h, w, channels), ctype, palette, trns


def _rgb(pix: np.ndarray, ctype: int, palette) -> np.ndarray:
    """[H, W, 3] uint8: grey replicated, palette looked up (entries past
    the PLTE chunk black), alpha dropped."""
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pix[..., 0]]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return pix[..., :3]


def read_png(path: str) -> np.ndarray:
    """PNG -> float32 [H, W, 3] in [0, 1]: PIL's `convert("RGB")` of it
    (grey replicated, alpha dropped, palette looked up)."""
    pix, ctype, palette, _ = _decode_png(path)
    return np.ascontiguousarray(_rgb(pix, ctype, palette)).astype(np.float32) / 255.0


def read_png_rgba(path: str) -> np.ndarray:
    """PNG -> float32 [H, W, 4] in [0, 1]: PIL's `convert("RGBA")` of it.
    Alpha is the file's for grey + alpha and RGBA; for a palette image the
    tRNS chunk's entry of each index (255 past its end); for grey and RGB
    0 where the sample equals the tRNS chunk's 16-bit value(s), else 255."""
    pix, ctype, palette, trns = _decode_png(path)
    rgb = _rgb(pix, ctype, palette)
    if ctype in (4, 6):
        alpha = pix[..., -1]
    elif trns is None:
        alpha = np.full(pix.shape[:2], 255, np.uint8)
    elif ctype == 3:
        table = np.full(256, 255, np.uint8)
        entries = np.frombuffer(trns, np.uint8)[:256]
        table[:len(entries)] = entries
        alpha = table[pix[..., 0]]
    else:
        key = np.asarray(struct.unpack(f">{len(trns) // 2}H", trns[:len(trns) // 2 * 2]),
                         np.int64)
        if key.size != pix.shape[-1]:
            raise ValueError(f"{path}: a tRNS chunk of {len(trns)} bytes for colour type {ctype}")
        alpha = np.where((pix.astype(np.int64) == key).all(-1), 0, 255).astype(np.uint8)
    rgba = np.concatenate([rgb, alpha[..., None]], -1)
    return np.ascontiguousarray(rgba).astype(np.float32) / 255.0


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
    """.hdr or .png -> [h, w, 4] float32 rgba: .hdr via the RGBE reader
    (linear radiance), .png as [0, 1] sRGB-as-stored (the reference samples
    its PNG probes without conversion, lightProbeGBuffer.rt.hlsl:64-75).
    JAX also reads JPEG and the rest through PIL, which the port does not
    need: any other suffix raises."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        return read_hdr(path)
    if not lower.endswith(".png"):
        raise NotImplementedError(
            f"{path}: the port reads .hdr and .png images only (JAX's other formats "
            f"go through PIL)")
    rgb = read_png(path)
    return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)
