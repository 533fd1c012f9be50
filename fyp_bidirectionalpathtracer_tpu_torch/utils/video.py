"""Frame-sequence capture (Falcor Utils/Video analogue).

Port of `fyp_bidirectionalpathtracer_tpu/utils/video.py`.  The reference
H.264-encodes captures via Media Foundation (VideoEncoder).  Here frames
append to an in-memory list and flush to an MP4 through the `ffmpeg`
binary, or to an animated GIF written by this module's own GIF89a encoder
(PIL, which JAX's GIF route uses, is not needed).  Without `ffmpeg` an
`.mp4` falls back to a `.gif` beside it, as in JAX.

The GIF's palette is fixed: 6 x 7 x 6 levels of red, green and blue (252
colours), each pixel's channels rounded to the nearest level, so a decoded
channel is within `GIF_MAX_ERROR` (26, 22, 26 of 255) of the frame's
8-bit value.  PIL's adaptive palette follows each frame's colours instead.
"""
from __future__ import annotations

import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np

from .image import to_u8, write_png

GIF_LEVELS = (6, 7, 6)
# half a level's step, plus the half a unit by which a level rounds to 8 bits
GIF_MAX_ERROR = tuple(int(np.ceil(255.0 / (2 * (n - 1)) + 0.5)) for n in GIF_LEVELS)


def _gif_palette() -> np.ndarray:
    """[256, 3] uint8: the 252 level colours in r-major order, then black."""
    r, g, b = (np.rint(np.arange(n) * 255.0 / (n - 1)) for n in GIF_LEVELS)
    rgb = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    table = np.zeros((256, 3), np.uint8)
    table[:len(rgb)] = rgb
    return table


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> palette indices [H * W] uint8 (nearest level)."""
    f = frame.reshape(-1, 3).astype(np.int32)
    lv = [(f[:, c] * (n - 1) * 2 + 255) // 510 for c, n in enumerate(GIF_LEVELS)]
    return ((lv[0] * GIF_LEVELS[1] + lv[1]) * GIF_LEVELS[2] + lv[2]).astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """GIF's variable-width LZW of 8-bit palette indices, packed LSB first:
    a clear code first, 9- to 12-bit codes, a clear code and a fresh table
    when the table is full, the end code last."""
    clear, end = 256, 257
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width = 9
    table: dict = {}
    next_code = end + 1
    emit(clear, width)
    data = indices.tobytes()
    prefix = data[0] if data else None
    for k in data[1:]:
        key = (prefix, k)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear, width)
            table.clear()
            next_code, width = end + 1, 9
        prefix = k
    if prefix is not None:
        emit(prefix, width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: list, duration_ms: int) -> None:
    """Animated GIF89a of uint8 [H, W, 3] frames with the fixed palette:
    each frame shown `duration_ms` (in 10 ms units, as PIL writes it),
    looping forever (a Netscape loop count of 0, JAX's `loop=0`)."""
    h, w = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame of {f.shape[:2]} in a {(h, w)} GIF")
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", duration_ms // 10) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(b"\x08" + _sub_blocks(_lzw(_gif_indices(f))))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


class VideoRecorder:
    def __init__(self, fps: int = 30):
        self.fps = fps
        self.frames: list[np.ndarray] = []

    def add_frame(self, img) -> None:
        """Append a frame: float [H, W, 3 or 4] in [0, 1], numpy or a tensor
        on any device."""
        self.frames.append(to_u8(img))

    def save(self, path: str) -> str:
        """Write .gif (the fixed-palette encoder) or .mp4 (ffmpeg in PATH,
        else a .gif beside it); returns the path written."""
        if not self.frames:
            raise ValueError("no frames recorded")
        if path.endswith(".gif"):
            write_gif(path, self.frames, int(1000 / self.fps))
            return path
        if path.endswith(".mp4"):
            if shutil.which("ffmpeg") is None:
                gif = os.path.splitext(path)[0] + ".gif"
                return self.save(gif)  # graceful fallback
            with tempfile.TemporaryDirectory() as td:
                for i, f in enumerate(self.frames):
                    write_png(os.path.join(td, f"f_{i:06d}.png"), f / 255.0)
                subprocess.run(
                    [
                        "ffmpeg", "-y", "-framerate", str(self.fps),
                        "-i", os.path.join(td, "f_%06d.png"),
                        "-pix_fmt", "yuv420p", path,
                    ],
                    check=True, capture_output=True,
                )
            return path
        raise ValueError(f"unsupported container {path!r} (use .gif or .mp4)")
