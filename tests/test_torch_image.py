"""The port's image I/O (utils/image.py), golden harness (utils/testing.py)
and video writer (utils/video.py) against the JAX package's, which read
and write PNGs and GIFs through PIL.

PNGs both ways bit for bit: the port's writer read by PIL, PIL's writer
read by the port, every checked-in golden, and 8-bit files of every colour
type with all five row filters (written here with a small encoder that
applies each filter); other bit depths and interlaced files refused.  HDR bit for bit, with a
hand-built RLE scanline.  The GIF decoded by PIL: frame count, size,
duration, loop, and each frame within the fixed palette's bound."""
import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fyp_bidirectionalpathtracer_tpu.utils import image as jimage
from fyp_bidirectionalpathtracer_tpu.utils import testing as jtesting
from fyp_bidirectionalpathtracer_tpu_torch.utils import image, testing, video

GOLDENS = sorted(glob.glob(os.path.join(jtesting.GOLDEN_DIR, "*.png")))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _seeded(h=23, w=37, c=3, seed=0) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-0.1, 1.1, (h, w, c)).astype(np.float32)


# ------------------------------------------------------------------ PNG
def test_to_u8_of_a_tensor_matches_jax():
    img = _seeded(c=4)
    np.testing.assert_array_equal(image.to_u8(torch.from_numpy(img)), jimage.to_u8(img))
    np.testing.assert_array_equal(image.to_u8(img), jimage.to_u8(img))


def test_png_both_ways_bit_equal(tmp_path):
    """The port's write_png read by PIL (JAX's read_png), PIL's written
    file read by the port: the same 8-bit image bit for bit."""
    img = _seeded()
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    image.write_png(ours, torch.from_numpy(img))
    jimage.write_png(theirs, img)
    want = jimage.to_u8(img).astype(np.float32) / 255.0
    for got in (jimage.read_png(ours), image.read_png(theirs), image.read_png(ours)):
        assert got.shape == (23, 37, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with Image.open(ours) as im:
        assert im.mode == "RGB" and im.size == (37, 23)


def test_grey_png_written_as_pil_writes_it(tmp_path):
    grey = _seeded(c=1)[..., 0]
    image.write_png(str(tmp_path / "g.png"), grey)
    jimage.write_png(str(tmp_path / "j.png"), grey)
    with Image.open(tmp_path / "g.png") as im:
        assert im.mode == "L"
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "g.png")),
                                  jimage.read_png(str(tmp_path / "j.png")))


@pytest.mark.parametrize("path", GOLDENS, ids=os.path.basename)
def test_golden_decodes_as_pil_does(path):
    np.testing.assert_array_equal(_bits(image.read_png(path)), _bits(jimage.read_png(path)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind, raw, prev, bpp):
    raw, prev = raw.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1, 4: _paeth(left, prev, upleft)}[kind]
    return ((raw - pred) & 0xFF).astype(np.uint8)


def _encode_png(path, samples, ctype, depth, palette=None, interlace=0):
    """A PNG of `samples` [h, w, channels] (uint8 values < 2**depth) with
    row filters 0, 1, 2, 3, 4, 0, ... in turn."""
    h, w, ch = samples.shape
    if depth < 8:
        bits = (samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, w * depth).astype(np.uint8), axis=1)
    else:
        rows = samples.reshape(h, w * ch).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    prev = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y in range(h):
        kind = y % 5
        raw += bytes([kind]) + _filter_row(kind, rows[y], prev, bpp).tobytes()
        prev = rows[y]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as fh:
        fh.write(data)


# (colour type, channels, bit depth)
KINDS = {"grey": (0, 1, 8), "grey-alpha": (4, 2, 8), "rgb": (2, 3, 8), "rgba": (6, 4, 8),
         "palette": (3, 1, 8)}


@pytest.mark.parametrize("kind", list(KINDS))
def test_every_colour_type_and_filter_decodes_as_pil_does(tmp_path, kind):
    ctype, ch, depth = KINDS[kind]
    rs = np.random.RandomState(len(kind))
    h, w = 11, 29  # 11 rows: every filter twice
    samples = rs.randint(0, 1 << depth, (h, w, ch)).astype(np.uint8)
    # smooth columns too, where the predictors matter
    ramp = np.arange(8)[None, :, None] * 37 + np.arange(h)[:, None, None]
    samples[:, :8] = ramp % (1 << depth)
    palette = rs.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = str(tmp_path / f"{kind}.png")
    _encode_png(path, samples, ctype, depth, palette)
    got, want = image.read_png(path), jimage.read_png(path)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("what", ["interlaced", "16-bit", "4-bit"])
def test_png_refusals(tmp_path, what):
    path = str(tmp_path / "bad.png")
    if what == "interlaced":
        _encode_png(path, np.zeros((4, 4, 3), np.uint8), 2, 8, interlace=1)
    elif what == "4-bit":  # a 4-bit palette file, which PIL reads
        _encode_png(path, np.zeros((4, 4, 1), np.uint8), 3, 4, np.zeros((16, 3)))
    else:  # 16-bit RGB: each sample two bytes
        _encode_png(path, np.zeros((4, 4, 6), np.uint8), 2, 8)
        data = bytearray(open(path, "rb").read())
        data[24] = 16  # the IHDR's bit depth
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match=what):
        image.read_png(path)


# ------------------------------------------------------------------ HDR
def test_hdr_bit_equal_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 8, size=(17, 33, 3)).astype(np.float32)
    img[0, :4] = 0.0  # the zero exponent
    ours, theirs = str(tmp_path / "p.hdr"), str(tmp_path / "j.hdr")
    image.write_hdr(ours, torch.from_numpy(img))
    jimage.write_hdr(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = image.read_hdr(ours)
    assert back.shape == (17, 33, 4)
    np.testing.assert_array_equal(_bits(back), _bits(jimage.read_hdr(ours)))


def test_hdr_rle_scanline_bit_equal(tmp_path):
    """One new-style RLE scanline (a run and a literal a component) and one
    flat scanline, built by hand."""
    w = 8
    rle = bytes([2, 2, 0, w])
    for run, lit in [(200, [1, 2, 3]), (17, [0, 255, 9]), (5, [5, 6, 7]),
                     (130, [129, 0, 140])]:
        rle += bytes([128 + 5, run, 3] + lit)
    flat = bytes(np.random.RandomState(3).randint(0, 256, w * 4).astype(np.uint8))
    path = str(tmp_path / "rle.hdr")
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y 2 +X {w}\n".encode()
                 + rle + flat)
    got, want = image.read_hdr(path), jimage.read_hdr(path)
    assert got.shape == (2, w, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0, 0, 0] == np.ldexp((200 + 0.5) / 256.0, 130 - 128)


def test_read_image_formats(tmp_path):
    img = _seeded(8, 16, 3, seed=4)
    jimage.write_png(str(tmp_path / "a.png"), img)
    jimage.write_hdr(str(tmp_path / "a.HDR"), img * 4.0)
    for name in ("a.png", "a.HDR"):
        got, want = image.read_image(str(tmp_path / name)), jimage.read_image(str(tmp_path / name))
        assert got.shape == (8, 16, 4)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(NotImplementedError, match=r"\.hdr and \.png"):
        image.read_image(str(tmp_path / "a.jpg"))


# ------------------------------------------------------- metrics, goldens
def test_mse_psnr_and_golden_compare_match_jax(tmp_path, monkeypatch):
    a, b = _seeded(16, 16, 4, seed=5), _seeded(16, 16, 4, seed=6)
    assert image.mse(torch.from_numpy(a), b) == jimage.mse(a, b)
    assert image.psnr(a, b) == jimage.psnr(a, b)
    assert image.psnr(a, a) == jimage.psnr(a, a) == float("inf")
    assert image.psnr(a, b, peak=2.0) == jimage.psnr(a, b, peak=2.0)

    monkeypatch.setattr(testing, "GOLDEN_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jtesting, "GOLDEN_DIR", str(tmp_path / "jax"))
    monkeypatch.delenv("UPDATE_GOLDEN", raising=False)
    base = np.clip(a, 0, 1)
    near = np.clip(base + 0.001, 0, 1)
    # a missing golden is written and passes
    assert testing.golden_compare("g", base) == jtesting.golden_compare("g", base) == np.inf
    for name in ("port", "jax"):
        assert os.path.exists(tmp_path / name / "g.png")
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "port" / "g.png")),
                                  jimage.read_png(str(tmp_path / "jax" / "g.png")))
    # the same PSNR against either package's golden, the same refusal
    got = testing.golden_compare("g", torch.from_numpy(near), min_psnr=30.0)
    assert got == jtesting.golden_compare("g", near, min_psnr=30.0)
    with pytest.raises(AssertionError, match="golden mismatch"):
        testing.golden_compare("g", b)
    with pytest.raises(AssertionError, match="golden mismatch"):
        jtesting.golden_compare("g", b)
    # UPDATE_GOLDEN rewrites
    monkeypatch.setenv("UPDATE_GOLDEN", "1")
    assert testing.golden_compare("g", b) == np.inf
    monkeypatch.delenv("UPDATE_GOLDEN")
    assert testing.golden_compare("g", b) == np.inf


# ------------------------------------------------------------------ video
def test_video_gif_decoded_by_pil(tmp_path):
    """A 3-frame GIF: PIL reads 3 frames of the right size, the duration
    and loop JAX's PIL writer sets (int(1000 / fps) ms, loop 0), each frame
    within the fixed palette's bound of its 8-bit input."""
    rs = np.random.RandomState(7)
    frames = [rs.uniform(0, 1, (16, 24, 3)).astype(np.float32),
              np.full((16, 24, 3), 0.5, np.float32),
              torch.linspace(0, 1, 16 * 24 * 4).reshape(16, 24, 4)]
    rec = video.VideoRecorder(fps=10)
    for f in frames:
        rec.add_frame(f)
    out = rec.save(str(tmp_path / "clip.gif"))
    assert out.endswith("clip.gif") and os.path.getsize(out) > 0
    with Image.open(out) as im:
        assert im.n_frames == 3 and im.size == (24, 16)
        assert im.info["duration"] == 100 and im.info["loop"] == 0
        for k, f in enumerate(frames):
            im.seek(k)
            got = np.asarray(im.convert("RGB")).astype(np.int32)
            err = np.abs(got - image.to_u8(f).astype(np.int32)).max(axis=(0, 1))
            assert (err <= np.asarray(video.GIF_MAX_ERROR)).all(), (k, err)
    assert video.GIF_MAX_ERROR == (26, 22, 26)
    with pytest.raises(ValueError, match="unsupported container"):
        rec.save(str(tmp_path / "clip.avi"))
    with pytest.raises(ValueError, match="no frames"):
        video.VideoRecorder().save(str(tmp_path / "empty.gif"))


def test_video_mp4_falls_back_to_gif_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(video.shutil, "which", lambda name: None)
    rec = video.VideoRecorder(fps=25)
    rec.add_frame(np.zeros((4, 4, 3), np.float32))
    out = rec.save(str(tmp_path / "clip.mp4"))
    assert out == str(tmp_path / "clip.gif")
    with Image.open(out) as im:
        assert im.info["duration"] == 40
