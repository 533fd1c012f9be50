"""The port's image I/O (utils/image.py, utils/jpeg.py, utils/raster.py),
golden harness (utils/testing.py) and video writer (utils/video.py) against
the JAX package's, which read and write images through PIL.

PNGs both ways bit for bit: the port's writer read by PIL, PIL's writer
read by the port, every checked-in golden, and files of every colour type
and bit depth with all five row filters, Adam7-interlaced or not (written
here with a small encoder that applies each filter).  JPEG, TGA and BMP
files, made by PIL from numpy seeds or built here byte by byte, decoded bit
for bit as JAX's `read_image` / `read_png` (PIL's `convert("RGB")`) and as
PIL's `convert("RGBA")`: JPEG at qualities 10-95, 4:4:4 / 4:2:2 / 4:2:0,
progressive, optimized, with restarts, grey, at sizes down to 1x1, under
each colour-space marker.  What the port refuses raises with its reason;
corrupt and truncated files raise, as PIL raises.  The checked-in
fixtures of tests/torch_images/ against PIL's decodes, made anew.  HDR bit
for bit, with a hand-built RLE scanline.  The GIF decoded by PIL: frame
count, size, duration, loop, and each frame within the fixed palette's
bound."""
import glob
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, features

from fyp_bidirectionalpathtracer_tpu.models import obj as jobj
from fyp_bidirectionalpathtracer_tpu.utils import image as jimage
from fyp_bidirectionalpathtracer_tpu.utils import testing as jtesting
from fyp_bidirectionalpathtracer_tpu_torch.models import obj
from fyp_bidirectionalpathtracer_tpu_torch.utils import image, jpeg, raster, testing, video
from torch_threads import one_intra_op_thread  # noqa: F401

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_images")
sys.path.insert(0, FIXTURE_DIR)
import make_fixtures  # noqa: E402

GOLDENS = sorted(glob.glob(os.path.join(jtesting.GOLDEN_DIR, "*.png")))
FIXTURES = sorted(f for f in os.listdir(FIXTURE_DIR)
                  if not f.endswith((".py", make_fixtures.DECODE_SUFFIX)))


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


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _encode_png(path, samples, ctype, depth, palette=None, interlace=0):
    """A PNG of `samples` [h, w, channels] (values < 2**depth) with row
    filters 0, 1, 2, 3, 4, 0, ... in turn; Adam7-interlaced if asked, each
    pass filtered on its own."""
    ch = samples.shape[2]
    bpp = max(1, ch * depth // 8)

    def filtered(sub):
        sh, sw = sub.shape[:2]
        if depth < 8:
            bits = (sub[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(sh, sw * depth).astype(np.uint8), axis=1)
        elif depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(sh, sw * ch * 2)
        else:
            rows = sub.reshape(sh, sw * ch).astype(np.uint8)
        prev = np.zeros(rows.shape[1], np.uint8)
        raw = b""
        for y in range(sh):
            kind = y % 5
            raw += bytes([kind]) + _filter_row(kind, rows[y], prev, bpp).tobytes()
            prev = rows[y]
        return raw

    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(filtered(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                   if samples[y0::dy, x0::dx].size)
    h, w = samples.shape[:2]

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


def _pil_rgba(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _assert_decodes_as_pil(path):
    """read_png and read_image bit for bit against JAX's (PIL's
    convert("RGB"), alpha 1), read_rgba against PIL's convert("RGBA")."""
    got = image.read_png(path)
    np.testing.assert_array_equal(_bits(got), _bits(jimage.read_png(path)))
    np.testing.assert_array_equal(_bits(image.read_image(path)), _bits(jimage.read_image(path)))
    want = _pil_rgba(path).astype(np.float32) / 255.0
    np.testing.assert_array_equal(_bits(image.read_rgba(path)), _bits(want))
    return got


@pytest.mark.parametrize("what", ["interlaced", "16-bit", "4-bit"])
def test_png_refusals(tmp_path, what):
    """The three PNG kinds the port refused before it read every PNG PIL
    reads: an interlaced RGB file, 16-bit RGB (PIL keeps each sample's high
    byte) and a 4-bit palette; each decodes as PIL does."""
    path = str(tmp_path / "was_refused.png")
    rs = np.random.RandomState(len(what))
    if what == "interlaced":
        _encode_png(path, rs.randint(0, 256, (11, 13, 3)), 2, 8, interlace=1)
    elif what == "4-bit":
        _encode_png(path, rs.randint(0, 16, (9, 7, 1)), 3, 4, rs.randint(0, 256, (16, 3)))
    else:
        _encode_png(path, rs.randint(0, 1 << 16, (6, 5, 3)), 2, 16)
    assert image.refusal(path) is None
    assert _assert_decodes_as_pil(path).shape[:2] == np.asarray(Image.open(path)).shape[:2]


# (colour type, bit depth, tRNS payload or None)
PNG_DEPTHS = {
    "grey1": (0, 1, None), "grey2": (0, 2, None), "grey4": (0, 4, None),
    "grey16": (0, 16, None), "palette1": (3, 1, None), "palette2": (3, 2, None),
    "palette4": (3, 4, b"\x00\x80\xff\x10"), "rgb16": (2, 16, None),
    "grey-alpha16": (4, 16, None), "rgba16": (6, 16, None),
    # tRNS keys as PIL applies them: to the samples as stored (a 2-bit key
    # of 1 never meets the samples 0, 85, 170, 255; 85 does), a 16-bit
    # grey key to the samples clipped at 255, a 16-bit RGB key to the high bytes
    "grey1-trns": (0, 1, struct.pack(">H", 1)), "grey2-trns": (0, 2, struct.pack(">H", 85)),
    "grey2-trns-unscaled": (0, 2, struct.pack(">H", 1)),
    "grey16-trns": (0, 16, struct.pack(">H", 200)),
    "rgb16-trns": (2, 16, struct.pack(">HHH", 7, 9, 11)),
}


@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("kind", list(PNG_DEPTHS))
def test_png_every_depth_decodes_as_pil(tmp_path, kind, interlace):
    """Grey, palette, RGB, grey + alpha and RGBA at every bit depth PIL
    reads, with and without Adam7 and tRNS: 16-bit grey opens as "I;16" and
    converts clipped at 255; other 16-bit samples keep their high byte."""
    ctype, depth, trns = PNG_DEPTHS[kind]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rs = np.random.RandomState(depth * 7 + ctype)
    h, w = 13, 11
    top = 600 if kind.startswith("grey16") else 1 << depth
    samples = rs.randint(0, top, (h, w, ch))
    if kind == "grey16-trns":
        samples[::2, ::3] = 200
    if kind == "rgb16-trns":
        samples[1::3, ::2] = (7 << 8) | 3, (9 << 8) | 200, (11 << 8)
    if kind == "grey2-trns":
        samples[::2] = 1
    palette = rs.randint(0, 256, (1 << depth, 3)) if ctype == 3 else None
    path = str(tmp_path / f"{kind}.png")
    _encode_png(path, samples, ctype, depth, palette, interlace)
    if trns is not None:
        data = open(path, "rb").read()
        at = data.index(b"IDAT") - 4
        chunk = (struct.pack(">I", len(trns)) + b"tRNS" + trns
                 + struct.pack(">I", zlib.crc32(b"tRNS" + trns) & 0xFFFFFFFF))
        open(path, "wb").write(data[:at] + chunk + data[at:])
    _assert_decodes_as_pil(path)
    alpha = image.read_rgba(path)[..., 3]
    if kind in ("grey2-trns", "grey16-trns", "rgb16-trns", "grey1-trns", "palette4"):
        assert (alpha == 0).any(), kind
    if kind == "grey2-trns-unscaled":
        assert (alpha == 1).all()


# ------------------------------------------------------------------ JPEG
def _smooth(h, w, seed, noise=20.0) -> np.ndarray:
    return make_fixtures.smooth(h, w, seed, noise)


def _pil_jpeg(path, arr, **kw):
    Image.fromarray(arr).save(path, "JPEG", **kw)
    return path


JPEG_OPTIONS = {
    "q10": dict(quality=10), "q50": dict(quality=50), "q95": dict(quality=95),
    "444": dict(subsampling=0), "422": dict(subsampling=1), "420": dict(subsampling=2),
    "progressive": dict(progressive=True), "optimize": dict(optimize=True),
    "restarts": dict(restart_marker_blocks=2), "grey": dict(quality=70),
    "progressive-444-restarts": dict(progressive=True, subsampling=0, restart_marker_blocks=5),
    "progressive-422-q95": dict(progressive=True, subsampling=1, quality=95),
    "grey-progressive-restarts": dict(progressive=True, restart_marker_rows=1),
}


@pytest.mark.parametrize("option", list(JPEG_OPTIONS))
@pytest.mark.parametrize("size", [(23, 37), (64, 48)], ids=["23x37", "64x48"])
def test_jpeg_decodes_as_pil(tmp_path, size, option):
    """JPEGs written by PIL from a seeded picture: read_image / read_png
    against JAX's, read_rgba against PIL's convert("RGBA"), bit for bit."""
    w, h = size
    arr = _smooth(h, w, w + h)
    if option.startswith("grey"):
        arr = arr[..., 0]
    path = _pil_jpeg(str(tmp_path / "a.jpg"), arr, **JPEG_OPTIONS[option])
    got = _assert_decodes_as_pil(path)
    assert got.shape == (h, w, 3)
    assert jpeg.jpeg_refusal(path) is None and image.refusal(path) is None


@pytest.mark.parametrize("size", [(1, 1), (2, 5), (3, 3), (5, 2), (4, 9), (17, 3), (18, 18)])
@pytest.mark.parametrize("option", ["422", "420", "progressive-420"])
def test_jpeg_small_sizes_decode_as_pil(tmp_path, size, option):
    """Widths at and around libjpeg's switch from box to fancy upsampling
    (a downsampled width of 2), odd heights at the h2v2 edge rows."""
    w, h = size
    kw = {"422": dict(subsampling=1), "420": dict(subsampling=2),
          "progressive-420": dict(subsampling=2, progressive=True)}[option]
    path = _pil_jpeg(str(tmp_path / "s.jpg"), _smooth(h, w, 3 * w + h, 40.0), **kw)
    assert _assert_decodes_as_pil(path).shape == (h, w, 3)


def _rewrite_jpeg(data: bytes, drop=(), insert=b"", ids=None) -> bytes:
    """A baseline JPEG with the marker segments `drop` left out, `insert`
    after SOI and the component ids replaced in SOF0 and SOS."""
    out, pos = bytearray(b"\xff\xd8" + insert), 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = bytearray(data[pos:pos + 2 + length])
        pos += 2 + length
        if marker in drop:
            continue
        if ids and marker == 0xC0:
            for i, cid in enumerate(ids):
                seg[10 + 3 * i] = cid
        if ids and marker == 0xDA:
            for i, cid in enumerate(ids):
                seg[5 + 2 * i] = cid
        out += seg
        if marker == 0xDA:
            return bytes(out) + data[pos:]


def _adobe(transform: int) -> bytes:
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                                        transform)


# how libjpeg guesses the colour space of three components, and which the
# variant decodes as: a JFIF marker (YCbCr) before the Adobe marker's
# transform, then the component ids ('R', 'G', 'B': RGB)
JPEG_MARKERS = {
    "jfif": (dict(), "ycc"),
    "no-markers-ids-123": (dict(drop=(0xE0,)), "ycc"),
    "adobe-0": (dict(drop=(0xE0,), insert=_adobe(0)), "rgb"),
    "adobe-1": (dict(drop=(0xE0,), insert=_adobe(1)), "ycc"),
    "adobe-2": (dict(drop=(0xE0,), insert=_adobe(2)), "ycc"),
    "ids-rgb": (dict(drop=(0xE0,), ids=(82, 71, 66)), "rgb"),
    "jfif-and-adobe-0": (dict(insert=_adobe(0)), "ycc"),
    "adobe-1-ids-rgb": (dict(drop=(0xE0,), insert=_adobe(1), ids=(82, 71, 66)), "ycc"),
}


@pytest.mark.parametrize("variant", list(JPEG_MARKERS))
def test_jpeg_colour_space_markers(tmp_path, variant):
    data = open(_pil_jpeg(str(tmp_path / "a.jpg"), _smooth(24, 40, 9), quality=80,
                          subsampling=0), "rb").read()
    kw, space = JPEG_MARKERS[variant]
    path = str(tmp_path / "b.jpg")
    open(path, "wb").write(_rewrite_jpeg(data, **kw))
    got = _assert_decodes_as_pil(path)
    # the other guess would differ: the colour conversion did (not) run
    plain = jpeg.decode_jpeg(open(path, "rb").read())
    ycc = jpeg.decode_jpeg(open(str(tmp_path / "a.jpg"), "rb").read())
    assert np.array_equal(plain, ycc) == (space == "ycc")
    assert got.shape == (24, 40, 3)


def test_jpeg_exif_orientation_and_segments_skipped(tmp_path):
    """EXIF (orientation 6), COM and extra APPn segments are skipped: no
    rotation, as Image.open applies none."""
    exif = Image.Exif()
    exif[0x0112] = 6
    path = _pil_jpeg(str(tmp_path / "e.jpg"), _smooth(20, 36, 4), exif=exif, comment=b"note",
                     icc_profile=b"\0" * 300)
    assert _assert_decodes_as_pil(path).shape == (20, 36, 3)


# ------------------------------------------------------------- TGA, BMP
# (mode, RLE): Pillow cannot read the RLE 1-bit TGA it writes (a corrupt case below)
TGA_BY_PIL = [(mode, rle) for mode in ("1", "L", "LA", "P", "RGB", "RGBA") for rle in (False, True)
              if (mode, rle) != ("1", True)]


@pytest.mark.parametrize("orientation", [-1, 1], ids=["bottom-up", "top-down"])
@pytest.mark.parametrize("mode,rle", TGA_BY_PIL,
                         ids=[f"{m}-{'rle' if r else 'raw'}" for m, r in TGA_BY_PIL])
def test_tga_written_by_pil_decodes_as_pil(tmp_path, mode, rle, orientation):
    arr = _smooth(19, 26, 5, 60.0)
    rs = np.random.RandomState(6)
    img = {"1": lambda: Image.fromarray(arr[..., 0] > 128),
           "L": lambda: Image.fromarray(arr[..., 0] // 16 * 16),
           "LA": lambda: Image.fromarray(np.stack([arr[..., 0], arr[..., 1] // 64 * 64], -1),
                                         "LA"),
           "P": lambda: Image.fromarray(arr).quantize(20),
           "RGB": lambda: Image.fromarray(arr // 8 * 8),
           "RGBA": lambda: Image.fromarray(np.concatenate(
               [arr, (rs.uniform(size=(19, 26, 1)) < 0.5).astype(np.uint8) * 255], -1))}[mode]()
    path = str(tmp_path / "a.tga")
    img.save(path, rle=rle, orientation=orientation)
    assert _assert_decodes_as_pil(path).shape == (19, 26, 3)


def _tga(itype, w, h, depth, pixels: bytes, flags=0, cmap=None, id_field=b"") -> bytes:
    """A TGA: `cmap` is (first index, entry bits, entries' bytes)."""
    start, bits, entries = cmap or (0, 0, b"")
    count = len(entries) // max(1, bits // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap else 0, itype, start, count,
                       bits, 0, 0, w, h, depth, flags)
    return head + id_field + entries + pixels


def _tga_cases(rs):
    w, h = 7, 5
    idx = rs.randint(0, 12, (h, w)).astype(np.uint8)
    words = rs.randint(0, 1 << 16, (h, w)).astype("<u2")
    bgra = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    return {
        "argb1555": _tga(2, w, h, 16, words.tobytes()),
        "argb1555-rle": _tga(10, w, h, 16, b"".join(
            bytes([0x80 | 6]) + words.reshape(-1)[k:k + 1].tobytes() for k in range(0, 35, 7))),
        "right-to-left": _tga(2, w, h, 32, bgra.tobytes(), flags=0x10),
        "right-to-left-top": _tga(2, w, h, 32, bgra.tobytes(), flags=0x30),
        "cmap24-offset": _tga(1, w, h, 8, idx.tobytes(),
                              cmap=(3, 24, rs.randint(0, 256, (9, 3)).astype(np.uint8).tobytes())),
        "cmap16": _tga(1, w, h, 8, idx.tobytes(),
                       cmap=(0, 16, rs.randint(0, 1 << 16, 12).astype("<u2").tobytes())),
        "cmap24-rle": _tga(9, w, h, 8, bytes([0x80 | 2, 5, 3, 1, 2, 3, 4]) * 5,
                           cmap=(0, 24, rs.randint(0, 256, (12, 3)).astype(np.uint8).tobytes())),
        "rgb24-rle-mixed": _tga(10, w, h, 24, (bytes([0x80 | 3, 9, 8, 7, 2]) + bytes(range(9)))
                                 * 5, flags=0x20),
        "id-field": _tga(3, w, h, 8, idx.tobytes(), id_field=b"an id field"),
        "grey-alpha16": _tga(3, w, h, 16, bgra[..., :2].tobytes(), flags=0x20),
    }


@pytest.mark.parametrize("case", list(_tga_cases(np.random.RandomState(0))))
def test_tga_built_by_hand_decodes_as_pil(tmp_path, case):
    """What PIL does not write: 16-bit A1R5G5B5 (Pillow's BGRA;15Z, alpha
    0 where the top bit is set), right-to-left rows, colour maps of 16 and
    24 bits, one starting past index 0, RLE runs and raw packets in a row."""
    path = str(tmp_path / "b.tga")
    open(path, "wb").write(_tga_cases(np.random.RandomState(0))[case])
    assert _assert_decodes_as_pil(path).shape == (5, 7, 3)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil_decodes_as_pil(tmp_path, mode):
    arr = _smooth(13, 22, 7, 50.0)
    img = {"1": lambda: Image.fromarray(arr[..., 0] > 120),
           "L": lambda: Image.fromarray(arr[..., 1]),
           "P": lambda: Image.fromarray(arr).quantize(30),
           "RGB": lambda: Image.fromarray(arr),
           "RGBA": lambda: Image.fromarray(np.concatenate([arr, arr[..., :1]], -1))}[mode]()
    path = str(tmp_path / "a.bmp")
    img.save(path)
    assert _assert_decodes_as_pil(path).shape == (13, 22, 3)


def _bmp_cases(rs):
    w, h = 9, 6
    bmp = make_fixtures._bmp
    rgb = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    pal = rs.randint(0, 256, (16, 4)).astype(np.uint8).tobytes()

    def rows(b, bits):  # pad each row to 4 bytes
        stride = ((w * bits + 31) >> 3) & ~3
        return b"".join(r.tobytes() + bytes(stride - r.nbytes) for r in b)

    idx4 = rs.randint(0, 16, (h, 10)).astype(np.uint8)
    idx1 = rs.randint(0, 2, (h, 16)).astype(np.uint8)
    words = rs.randint(0, 1 << 16, (h, w)).astype("<u2")
    cases = {
        "palette4": bmp(rows(idx4[:, 0::2] << 4 | idx4[:, 1::2], 4), w, h, 4, palette=pal),
        "palette1-colour": bmp(rows(np.packbits(idx1, axis=1), 1), w, h, 1, palette=pal[:8]),
        "rgb555": bmp(rows(words, 16), w, h, 16),
        "rgb565-bitfields": bmp(rows(words, 16), w, h, 16, 40, 3, (0xF800, 0x7E0, 0x1F)),
        "rgb555-bitfields-v4": bmp(rows(words, 16), w, h, 16, 108, 3, (0x7C00, 0x3E0, 0x1F, 0)),
        "bgr24-topdown": bmp(rows(rgb[..., :3], 24), w, -h, 24),
        "bgrx32": bmp(rows(rgb, 32), w, h, 32),
        "bgr24-bitfields-v5": bmp(rows(rgb[..., :3], 24), w, h, 24, 124, 3,
                                  (0xFF0000, 0xFF00, 0xFF, 0)),
        "os2-palette8": None,
    }
    for masks in [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                  (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                  (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]:
        cases["bitfields32-" + "-".join(f"{m:x}" for m in masks)] = bmp(
            rows(rgb, 32), w, -h, 32, 124, 3, masks)
    # an OS/2 1.x header (12 bytes, 3-byte palette entries), 8-bit
    idx8 = rs.randint(0, 5, (h, w)).astype(np.uint8)
    pal3 = rs.randint(0, 256, (5, 3)).astype(np.uint8).tobytes()
    core = struct.pack("<IHHHH", 12, w, h, 1, 8)
    body = rows(idx8, 8)
    off = 14 + 12 + len(pal3)
    cases["os2-palette8"] = b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + core \
        + pal3 + body
    return cases


@pytest.mark.parametrize("case", list(_bmp_cases(np.random.RandomState(0))))
def test_bmp_built_by_hand_decodes_as_pil(tmp_path, case):
    """What PIL does not write: 4-bit and coloured 1-bit palettes, 16-bit
    5-5-5 and 5-6-5, top-down rows, BGRX, every 32-bit BI_BITFIELDS layout
    Pillow takes (alpha where its masks name one), the masks in a 40-byte,
    V4 and V5 header, and an OS/2 1.x header."""
    path = str(tmp_path / "b.bmp")
    open(path, "wb").write(_bmp_cases(np.random.RandomState(0))[case])
    assert _assert_decodes_as_pil(path).shape == (6, 9, 3)


# ------------------------------------------------------------- refusals
def _progressive_cut(tmp_path) -> str:
    """A progressive JPEG whose last scans are gone (EOI after the third
    scan): libjpeg smooths its blocks, the port refuses it."""
    data = open(_pil_jpeg(str(tmp_path / "p.jpg"), _smooth(32, 32, 8), progressive=True),
                "rb").read()
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    path = str(tmp_path / "cut.jpg")
    open(path, "wb").write(data[:starts[3]] + b"\xff\xd9")
    return path


def _refused_file(tmp_path, kind) -> str:
    arr = _smooth(16, 16, 1)
    path = str(tmp_path / f"r.{kind}")
    if kind == "cmyk":
        Image.fromarray(np.concatenate([arr, arr[..., :1]], -1), "CMYK").save(path, "JPEG")
    elif kind in ("12-bit", "arithmetic", "lossless"):
        data = bytearray(open(_pil_jpeg(path + ".src", arr), "rb").read())
        sof = data.index(b"\xff\xc0")
        if kind == "12-bit":
            data[sof + 4] = 12
        else:
            data[sof + 1] = 0xC9 if kind == "arithmetic" else 0xC3
        open(path, "wb").write(bytes(data))
    elif kind in ("tiff", "gif", "webp"):
        Image.fromarray(arr).save(path, kind.upper())
    elif kind == "bmp-rle8":
        body = bytes([4, 1, 0, 0]) * 16 + bytes([0, 1])  # runs of 4, end of line; end of bitmap
        open(path, "wb").write(make_fixtures._bmp(body, 16, 16, 8, compression=1,
                                                  palette=bytes(range(8))))
    elif kind == "sampling-h1v2":
        data = bytearray(open(_pil_jpeg(path + ".src", arr, subsampling=0), "rb").read())
        sof = data.index(b"\xff\xc0")
        data[sof + 11] = 0x12  # luma 1x2: a 4:4:0 layout
        open(path, "wb").write(bytes(data))
    return path


REFUSED = {"cmyk": "4-component", "12-bit": "12-bit", "arithmetic": "arithmetic",
           "lossless": "lossless", "tiff": "TIFF", "gif": "GIF", "webp": "WebP",
           "bmp-rle8": "RLE", "sampling-h1v2": "sampling"}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_kinds_raise_with_their_reason(tmp_path, kind):
    """What the port still refuses raises NotImplementedError naming the
    file and the reason, from `refusal` (the headers alone) and from the
    readers; PIL reads each of those it writes."""
    if kind == "webp" and not features.check("webp"):
        pytest.skip("this Pillow writes no WebP")
    path = _refused_file(tmp_path, kind)
    assert REFUSED[kind] in image.refusal(path)
    for read in (image.read_png, image.read_rgba, image.read_image):
        with pytest.raises(NotImplementedError, match=REFUSED[kind]):
            read(path)
    with pytest.raises(NotImplementedError, match=REFUSED[kind]):
        obj._load_image(path)
    if kind in ("cmyk", "tiff", "gif", "webp", "bmp-rle8"):
        assert jimage.read_png(path).shape == (16, 16, 3)


def test_progressive_jpeg_with_unfinished_scans_refused(tmp_path):
    """The decoder finds this one: its headers are those of a file it reads."""
    path = _progressive_cut(tmp_path)
    assert image.refusal(path) is None
    with pytest.raises(raster.Refused, match="unfinished"):
        image.read_png(path)
    with pytest.raises(NotImplementedError, match="unfinished"):
        obj._load_image(path)
    assert jimage.read_png(path).shape == (32, 32, 3)  # PIL's smoothed decode


def _corrupt_file(tmp_path, kind) -> str:
    arr = _smooth(20, 24, 2)
    path = str(tmp_path / f"c_{kind}")
    buf = io.BytesIO()
    fmt = {"jpeg": "JPEG", "png": "PNG", "bmp": "BMP", "tga": "TGA"}.get(kind.split("-")[0])
    if fmt:
        Image.fromarray(arr).save(buf, fmt)
    data = buf.getvalue()
    cut = {"jpeg-truncated": data[:len(data) // 2], "jpeg-no-eoi": data[:-2],
           "jpeg-header": data[:40], "progressive-truncated": None,
           "png-truncated": data[:len(data) // 2], "png-bad-crc": None,
           "bmp-truncated": data[:len(data) - 100], "tga-truncated": data[:len(data) - 50],
           "garbage": b"\xff\xd8\xff\xe0 not an image", "empty": b"",
           # a colour map of 32 bits, which Pillow fails on ("unrecognized raw mode")
           "tga-cmap32": _tga(1, 4, 2, 8, bytes(8), cmap=(0, 32, bytes(16))),
           # an RLE run across the end of a row: Pillow's decoder overruns
           "tga-rle-across-rows": _tga(10, 4, 2, 24, bytes([0x80 | 7, 1, 2, 3])),
           # type and depth pairs Pillow has no raw mode for, and RLE 1-bit
           "tga-type2-8-bit": _tga(2, 4, 2, 8, bytes(8)),
           "tga-rle-1-bit": _tga(11, 8, 2, 1, bytes([0x81, 0xFF]))}[kind]
    if kind == "progressive-truncated":
        Image.fromarray(arr).save(buf := io.BytesIO(), "JPEG", progressive=True)
        cut = buf.getvalue()[:len(buf.getvalue()) * 2 // 3]
    if kind == "png-bad-crc":
        cut = bytearray(data)
        cut[29] ^= 1  # IHDR's checksum
        cut = bytes(cut)
    open(path, "wb").write(cut)
    return path


CORRUPT = ["jpeg-truncated", "jpeg-no-eoi", "jpeg-header", "progressive-truncated",
           "png-truncated", "png-bad-crc", "bmp-truncated", "tga-truncated", "tga-cmap32",
           "tga-rle-across-rows", "tga-type2-8-bit", "tga-rle-1-bit", "garbage", "empty"]


@pytest.mark.parametrize("kind", CORRUPT)
def test_corrupt_and_truncated_files_raise_as_pil(tmp_path, kind):
    """read_image raises where JAX's PIL raises (an error, not a refusal);
    an OBJ map gives None in both packages."""
    path = _corrupt_file(tmp_path, kind)
    with pytest.raises(Exception):
        jimage.read_image(path)
    with pytest.raises(image.DECODE_ERRORS):
        image.read_image(path)
    assert image.refusal(path) is None
    assert obj._load_image(path) is None and jobj._load_image(path) is None


# -------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_match_pil(name):
    """Each checked-in fixture: PIL's decode made anew equals the
    checked-in one, and the port decodes the fixture to it bit for bit
    (what chip_smoke.py's phase 12 holds on the card, without PIL)."""
    path = os.path.join(FIXTURE_DIR, name)
    want = make_fixtures.pil_decode(path)
    with Image.open(path + make_fixtures.DECODE_SUFFIX) as im:
        assert im.mode == "RGBA" and im.format == "PNG"
        np.testing.assert_array_equal(np.asarray(im), want)
    np.testing.assert_array_equal(_bits(image.read_rgba(path)),
                                  _bits(want.astype(np.float32) / 255.0))
    np.testing.assert_array_equal(
        _bits(image.read_rgba(path + make_fixtures.DECODE_SUFFIX)),
        _bits(want.astype(np.float32) / 255.0))


def test_fixtures_cover_every_kind_and_stay_small():
    kinds = {os.path.splitext(f)[1] for f in FIXTURES}
    assert kinds == {".jpg", ".tga", ".bmp", ".png"}
    assert sorted(FIXTURES) == sorted(make_fixtures.fixtures())
    assert sum(os.path.getsize(os.path.join(FIXTURE_DIR, f))
               for f in os.listdir(FIXTURE_DIR)) < 512 * 1024
    with Image.open(os.path.join(FIXTURE_DIR, "env_1024x512.jpg")) as im:
        assert im.size == (1024, 512) and im.mode == "RGB"


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
    """.png, .HDR and .jpg through read_image as JAX's; the format is the
    file's, not its suffix's (a PNG named .jpg reads as a PNG), but for
    .hdr, which goes by its suffix as in JAX."""
    img = _seeded(8, 16, 3, seed=4)
    jimage.write_png(str(tmp_path / "a.png"), img)
    jimage.write_hdr(str(tmp_path / "a.HDR"), img * 4.0)
    jimage.write_png(str(tmp_path / "png_named.jpg"), img)
    Image.fromarray(jimage.to_u8(img)).save(str(tmp_path / "a.jpg"), quality=90)
    for name in ("a.png", "a.HDR", "png_named.jpg", "a.jpg"):
        got, want = image.read_image(str(tmp_path / name)), jimage.read_image(str(tmp_path / name))
        assert got.shape == (8, 16, 4)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(FileNotFoundError):
        image.read_image(str(tmp_path / "missing.jpg"))


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
