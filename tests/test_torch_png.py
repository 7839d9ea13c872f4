"""The port's PNG codec (orb_slam_cuda_tpu_torch/io/png.py) against
OpenCV, and its two decoders against each other. Every comparison is
exact (tolerance 0): files cv2 writes, with its default
filter and with libpng choosing among all five per row (as the tools
that write real KITTI, TUM and EuRoC files do), decode to cv2.imread's arrays: 8-bit
gray, 16-bit gray and RGB(A) under IMREAD_UNCHANGED (channels reversed:
cv2 gives BGR) and under IMREAD_GRAYSCALE (libpng's rgb-to-gray, the high
byte of 16 bits); cv2 reads the port's files back equal to their source;
hand-built files with a random filter type on every row, sizes 1x1 to
67x131, decode to their source with both decoders."""

import os
import re
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hs

from orb_slam_cuda_tpu_torch.io import png
from orb_slam_cuda_tpu_torch.utils import native_build

DECODERS = ("native", "numpy")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _textured(rng, h, w, channels=None, dtype=np.uint8):
    """Smooth gradients, blur and hard-edged blocks, so that cv2's
    per-row filter choice varies over the image."""
    top = 65535 if dtype == np.uint16 else 255
    shape = (h, w) if channels is None else (h, w, channels)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2) % 256 / 255.0
    if channels is not None:
        base = base[..., None]
    img = base * top * 0.5 + rng.uniform(0, top * 0.25, shape)
    img = cv2.GaussianBlur(img.astype(np.float32), (0, 0), 1.5)
    img = img.reshape(shape)
    for _ in range(8):
        y, x = rng.integers(0, h - 4), rng.integers(0, w - 4)
        img[y:y + rng.integers(2, 12), x:x + rng.integers(2, 20)] = rng.uniform(0, top)
    return np.clip(img, 0, top).astype(dtype)


KINDS = {
    "gray8": lambda rng: _textured(rng, 61, 97),
    "gray16": lambda rng: _textured(rng, 47, 83, dtype=np.uint16),
    "rgb8": lambda rng: _textured(rng, 53, 71, channels=3),
    "rgba8": lambda rng: _textured(rng, 37, 59, channels=4),
}


FILTERS = {"default": [], "all_filters": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]}


@pytest.fixture(scope="module")
def cv2_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    out = {}
    for name, make in KINDS.items():
        img = make(rng)
        for filters, params in FILTERS.items():
            path = str(d / f"{name}_{filters}.png")
            assert cv2.imwrite(path, img, params)
            out[name, filters] = path
    return out


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("filters", list(FILTERS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_reads_cv2_files_as_cv2_does(cv2_files, kind, filters, decoder):
    path = cv2_files[kind, filters]
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read(path, decoder)
    if got.ndim == 3:
        got = got[..., [2, 1, 0, 3][:got.shape[2]]]
    assert got.dtype == want.dtype and np.array_equal(got, want)
    gray = png.read_gray(path, decoder)
    want_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert gray.dtype == np.uint8 and np.array_equal(gray, want_gray)


def test_cv2_files_mix_the_filter_types(cv2_files):
    """The fixture's all-filter files exercise Sub, Up, Avg and Paeth
    (read from the decompressed stream's row bytes; None is the
    hand-built files' business)."""
    seen = set()
    for (_, filters), path in cv2_files.items():
        if filters != "all_filters":
            continue
        data = open(path, "rb").read()
        w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
        idat, pos = b"", 8
        while pos < len(data):
            n, kind = struct.unpack(">I4s", data[pos:pos + 8])
            if kind == b"IDAT":
                idat += data[pos + 8:pos + 8 + n]
            pos += 12 + n
        raw = zlib.decompress(idat)
        row = len(raw) // h
        seen |= {raw[y * row] for y in range(h)}
    assert {1, 2, 3, 4} <= seen, seen


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8"])
def test_cv2_reads_written_files_back(tmp_path, kind):
    img = KINDS[kind](np.random.default_rng(1))
    path = str(tmp_path / f"{kind}.png")
    assert png.write(path, img) == path
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        back = back[..., ::-1]
    assert back.dtype == img.dtype and np.array_equal(back, img)
    assert np.array_equal(png.read(path), img)


def _filter_row(cur, prev, bpp, ftype):
    """PNG's forward filter of one row, byte by byte (the specification's
    own formulas: the reference the decoders reverse)."""
    out = bytearray(len(cur))
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (cur[x] - pred) & 0xFF
    return bytes(out)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _build_png(img, colour, depth, filters, interlace=0):
    h, w = img.shape[:2]
    rows = img.astype(">u2").view(np.uint8) if depth == 16 else img
    rows = rows.reshape(h, -1)
    bpp = rows.shape[1] // w
    prev = bytes(rows.shape[1])
    stream = b""
    for y in range(h):
        cur = rows[y].tobytes()
        stream += bytes([filters[y]]) + _filter_row(cur, prev, bpp, filters[y])
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return png.SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(stream)) + _chunk(b"IEND", b"")


# (colour type, bit depth, channels, dtype)
HAND_KINDS = [(0, 8, 1, np.uint8), (0, 16, 1, np.uint16), (2, 8, 3, np.uint8), (6, 8, 4, np.uint8)]


@settings(max_examples=40, deadline=None)
@given(h=hs.integers(1, 67), w=hs.integers(1, 131), kind=hs.sampled_from(HAND_KINDS),
       seed=hs.integers(0, 2**32 - 1))
def test_random_filter_per_row_decodes_exactly(h, w, kind, seed):
    colour, depth, channels, dtype = kind
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=np.uint64).astype(dtype)
    filters = rng.integers(0, 5, h).tolist()
    data = _build_png(img, colour, depth, filters)
    for decoder in DECODERS:
        got = png.decode(data, decoder)
        assert got.dtype == dtype and np.array_equal(got, img), (decoder, filters)


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("colour,depth,word", [(3, 8, "palette"), (4, 8, "gray+alpha"), (2, 16, "RGB"),
                                               (0, 4, "gray")])
def test_unsupported_kinds_raise_naming_file_and_colour_type(tmp_path, decoder, colour, depth, word):
    header = struct.pack(">IIBBBBB", 4, 3, depth, colour, 0, 0, 0)
    path = str(tmp_path / "odd.png")
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(b"\0" * 64))
                + _chunk(b"IEND", b""))
    with pytest.raises(png.PngError, match=rf"odd\.png: colour type {colour} \({re.escape(word)}\), bit depth {depth}"):
        png.read(path, decoder)


@pytest.mark.parametrize("decoder", DECODERS)
def test_interlaced_and_corrupt_files_raise(decoder):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    with pytest.raises(png.PngError, match="colour type 0 \\(gray\\).*interlaced"):
        png.decode(_build_png(img, 0, 8, [0, 0, 0], interlace=1), decoder, name="i.png")
    good = _build_png(img, 0, 8, [0, 1, 2])
    bad_filter = bytearray(zlib.decompress(good[8 + 25 + 8:-12 - 4]))
    bad_filter[5] = 7  # row 1's filter byte
    data = png.SIGNATURE + good[8:8 + 25] + _chunk(b"IDAT", zlib.compress(bytes(bad_filter))) + _chunk(b"IEND", b"")
    with pytest.raises(png.PngError, match="b.png: row 1 has filter type 7"):
        png.decode(data, decoder, name="b.png")
    crc = bytearray(good)
    crc[20] ^= 1  # inside IHDR's body
    with pytest.raises(png.PngError, match="CRC mismatch"):
        png.decode(bytes(crc), decoder)
    with pytest.raises(png.PngError, match="not a PNG"):
        png.decode(b"GIF89a" + good[6:], decoder)


def test_decoder_is_an_argument_and_never_switches():
    data = _build_png(np.zeros((2, 2), np.uint8), 0, 8, [0, 0])
    with pytest.raises(ValueError, match="decoder must be one of"):
        png.decode(data, "cv2")


def test_writer_refuses_what_it_cannot_store():
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8), np.zeros((0, 3), np.uint8)):
        with pytest.raises(ValueError):
            png.encode(bad)


def test_native_unfilter_is_the_ports_own_build():
    """The unfilter is compiled from the port's own source into
    build/native/ with portable flags, and reused once built."""
    path = native_build.build(png.SOURCE, "PNG unfilter")
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libpng_unfilter_")
    assert png.SOURCE == os.path.join(REPO, "orb_slam_cuda_tpu_torch", "csrc", "png_unfilter.cpp")
    assert not any(f.startswith("-march") for f in native_build.FLAGS)
    assert native_build.build(png.SOURCE, "PNG unfilter") == path


def test_native_build_hashes_the_headers_a_source_includes(tmp_path):
    """A header included with `#include "..."` (and the headers it
    includes) is part of the library's hash: editing it builds anew. The
    kernels' shared Jacobi header is found from both of its sources."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.h").write_text('#include "sub/b.h"\nconstexpr int A = 1;\n')
    (tmp_path / "sub" / "b.h").write_text("constexpr int B = 2;\n")
    src = tmp_path / "lib.cpp"
    src.write_text('#include <cmath>\n#include "a.h"\n#include "missing.h"\nextern "C" int f() { return A + B; }\n')
    got = native_build.sources(str(src))
    assert got == [str(src), str(tmp_path / "a.h"), str(tmp_path / "sub" / "b.h")]
    src.write_text('#include <cmath>\n#include "a.h"\nextern "C" int f() { return A + B; }\n')
    out = str(tmp_path / "out")
    first = native_build.build(str(src), "include test", build_dir=out)
    assert native_build.build(str(src), "include test", build_dir=out) == first
    (tmp_path / "sub" / "b.h").write_text("constexpr int B = 3;\n")
    second = native_build.build(str(src), "include test", build_dir=out)
    assert second != first and os.path.exists(second)
    csrc = os.path.join(REPO, "orb_slam_cuda_tpu_torch", "csrc")
    for name in ("triangulate_dlt.cu", "sim3_ransac.cu"):
        assert native_build.sources(os.path.join(csrc, name))[1:] == [os.path.join(csrc, "jacobi4.cuh")]


def test_failed_native_build_raises_not_switches(monkeypatch):
    def no_compiler(*a, **k):
        raise RuntimeError("PNG unfilter: cannot run 'g++'")

    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    data = _build_png(img, 0, 8, [4, 3, 1])
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png.native_build, "build", no_compiler)
    with pytest.raises(RuntimeError, match="PNG unfilter"):
        png.decode(data)
    assert np.array_equal(png.decode(data, "numpy"), img)
