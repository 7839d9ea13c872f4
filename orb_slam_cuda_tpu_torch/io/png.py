"""PNG reading and writing on the standard library's zlib and numpy: the
port's stand-in for cv2.imread and cv2.imwrite, which the machine with
the card does not have.

Reads non-interlaced 8-bit gray, 16-bit gray (big-endian in the file,
native uint16 here), 8-bit RGB and 8-bit RGBA; any other colour type, bit
depth or an interlaced file raises `PngError` naming the file. `read`
returns the samples as stored, channels in the file's order (RGB, where
cv2.imread(IMREAD_UNCHANGED) gives BGR); `read_gray` returns what
cv2.imread(path, IMREAD_GRAYSCALE) returns, bit for bit: libpng's own
rgb-to-gray (weights 9797, 19234, 3737 over 2^15, truncated; alpha
dropped) and the high byte of a 16-bit sample.

Decoding is zlib plus the reversal of the per-row filters. None, Sub and
Up vectorise; Avg and Paeth depend on the byte just decoded to their
left. The decoder is an argument: "native" reverses all five in
`csrc/png_unfilter.cpp`, compiled with g++ at first use into
`build/native/` and called through ctypes; "numpy" does it in numpy and
Python (slow on Avg and Paeth rows, kept as the reference the tests hold
the native one to). Nothing switches from one to the other.

`write` stores 2-D uint8 as 8-bit gray, 2-D uint16 as 16-bit gray and
(H, W, 3) uint8 as 8-bit RGB, every row with the Up filter, at zlib level
6.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ..utils import native_build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "png_unfilter.cpp")
DECODERS = ("native", "numpy")
ZLIB_LEVEL = 6
# (colour type, bit depth) -> channels; the kinds this module reads.
_CHANNELS = {(0, 8): 1, (0, 16): 1, (2, 8): 3, (6, 8): 4}
_COLOUR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
# libpng's png_set_rgb_to_gray(0.299, 0.587) as 15-bit fixed point.
_GRAY_WEIGHTS = (9797, 19234, 3737)

_lib = None


class PngError(ValueError):
    """A file this module cannot read: not a PNG, corrupt, or of a kind
    it does not support."""


def _native():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(native_build.build(SOURCE, "PNG unfilter"))
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    return _lib


def _unfilter_native(raw: bytes, height: int, row_bytes: int, bpp: int, name: str) -> np.ndarray:
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = _native().png_unfilter(src.ctypes.data, out.ctypes.data, height, row_bytes, bpp)
    if bad:
        raise PngError(f"{name}: row {bad - 1} has filter type {src[(bad - 1) * (row_bytes + 1)]}, not 0-4")
    return out


def _unfilter_numpy(raw: bytes, height: int, row_bytes: int, bpp: int, name: str) -> np.ndarray:
    src = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.empty((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(height):
        filt, line = int(src[y, 0]), src[y, 1:]
        if filt == 0:
            row = line.copy()
        elif filt == 1:  # a wrapping cumsum along each byte lane of the pixel
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif filt == 2:
            row = line + prev
        elif filt in (3, 4):
            cur, above = line.tolist(), prev.tolist()
            for x in range(row_bytes):
                a = cur[x - bpp] if x >= bpp else 0
                b = above[x]
                if filt == 3:
                    pred = (a + b) >> 1
                else:
                    c = above[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            row = np.asarray(cur, np.uint8)
        else:
            raise PngError(f"{name}: row {y} has filter type {filt}, not 0-4")
        out[y] = row
        prev = row
    return out


def decode(data: bytes, decoder: str = "native", name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) uint8/uint16 or (H, W, C) uint8, as stored."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if data[:8] != SIGNATURE:
        raise PngError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise PngError(f"{name}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PngError(f"{name}: CRC mismatch in {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise PngError(f"{name}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    kind = f"colour type {colour} ({_COLOUR_NAMES.get(colour, 'unknown')}), bit depth {depth}"
    if (colour, depth) not in _CHANNELS:
        raise PngError(f"{name}: {kind} is not read here (8-bit gray, 16-bit gray, 8-bit RGB and RGBA are)")
    if interlace != 0:
        raise PngError(f"{name}: {kind}, Adam7-interlaced: only non-interlaced files are read")
    if compression != 0 or filtering != 0:
        raise PngError(f"{name}: unknown compression {compression} or filter method {filtering}")
    channels = _CHANNELS[(colour, depth)]
    bpp = channels * depth // 8
    row_bytes = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"{name}: corrupt image data: {e}") from e
    if len(raw) != height * (row_bytes + 1):
        raise PngError(f"{name}: {len(raw)} bytes of image data, {height * (row_bytes + 1)} expected "
                       f"for {width}x{height}, {kind}")
    unfilter = _unfilter_native if decoder == "native" else _unfilter_numpy
    rows = unfilter(raw, height, row_bytes, bpp, name)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    return rows.reshape(height, width, channels) if channels > 1 else rows.reshape(height, width)


def read(path: str, decoder: str = "native") -> np.ndarray:
    """The samples of a PNG file as stored (see `decode`)."""
    with open(path, "rb") as f:
        return decode(f.read(), decoder, name=os.fspath(path))


def to_gray(img: np.ndarray) -> np.ndarray:
    """8-bit gray from `read`'s result, as cv2.imread(IMREAD_GRAYSCALE)
    converts the file it reads."""
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    wr, wg, wb = _GRAY_WEIGHTS
    return ((wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]) >> 15).astype(np.uint8)


def read_gray(path: str, decoder: str = "native") -> np.ndarray:
    """cv2.imread(path, cv2.IMREAD_GRAYSCALE), for the kinds `read` takes."""
    return to_gray(read(path, decoder))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> 8-bit gray, (H, W) uint16 -> 16-bit gray, (H, W, 3)
    uint8 -> 8-bit RGB; every row Up-filtered."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint8:
        colour, depth, rows = 0, 8, img
    elif img.ndim == 2 and img.dtype == np.uint16:
        colour, depth, rows = 0, 16, img.astype(">u2").view(np.uint8)
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        colour, depth, rows = 2, 8, img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot write a {img.dtype} array of shape {img.shape} as PNG "
                         "(2-D uint8, 2-D uint16 or (H, W, 3) uint8)")
    height, width = img.shape[:2]
    if height == 0 or width == 0:
        raise ValueError(f"cannot write an empty image of shape {img.shape}")
    rows = np.ascontiguousarray(rows)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps, as the Up filter does
    stream = np.empty((height, rows.shape[1] + 1), np.uint8)
    stream[:, 0] = 2
    stream[:, 1:] = up
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(stream.tobytes(), ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> str:
    """Write `img` as a PNG file (see `encode`); returns the path."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
    return path
