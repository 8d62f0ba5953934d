"""PNG reader and writer for patch files, without PIL.

`decode_png` checks the signature and every chunk's CRC, reads IHDR, joins
the IDAT chunks, inflates them with zlib and undoes the row filters (None,
Sub, Up, Average, Paeth) of 8-bit greyscale (colour type 0), RGB (2),
greyscale with alpha (4) and RGBA (6) images. Palette, 16-bit and
interlaced files raise.

The filters are undone by one of two routines, chosen by the caller:
- `unfilter_plain`, numpy: a row at a time where rows use None, Sub or Up,
  and a sweep of anti-diagonals over the rows from the first to the last
  that use Average or Paeth (there a pixel depends on its left, upper and
  upper-left neighbours);
- `unfilter_native`, C (`csrc/png_unfilter.cu`, host code built by
  `_build.py` with nvcc and bound by ctypes, which releases the interpreter
  lock, so loader threads decode in parallel).

`encode_png` writes an image with the filter type of each row named by the
caller; the tests and the synthetic slide of `chip_smoke.py` use it.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels of each supported colour type
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PNGError(ValueError):
    """A file that is not a PNG this reader supports."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise PNGError(f"truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"CRC mismatch in {kind.decode('latin-1')} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise PNGError("no IEND chunk")


def read_png(data: bytes):
    """Parse and inflate: ((height, width, channels), filtered scanlines)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    width, height, depth, ctype, compression, filt, interlace = header
    if ctype == 3:
        raise PNGError("palette PNGs are not supported")
    if ctype not in CHANNELS:
        raise PNGError(f"unknown colour type {ctype}")
    if depth != 8:
        raise PNGError(f"{depth}-bit PNGs are not supported (8-bit only)")
    if interlace != 0:
        raise PNGError("interlaced PNGs are not supported")
    if compression != 0 or filt != 0:
        raise PNGError("unknown compression or filter method")
    raw = zlib.decompress(b"".join(idat))
    shape = (height, width, CHANNELS[ctype])
    if len(raw) != height * (1 + width * shape[2]):
        raise PNGError("image data does not match the header's size")
    return shape, raw


def unfilter_plain(raw: bytes, shape) -> np.ndarray:
    """Undo the row filters in numpy: (height, width, channels) uint8."""
    h, w, c = shape
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    kinds = rows[:, 0].astype(np.int64)
    if (kinds > 4).any():
        raise PNGError(f"bad filter type {int(kinds.max())}")
    data = rows[:, 1:].reshape(h, w, c)
    out = np.zeros((h + 1, w + 1, c), np.int32)  # a zero row above, a zero column left
    slow = np.flatnonzero(kinds >= 3)
    first, last = (int(slow[0]), int(slow[-1]) + 1) if slow.size else (h, h)

    def row(r: int) -> None:  # None, Sub or Up: the whole row at once
        x = data[r].astype(np.int32)
        if kinds[r] == 1:
            x = np.cumsum(x, axis=0)
        elif kinds[r] == 2:
            x = x + out[r, 1:]
        out[r + 1, 1:] = x & 255

    for r in range(first):
        row(r)
    if slow.size:
        _sweep(data, kinds, out, first, last)
    for r in range(last, h):
        row(r)
    return out[1:, 1:].astype(np.uint8)


def _sweep(data: np.ndarray, kinds: np.ndarray, out: np.ndarray, r0: int, r1: int) -> None:
    """Rows r0..r1-1 by anti-diagonals: pixel (r, x) needs (r, x-1), (r-1, x)
    and (r-1, x-1), all on earlier diagonals."""
    w = data.shape[1]
    n = r1 - r0
    for d in range(n + w - 1):
        rs = np.arange(max(0, d - w + 1), min(n, d + 1)) + r0
        xs = d - (rs - r0)
        raw = data[rs, xs].astype(np.int32)
        a = out[rs + 1, xs]          # left
        b = out[rs, xs + 1]          # up
        c = out[rs, xs]              # up-left
        k = kinds[rs][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[rs + 1, xs + 1] = (raw + pred) & 255


def unfilter_native(raw: bytes, shape) -> np.ndarray:
    """Undo the row filters in compiled C (`csrc/png_unfilter.cu`)."""
    from cellvit_tpu_torch import _build

    h, w, c = shape
    out = np.empty(shape, np.uint8)
    fn = _build.bind_host("png_unfilter.cu", "png_unfilter", "ppiii")
    err = fn(raw, out.ctypes.data, h, w * c, c)
    if err != 0:
        raise PNGError(f"bad filter type in row {err - 1}")
    return out


def decode_png(data: bytes, native: bool = False) -> np.ndarray:
    """A PNG file's bytes → (H, W, C) uint8, or (H, W) for greyscale.
    `native` chooses the compiled unfilter over the numpy one."""
    shape, raw = read_png(data)
    img = unfilter_native(raw, shape) if native else unfilter_plain(raw, shape)
    return img[..., 0] if shape[2] == 1 else img


def _filter_rows(img: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Apply each row's filter to an (H, W, C) uint8 image: (H, 1 + W·C)."""
    h, w, c = img.shape
    x = np.pad(img.astype(np.int32), ((1, 0), (1, 0), (0, 0)))
    cur, a, b, cc = x[1:, 1:], x[1:, :-1], x[:-1, 1:], x[:-1, :-1]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
    pred = preds[kinds, np.arange(h)]
    rows = ((cur - pred) & 255).astype(np.uint8).reshape(h, w * c)
    return np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 0, level: int = 6) -> bytes:
    """An (H, W) or (H, W, C ∈ {1, 2, 3, 4}) uint8 image → PNG bytes, each
    row filtered by the type `filters` names for it (one type for every
    row, or one a row; 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if ((kinds < 0) | (kinds > 4)).any():
        raise ValueError("filter types are 0-4")
    scan = _filter_rows(img, kinds)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), level)) + _chunk(b"IEND", b""))
