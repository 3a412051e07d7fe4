"""PNG reading and writing on the standard library's `zlib` and numpy.

The port reads its datasets' frames and depth maps without PIL, OpenCV or
torchvision. This codec covers what they hold: 8-bit gray, RGB and RGBA and
16-bit gray, not interlaced, with all five filter types (None, Sub, Up,
Average, Paeth) for reading and writing. Palette, gray-with-alpha, 16-bit
colour, sub-byte depths and interlaced files raise, naming the file.

Decoding: rows filtered with None, Sub or Up only are undone row by row in
numpy. Average and Paeth depend on the reconstructed left, upper and
upper-left pixels, so an image that uses them is undone along
anti-diagonals (all pixels with r + x = d at once: each depends only on
diagonals d - 1 and d - 2), whatever the mix of filters per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth


def _paeth(a, b, c):
    """The Paeth predictor of int arrays: whichever of left (a), up (b) and
    upper-left (c) is nearest to a + b - c, ties in that order."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _predict(f, a, b, c):
    """What filter types f (an int array) predict from a, b, c (int
    arrays)."""
    return np.select([f == 1, f == 2, f == 3, f == 4],
                     [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)


def _predict_one(f: int, a, b, c):
    """What filter type f predicts from a, b, c (int arrays)."""
    if f == 0:
        return 0
    if f == 1:
        return a
    if f == 2:
        return b
    return (a + b) >> 1 if f == 3 else _paeth(a, b, c)


def _unfilter(ftypes: np.ndarray, data: np.ndarray) -> np.ndarray:
    """data (H, W, bpp) uint8 filtered bytes, ftypes (H,) -> raw bytes."""
    h, w, bpp = data.shape
    if ftypes.max(initial=0) <= 2:
        out = np.empty_like(data)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            f = ftypes[r]
            if f == 1:
                prev = np.cumsum(data[r], axis=0, dtype=np.uint8)  # wraps mod 256
            elif f == 2:
                prev = data[r] + prev
            else:
                prev = data[r].copy()
            out[r] = prev
        return out
    # anti-diagonal wavefront over a zero-bordered reconstruction
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        rows = np.arange(max(0, d - w + 1), min(h, d + 1))
        cols = d - rows
        a, b, c = rec[rows + 1, cols], rec[rows, cols + 1], rec[rows, cols]
        f = ftypes[rows][:, None]
        rec[rows + 1, cols + 1] = (data[rows, cols] + _predict(f, a, b, c)) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 or uint16 for gray, (H, W, 3) or (H, W, 4) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", blob[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or (depth == 16 and colour != 0):
        raise ValueError(f"{path}: PNG of colour type {colour} and bit depth {depth} is not "
                         "supported (8-bit gray, RGB, RGBA or 16-bit gray)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG filter type {rows[:, 0].max()}")
    raw = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    if depth == 16:
        return raw.reshape(h, w * 2).view(">u2").astype(np.uint16)
    return raw[..., 0] if channels == 1 else raw


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def write_png(path: str, image: np.ndarray, filter_type: int = 2, level: int = 6) -> None:
    """Write (H, W) uint8 or uint16 gray, or (H, W, 3|4) uint8, with one
    filter type for every row (default Up, which undoes fastest) and zlib
    compression `level`."""
    image = np.asarray(image)
    if filter_type not in FILTERS:
        raise ValueError(f"filter type {filter_type} is not one of {FILTERS}")
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, colour = 16, 0
        raw = image.astype(">u2").view(np.uint8).reshape(*image.shape, 2)
    elif image.dtype == np.uint8 and (image.ndim == 2 or image.shape[-1] in (3, 4)):
        depth, colour = 8, 0 if image.ndim == 2 else {3: 2, 4: 6}[image.shape[-1]]
        raw = image.reshape(image.shape[0], image.shape[1], -1)
    else:
        raise ValueError(f"cannot write a PNG of dtype {image.dtype} and shape {image.shape}")
    h, w, bpp = raw.shape
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    rec[1:, 1:] = raw
    a, b, c = rec[1:, :-1], rec[:-1, 1:], rec[:-1, :-1]
    filt = (rec[1:, 1:] - _predict_one(filter_type, a, b, c)) & 0xFF
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           filt.astype(np.uint8).reshape(h, w * bpp)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
