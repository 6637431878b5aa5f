"""PNG reader and writer in the standard library (zlib + struct).

The reader decodes what the reference's native decoder
(`tnerf/native/src/png_decoder.cpp`) decodes, to the same RGBA bytes:
8-bit grey, grey + alpha, RGB, RGBA and palette images (palette alpha
from tRNS; a grey or RGB image's tRNS colour key is ignored, as there),
non-interlaced, all five row filters.  Anything else (16-bit or sub-byte
samples, Adam7 interlacing, a corrupt stream) raises ValueError naming
what it met; no image is ever returned wrong.

The writer writes 8-bit RGB/RGBA, no filtering.  Float images in [0, 1]
round to uint8 as `clip(x, 0, 1) * 255 + 0.5`, as the reference's writer
does."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_KIND = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in {tag!r} chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk (truncated file)")


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) -> [h, w,
    bpp] uint8.

    A pixel depends on the one to its left, above and above-left, so the
    pixels of one anti-diagonal (x + y = d) depend only on the two
    diagonals before: the image is rebuilt diagonal by diagonal, each
    diagonal in one pass over all five filters, chosen per row.  Images
    whose rows use only None, Sub and Up go row by row instead (Sub is a
    cumulative sum)."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: decompressed {len(raw)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    ftype = rows[:, 0]
    if int(ftype.max()) > 4:
        y = int(np.argmax(ftype > 4))
        raise ValueError(f"{path}: unknown row filter {int(ftype[y])} in row {y}")
    cur = rows[:, 1:].reshape(h, w, bpp)
    if int(ftype.max()) <= 2:
        out = np.empty((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            f = ftype[y]
            if f == 0:
                out[y] = cur[y]
            elif f == 1:
                out[y] = np.cumsum(cur[y], axis=0, dtype=np.int64) % 256
            else:
                out[y] = cur[y] + prev  # uint8 wraps modulo 256
            prev = out[y]
        return out
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    cur = cur.astype(np.int32)
    ft = ftype.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ft[ys]
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                                               np.where(f == 2, b, np.where(f == 1, a, 0))))
        rec[ys + 1, xs + 1] = (cur[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> [H, W, 4] uint8 RGBA (module docstring for what is
    read and what is refused)."""
    ihdr, plte, trns, idat = None, None, b"", []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = body
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit {_KIND[ctype]} PNG is not supported (8-bit only)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} / filter method {filt}")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty image {w}x{h}")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    img = _unfilter(raw, h, w, ch, path)
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 6:
        out[:] = img
    elif ctype == 2:
        out[..., :3] = img
        out[..., 3] = 255
    elif ctype == 0:
        out[..., :3] = img
        out[..., 3] = 255
    elif ctype == 4:
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
    else:
        if plte is None or len(plte) % 3 or not plte:
            raise ValueError(f"{path}: palette image without a valid PLTE chunk")
        ncol = len(plte) // 3
        idx = img[..., 0]
        if int(idx.max()) >= ncol:
            raise ValueError(f"{path}: palette index {int(idx.max())} beyond {ncol} colours")
        table = np.full((256, 4), 255, np.uint8)
        table[:ncol, :3] = np.frombuffer(plte, np.uint8).reshape(ncol, 3)
        alpha = np.frombuffer(trns[:ncol], np.uint8)
        table[:len(alpha), 3] = alpha
        out[:] = table[idx]
    return out


def read_png(path: str, channels: int = 4, srgb_to_linear: bool = False) -> np.ndarray:
    """A PNG file -> float32 [H, W, channels] in [0, 1] (`tnerf/data/
    png_io.py:18`): the RGBA bytes / 255, with the sRGB decode on the
    colour channels if asked; channels 3 drops alpha."""
    if channels not in (3, 4):
        raise ValueError(f"channels must be 3 or 4, got {channels}")
    with open(path, "rb") as fh:
        out = decode_png(fh.read(), path).astype(np.float32) / 255.0
    if srgb_to_linear:
        rgb = out[..., :3]
        out[..., :3] = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return out[..., :3] if channels == 3 else out


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def to_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return arr


def encode_png(image) -> bytes:
    """[H, W, 3|4] float in [0,1] or uint8 -> PNG bytes."""
    arr = to_uint8(image)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4], got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def write_png_batch(paths, images) -> None:
    for p, im in zip(paths, images):
        write_png(p, im)
