"""PNG writer in the standard library (zlib + struct): 8-bit RGB/RGBA,
no filtering.  Float images in [0, 1] round to uint8 as
`clip(x, 0, 1) * 255 + 0.5`, as the reference's writer does."""

from __future__ import annotations

import struct
import zlib

import numpy as np


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
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def write_png_batch(paths, images) -> None:
    for p, im in zip(paths, images):
        write_png(p, im)
