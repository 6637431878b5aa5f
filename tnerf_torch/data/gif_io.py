"""A standard-library animated-GIF writer, beside `png_io.py`: what `cli
render --orbit N --gif` writes (the reference builds the same file with
PIL, `tnerf/cli.py:614-630`: 100 ms frames, looping forever).  Each frame
gets its own palette of at most 256 colours (its exact colours where it has
no more, else a median cut of its pixels), and its palette indices are LZW
coded as GIF89a prescribes.  Numpy is the only dependency."""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

import numpy as np

MAX_COLOURS = 256
MAX_CODES = 4096  # GIF's LZW codes are at most 12 bits wide


def to_uint8(frame) -> np.ndarray:
    """[H, W, 3] floats in [0, 1] (or uint8) -> uint8, rounded as the
    reference rounds them (x * 255 + 0.5, clipped)."""
    a = np.asarray(frame)
    if a.dtype == np.uint8:
        return a
    return (np.clip(a.astype(np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _median_cut(colours: np.ndarray, counts: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(palette [k <= n, 3] uint8, box of each colour [C]) of the distinct
    colours [C, 3] of a frame with their pixel counts: the box with the
    widest channel range is split where half of its pixels lie on either
    side along that channel, until there are n boxes (or none can be
    split); each box's colour is its pixels' mean."""
    boxes = [np.arange(colours.shape[0])]
    spans = [np.ptp(colours, axis=0)]
    while len(boxes) < n:
        i = int(np.argmax([sp.max() for sp in spans]))
        if spans[i].max() == 0:
            break
        box, ch = boxes.pop(i), int(np.argmax(spans.pop(i)))
        order = box[np.argsort(colours[box, ch], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)) + 1, 1), order.size - 1)
        for part in (order[:cut], order[cut:]):
            boxes.append(part)
            spans.append(np.ptp(colours[part], axis=0))
    palette = np.zeros((len(boxes), 3), np.uint8)
    box_of = np.zeros(colours.shape[0], np.int64)
    for k, b in enumerate(boxes):
        w = counts[b].astype(np.float64)
        palette[k] = np.round((colours[b] * w[:, None]).sum(axis=0) / w.sum()).astype(np.uint8)
        box_of[b] = k
    return palette, box_of


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette [k, 3] uint8, indices [H, W] uint8) of one uint8 RGB frame."""
    h, w, _ = frame.shape
    colours, inverse, counts = np.unique(frame.reshape(-1, 3), axis=0, return_inverse=True,
                                         return_counts=True)
    inverse = inverse.reshape(-1)
    if colours.shape[0] <= MAX_COLOURS:
        return colours.astype(np.uint8), inverse.reshape(h, w).astype(np.uint8)
    palette, box_of = _median_cut(colours.astype(np.int64), counts, MAX_COLOURS)
    return palette, box_of[inverse].reshape(h, w).astype(np.uint8)


def lzw_encode(indices: Iterable[int], min_code_size: int) -> bytes:
    """GIF's variable-width LZW code stream of `indices`, packed LSB first:
    a clear code first, the table restarted with a clear code once it
    holds MAX_CODES entries, the end-of-information code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = n_bits = 0
    width = min_code_size + 1

    def emit(code: int) -> None:
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    table = {}
    next_code = end + 1
    emit(clear)
    prefix = None
    for k in indices:
        if prefix is None:
            prefix = k
            continue
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < MAX_CODES:
            table[(prefix, k)] = next_code
            next_code += 1
            # the decoder widens its codes once the table reaches the width
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table = {}
            next_code = end + 1
            width = min_code_size + 1
        prefix = k
    if prefix is not None:
        emit(prefix)
    emit(end)
    if n_bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks: a length byte before each piece of at most 255
    bytes, a zero length after the last."""
    out = bytearray()
    for i in range(0, len(data), 255):
        piece = data[i:i + 255]
        out.append(len(piece))
        out += piece
    out.append(0)
    return bytes(out)


def write_gif(path: str, frames: List, duration_ms: int = 100, loop: int = 0) -> None:
    """An animated GIF of `frames` ([H, W, 3] floats in [0, 1] or uint8, all
    of one size): each frame duration_ms long with its own palette, the
    animation repeated `loop` times after the first (0: forever)."""
    frames = [to_uint8(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError(f"write_gif: frames of shapes {sorted({f.shape for f in frames})}, "
                         f"expected one [H, W, 3]")
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0x70, 0, 0)  # no global palette, 8-bit colour
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        palette, idx = quantize(f)
        size_bits = max(1, int(np.ceil(np.log2(max(palette.shape[0], 2)))))
        table = np.zeros((1 << size_bits, 3), np.uint8)
        table[:palette.shape[0]] = palette
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, duration_ms // 10, 0) + b"\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x80 | (size_bits - 1))
        out += table.tobytes()
        min_code = max(2, size_bits)
        out.append(min_code)
        out += _sub_blocks(lzw_encode(idx.reshape(-1).tolist(), min_code))
    out.append(0x3B)
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def gif_frames(path: str) -> Tuple[int, int, int]:
    """(frames, width, height) of a GIF file, read from its blocks: the
    logical screen's size and the count of image descriptors."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path} is not a GIF")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    n = 0

    def skip_blocks(p: int) -> int:
        while data[p]:
            p += data[p] + 1
        return p + 1

    while True:
        tag = data[pos]
        if tag == 0x3B:
            return n, w, h
        if tag == 0x21:  # an extension: its label, then its sub-blocks
            pos = skip_blocks(pos + 2)
        elif tag == 0x2C:
            n += 1
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            pos = skip_blocks(pos + 1)  # the LZW minimum code size, then the data
        else:
            raise ValueError(f"{path}: unknown block 0x{tag:02x} at byte {pos}")
