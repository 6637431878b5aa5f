"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a
request for the card on a machine without one raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:N" or "cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain PyTorch "
            "versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Hold TF32 off for float32 matrix products on the card while the
    block runs, and put the process's setting back afterwards: the plain
    versions emulate bf16 x bf16 -> f32 with f32 products, which TF32's
    10-bit mantissa would break."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
