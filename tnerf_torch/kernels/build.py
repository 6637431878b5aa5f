"""Build and load the port's CUDA kernels.

Every `tnerf_torch/csrc/*.cu` compiles with `nvcc` for `sm_90a` (one
`nvcc -c` per source, all started together, then one link) into
`tnerf_torch/_build/libtnerf_kernels.so`, a library with a plain C
interface that `ctypes` loads.  No PyTorch headers are involved, so a
build takes seconds.  The library is built at its first use and rebuilt
when a source is newer than it; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import tempfile

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtnerf_kernels.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]  # never --use_fast_math

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PROTOTYPES = {
    # o, d, te, tx, words, t0, t1, n, res_c, lo xyz, 1 / cell xyz, probes, pad_diag, lanes
    # per ray, stream
    "tnerf_tighten_range": [P] * 7 + [I, I] + [F] * 6 + [I, F, I, P],
    # o, d, te, tx, words, t0, t1, mask, n, n_samples, res_c, lo xyz, 1 / cell xyz, probes,
    # pad_diag, lanes per ray, stream
    "tnerf_tighten_sample_mask": [P] * 8 + [I, I, I] + [F] * 6 + [I, F, I, P],
    # p, ids, n, lo, 1 / cell, res_c, stream: coarse.cuh's cell ids of n coordinates
    "tnerf_cell_id_check": [P, P, I, F, F, I, P],
    # w, bias, gamma, beta, te, dt, o, d, mask, words, out, tchk, shaded (both may be null),
    # B, S, n_layers, n_ctas, use_coarse, res_c, lo xyz, 1 / cell xyz, term_eps, stream
    "tnerf_fused_forward": [P] * 13 + [I, I, I, I, I, I] + [F] * 7 + [P],
    # tmode -> CTAs the card holds at once (negative: a cudaError_t)
    "tnerf_fused_forward_max_ctas": [I],
    # x, fast, exact, n, stream: the forward's branch-free sine against sinf
    "tnerf_sin_fast_check": [P, P, P, I, P],
    # w, bias, gamma, beta, te, dt, o, d, mask, words, tchk, gout, dW, dB (int64 sums in
    # fixed point), flag, shaded (may be null), spill (the deep models' scratch; null up to
    # 9 layers), B, S, n_layers, n_ctas, use_coarse, res_c, lo xyz, 1 / cell xyz, term_eps,
    # 2^shift, the bound on a partial in quanta, stream
    "tnerf_fused_backward": [P] * 17 + [I, I, I, I, I, I] + [F] * 9 + [P],
    # n_layers, tmode -> CTAs the card holds at once (negative: a cudaError_t)
    "tnerf_fused_backward_max_ctas": [I, I],
    # o, d_safe, inv_d, te, tx, words (may be null), t0, cell, n, steps, res, cfactor, use_occ,
    # lo xyz, cell xyz, coarse cell xyz, 1 / cell xyz, threads per block, stream
    "tnerf_dda_march": [P] * 8 + [I, I, I, I, I] + [F] * 12 + [I, P],
    # idx, values, n, rows, passes, bits, by value, payload words, tile, keys, payload, keys and
    # payload of the other half, offsets, the cleared region and its bytes, stream
    "tnerf_segment_sort": [P, P] + [I] * 7 + [P] * 6 + [ctypes.c_size_t, P],
    # values, sorted payload, offsets, out, rows, F, feature lanes, entry lanes, rows per block,
    # by value, stream
    "tnerf_segment_sum": [P] * 4 + [I] * 6 + [P],
}
# per-sample placement: ts, dts [B, S] in the place of te, dt [B]
PROTOTYPES["tnerf_fused_forward_tmode"] = PROTOTYPES["tnerf_fused_forward"]
PROTOTYPES["tnerf_fused_backward_tmode"] = PROTOTYPES["tnerf_fused_backward"]


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tnerf_torch need the CUDA toolkit")
    return found


def stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources() + glob.glob(os.path.join(CSRC, "*.cuh")))


def build(verbose: bool = False) -> str:
    """Compile every source (one nvcc each, all started together) and link
    the library; returns its path.  The compilers' output is kept in
    `build.log`; verbose=True adds ptxas's registers / shared-memory
    report to it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [cc, *ARCH, *FLAGS, *extra, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, log = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            objs.append(obj)
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([cc, *ARCH, "-shared", *objs, "-o", tmp_lib],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, LIB_PATH)
    build.log = "".join(log)
    return LIB_PATH


build.log = ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if missing or stale)."""
    if stale():
        build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in PROTOTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on the cudaError_t a launch function returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on `device`:
    a kernel reads raw pointers and trusts all four."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )
