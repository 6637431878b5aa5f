#!/usr/bin/env python3
"""Write variants of B2's fixed-point reduction (tnerf_torch/csrc/
fused_backward.cu, `red_fixed` / `red_partial`) into directories of their
own, each a copy of csrc/ with one edit, for timing against the committed
kernel in one process:

    python3 tools/torch_b2_red_variants.py _dev/red
    python3 tools/torch_b2_spill_cost.py --old noadd=_dev/red/noadd \\
        --old noconv=_dev/red/noconv --old pairs=_dev/red/pairs \\
        --old sectors=_dev/red/sectors --old swap2=_dev/red/swap2 \\
        --old slices=_dev/red/slices

- noadd: every partial converted and checked, nothing added (what the
  conversions cost);
- noconv: the adds without the conversion (the float's bits, sign-extended,
  added in place of the rounded integer; the same entries skipped);
- pairs: the adds as the wgmma fragment holds them, every other column of
  a row per instruction (no lane exchange: half of each 32-byte sector an
  instruction touches);
- sectors: the adds in whole sectors without the exchange (lane m adds
  its pair at columns m and 4 + m: the entries land in the wrong places;
  what the exchange costs);
- swap2: the first packed version, two exchanges (m with m ^ 1, then with
  m ^ 2) where one does;
- slices: the scheme that repeats only on a fixed grid, in place of the
  fixed-point adds of dW: each CTA adds its tiles' f32 partials into a
  private slice of a [132, 17, 128, 129] f32 array in device memory (one
  read and one write of eight bytes a lane, whole sectors; 78 MB at 9
  layers), zeroed before the launch, and a second kernel sums the slices
  over the CTAs in a fixed order (the bias stays fixed point).
Their gradients are wrong (slices: written as f32 bits into the int64
sums); only their times are read.
"""

import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tnerf_torch", "csrc")

ADD = '  if (q != 0) asm volatile("red.global.add.u64 [%0], %1;\\n" ::"l"(p), "l"(q) : "memory");'
CONV = "  const long long q = __float2ll_rn(y);"
EXCHANGE = """  unsigned long long* p0 = p + (high ? got : own);  // columns 0 .. 3 of the eight
  unsigned long long* p1 = p + (high ? own : got);  // columns 4 .. 7
  bool over = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = f[4 * i + 2 * h], b = f[4 * i + 2 * h + 1];
      const float y = __shfl_xor_sync(0xffffffffu, b, 2);
      const size_t at = (size_t)8 * h * kLanes + 8 * i;
      red_fixed(p0 + at, high ? y : a, scale, limit, over);
      red_fixed(p1 + at, high ? a : y, scale, limit, over);"""
PAIRS = """  p += 2 * m;
  bool over = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = f[4 * i + 2 * h], b = f[4 * i + 2 * h + 1];
      const size_t at = (size_t)8 * h * kLanes + 8 * i;
      red_fixed(p + at, a, scale, limit, over);
      red_fixed(p + at + 1, b, scale, limit, over);"""
SECTORS = """  bool over = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = f[4 * i + 2 * h], b = f[4 * i + 2 * h + 1];
      const size_t at = (size_t)8 * h * kLanes + 8 * i;
      red_fixed(p + at + m, a, scale, limit, over);
      red_fixed(p + at + 4 + m, b, scale, limit, over);"""
SWAP2 = """  unsigned long long* p1 = p + 4 + m;
  p += m;
  const bool odd = lane & 1;
  bool over = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = f[4 * i + 2 * h], b = f[4 * i + 2 * h + 1];
      const float x = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
      const float u = odd ? x : a, v = odd ? b : x;
      const float y = __shfl_xor_sync(0xffffffffu, high ? u : v, 2);
      const size_t at = (size_t)8 * h * kLanes + 8 * i;
      red_fixed(p + at, high ? y : u, scale, limit, over);
      red_fixed(p1 + at, high ? v : y, scale, limit, over);"""
RED_PARTIAL = """__device__ __forceinline__ void red_partial(unsigned long long* dw, const float (&f)[32], int k0,"""
SLICES = """constexpr size_t kSlice = 17 * 128 * 129;  // floats of a CTA's slice, up to 17 layers
__device__ float g_slices[132 * kSlice];
__device__ unsigned long long* g_dw;  // the launch's dW sums: slice offsets count from it

__global__ void sum_slices(float* out, int n, int n_ctas) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_ctas; ++c) s += g_slices[(size_t)c * kSlice + e];
  out[e] = s;
}

__device__ __forceinline__ void red_partial(unsigned long long* dw, const float (&f)[32], int k0,
                                           int n0, int lane, float, float, uint32_t*) {
  float* s = g_slices + (size_t)blockIdx.x * kSlice +
             ((dw + (size_t)(k0 + (lane >> 2)) * kLanes + n0 + 2 * (lane & 3)) - g_dw);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = f[4 * i + 2 * h], b = f[4 * i + 2 * h + 1];
      if (a != 0.f || b != 0.f) {
        float2* t = reinterpret_cast<float2*>(s + (size_t)8 * h * kLanes + 8 * i);
        float2 v = *t;
        v.x += a;
        v.y += b;
        *t = v;
      }
    }
}

__device__ __forceinline__ void red_partial_unused(unsigned long long* dw, const float (&f)[32], int k0,"""
LAUNCH = """  kernel<<<n_ctas, kThreads, smem, (cudaStream_t)stream>>>("""
SLICES_LAUNCH = """  float* slices = nullptr;
  cudaGetSymbolAddress(reinterpret_cast<void**>(&slices), g_slices);
  cudaMemcpyToSymbolAsync(g_dw, &dW, sizeof(dW), 0, cudaMemcpyHostToDevice, (cudaStream_t)stream);
  cudaMemset2DAsync(slices, kSlice * 4, 0, (size_t)n_layers * 128 * 128 * 4, n_ctas,
                    (cudaStream_t)stream);
  kernel<<<n_ctas, kThreads, smem, (cudaStream_t)stream>>>("""
RETURN = """      cg, term_eps, grad_scale, grad_limit);
  return (int)cudaGetLastError();"""
SLICES_RETURN = """      cg, term_eps, grad_scale, grad_limit);
  const int n = n_layers * 128 * 128;
  sum_slices<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(reinterpret_cast<float*>(dW), n,
                                                                 n_ctas);
  return (int)cudaGetLastError();"""

VARIANTS = {
    "noadd": [(ADD, "  if (q == 0x7fffffffffffffffLL) atomicOr(reinterpret_cast<unsigned int*>(p), 1u);")],
    "noconv": [(CONV, "  const long long q = (long long)__float_as_int(y);")],
    "pairs": [(EXCHANGE, PAIRS)],
    "sectors": [(EXCHANGE, SECTORS)],
    "swap2": [(EXCHANGE, SWAP2)],
    "slices": [(RED_PARTIAL, SLICES), (LAUNCH, SLICES_LAUNCH), (RETURN, SLICES_RETURN)],
}


def main() -> int:
    out = sys.argv[1]
    with open(os.path.join(CSRC, "fused_backward.cu")) as fh:
        src = fh.read()
    for name, edits in VARIANTS.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit's anchor is not in fused_backward.cu once")
            text = text.replace(old, new)
        with open(os.path.join(d, "fused_backward.cu"), "w") as fh:
            fh.write(text)
        print(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
