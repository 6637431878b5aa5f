// Kernel B3: occupancy range tightening, for sm_90a.
//
// Replaces the TPU kernel tnerf/grid/pallas_dda.py:_tighten_kernel
// (wrapper tighten_range_pallas :518, probe phase _probe_tighten :299).
// Python side: tnerf_torch/grid/tighten.py (plain version + wrapper).
//
// What bounds it on an H100: neither bytes nor tensor FLOPs.  It reads
// 32 B and writes 8 B per ray, and does 256 probes of ~40 scalar f32/int
// operations each, so at 32768 rays it is a few microseconds of CUDA-core
// work and launch latency dominates.  The design keeps it there: one
// thread per ray, the 1024-word (4 KB) bitfield staged once per block in
// shared memory so every probe's bit test is a shared-memory read.
//
// Bit-exactness with the reference is the contract: every multiply and
// add is rounded separately (__fmul_rn / __fadd_rn stop nvcc contracting
// them into FMAs) in the reference's association, and the cell test is
// coarse.cuh's occ_bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"

namespace {

using tnerf::Coarse;
using tnerf::kWords;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tighten_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ te_in, const float* __restrict__ tx_in,
               const uint32_t* __restrict__ words_in, float* __restrict__ t0_out,
               float* __restrict__ t1_out, int n, Coarse g, int probes, float pad_diag) {
  __shared__ uint32_t words[kWords];
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) words[i] = words_in[i];
  __syncthreads();
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float te = te_in[r], tx = tx_in[r];
  const float nprobes = (float)probes;
  const float span = fmaxf(__fsub_rn(tx, te), 0.0f);
  const float step = __fdiv_rn(span, nprobes);
  const float big = 3.0e38f;
  float tf = big, tl = -big;
  if (span > 0.0f) {
    for (int i = 0; i < probes; ++i) {
      const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), nprobes);
      const float t = __fadd_rn(te, __fmul_rn(span, frac));
      const float x = __fadd_rn(ox, __fmul_rn(dx, t));
      const float y = __fadd_rn(oy, __fmul_rn(dy, t));
      const float z = __fadd_rn(oz, __fmul_rn(dz, t));
      if (tnerf::occ_bit(words, g, x, y, z)) {
        tf = fminf(tf, t);
        tl = fmaxf(tl, t);
      }
    }
  }
  const bool hit = tl >= tf;
  const float pad = __fadd_rn(step, pad_diag);
  t0_out[r] = hit ? fmaxf(__fsub_rn(tf, pad), te) : te;
  t1_out[r] = hit ? fminf(__fadd_rn(tl, pad), tx) : tx;
}

}  // namespace

extern "C" int tnerf_tighten_range(const float* o, const float* d, const float* te,
                                   const float* tx, const int32_t* words, float* t0,
                                   float* t1, int n, int res_c, float lo_x, float lo_y,
                                   float lo_z, float cell_x, float cell_y, float cell_z,
                                   int probes, float pad_diag, void* stream) {
  Coarse g{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z};
  const int blocks = (n + kThreads - 1) / kThreads;
  tighten_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, te, tx, reinterpret_cast<const uint32_t*>(words), t0, t1, n, g, probes, pad_diag);
  return (int)cudaGetLastError();
}
