// Kernels B3 and B4: occupancy range tightening, and tightening plus the
// per-sample occupancy mask of the tightened span, for sm_90a.
//
// B3 replaces the TPU kernel tnerf/grid/pallas_dda.py:_tighten_kernel
// (wrapper tighten_range_pallas :518); B4 replaces _tighten_mask_kernel
// (:400, wrapper tighten_sample_mask_pallas :439).  Both run the probe phase
// of probe.cuh (_probe_tighten :299).  Python side:
// tnerf_torch/grid/tighten.py (plain versions + wrappers).
//
// B4's second phase tests the occupancy bit at the n midpoints of the
// tightened span, t_s = t0 + dt (s + 0.5) with dt = (t1 - t0) / n, and
// writes mask[ray, s] = bit(o + d t_s) & (t1 > t0) as one byte per sample,
// each ray's n bytes contiguous (the TPU kernel's samples-major int32
// layout exists for its lanes only).  The fused renderer runs it at
// n = cdf_bins, where the mask is the CDF placement's bin weights, and at
// n = samples_per_ray, where any(mask) decides which rays are compacted.
//
// What bounds them on an H100: neither bytes nor tensor FLOPs.  B3 reads
// 32 B and writes 8 B per ray (B4 n more), and does 256 probes (B4 n more)
// of ~40 scalar f32/int operations each, so at 32768 rays they are a few
// microseconds of CUDA-core work and launch latency dominates.  The design
// keeps it there: one thread per ray, the 1024-word (4 KB) bitfield staged
// once per block in shared memory so every bit test is a shared-memory
// read; B4 packs four mask bytes into one 32-bit store where n allows.
//
// Bit-exactness with the reference is the contract: every multiply and
// add is rounded separately in the reference's association (probe.cuh),
// and the cell test is coarse.cuh's occ_bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"
#include "probe.cuh"

namespace {

using tnerf::Coarse;
using tnerf::kWords;
constexpr int kThreads = 256;

__device__ __forceinline__ void stage_words(uint32_t* words, const uint32_t* words_in) {
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) words[i] = words_in[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tighten_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ te_in, const float* __restrict__ tx_in,
               const uint32_t* __restrict__ words_in, float* __restrict__ t0_out,
               float* __restrict__ t1_out, int n, Coarse g, int probes, float pad_diag) {
  __shared__ uint32_t words[kWords];
  stage_words(words, words_in);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float t0, t1;
  tnerf::probe_tighten(words, g, tnerf::load_ray(o, d, r), te_in[r], tx_in[r], probes, pad_diag,
                       t0, t1);
  t0_out[r] = t0;
  t1_out[r] = t1;
}

__global__ void __launch_bounds__(kThreads)
tighten_mask_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ te_in, const float* __restrict__ tx_in,
                    const uint32_t* __restrict__ words_in, float* __restrict__ t0_out,
                    float* __restrict__ t1_out, uint8_t* __restrict__ mask_out, int n, Coarse g,
                    int probes, float pad_diag, int n_samples) {
  __shared__ uint32_t words[kWords];
  stage_words(words, words_in);
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const tnerf::RayGeom ray = tnerf::load_ray(o, d, r);
  float t0, t1;
  tnerf::probe_tighten(words, g, ray, te_in[r], tx_in[r], probes, pad_diag, t0, t1);
  t0_out[r] = t0;
  t1_out[r] = t1;

  // Phase 2: the occupancy bit at the midpoints of the tightened span.
  const bool open = t1 > t0;
  const float dt = __fdiv_rn(__fsub_rn(t1, t0), (float)n_samples);
  auto bit = [&](int s) -> uint32_t {
    const float t = __fadd_rn(t0, __fmul_rn(dt, __fadd_rn((float)s, 0.5f)));
    return (open && tnerf::occ_at(words, g, ray, t)) ? 1u : 0u;
  };
  uint8_t* row = mask_out + (size_t)r * n_samples;
  if ((n_samples & 3) == 0) {  // rows are 4-byte aligned: one store per four samples
    uint32_t* row4 = reinterpret_cast<uint32_t*>(row);
    for (int s = 0; s < n_samples; s += 4)
      row4[s >> 2] = bit(s) | (bit(s + 1) << 8) | (bit(s + 2) << 16) | (bit(s + 3) << 24);
  } else {
    for (int s = 0; s < n_samples; ++s) row[s] = (uint8_t)bit(s);
  }
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

extern "C" int tnerf_tighten_sample_mask(const float* o, const float* d, const float* te,
                                         const float* tx, const int32_t* words, float* t0,
                                         float* t1, uint8_t* mask, int n, int n_samples,
                                         int res_c, float lo_x, float lo_y, float lo_z,
                                         float cell_x, float cell_y, float cell_z, int probes,
                                         float pad_diag, void* stream) {
  Coarse g{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z};
  const int blocks = (n + kThreads - 1) / kThreads;
  tighten_mask_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, te, tx, reinterpret_cast<const uint32_t*>(words), t0, t1, mask, n, g, probes,
      pad_diag, n_samples);
  return (int)cudaGetLastError();
}
