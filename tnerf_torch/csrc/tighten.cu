// Kernels B3 and B4: occupancy range tightening, and tightening plus the
// per-sample occupancy mask of the tightened span, for sm_90a.
//
// B3 replaces the TPU kernel tnerf/grid/pallas_dda.py:_tighten_kernel
// (:333, wrapper tighten_range_pallas :518); B4 replaces
// _tighten_mask_kernel (:400, wrapper tighten_sample_mask_pallas :439).
// Both run the probe phase of probe.cuh (_probe_tighten :299), a group of
// G lanes per ray.  Python side: tnerf_torch/grid/tighten.py (plain
// versions, the transcription of the scan, the choice of G, wrappers).
//
// B4's second phase tests the occupancy bit at the n midpoints of the
// tightened span, t_s = t0 + dt (s + 0.5) with dt = (t1 - t0) * RN(1 / n)
// (the reference's division by the constant n, as XLA computes it), and
// writes mask[ray, s] = bit(o + d t_s) & (t1 > t0) as one byte per sample,
// each ray's n bytes contiguous (the TPU kernel's samples-major int32
// layout exists for its lanes only).  The group writes its ray's row as a
// byte up to the first 2-byte boundary, 2-byte stores of two samples
// each, then a tail byte; lane l takes stores l, l + G, ..., so the
// group's stores are contiguous.  (4-byte stores of four samples left
// half of a warp idle at n = 64 and were slower on an H100.)  The fused renderer runs B4 at n =
// cdf_bins, where the mask is the CDF placement's bin weights, and at n =
// samples_per_ray, where any(mask) decides which rays are compacted.
//
// What bounds them on an H100.  Neither bytes (B3 reads 32 B and writes
// 8 B per ray, B4 n bytes more) nor f32 operations (the bound of
// chip_smoke.py counts 21 per probe and 19 per midpoint, about 0.7 us at
// the training batch); an empty launch takes 1-2 us of device time on
// its own.  The one-thread-per-ray kernels they replace (commit
// c4b0a44) ran 256 dependent probes per thread, each with four IEEE
// divisions, in 32 to 125 blocks of 8 warps: at most one block per SM, 2
// warps per scheduler, 3-12% of the card's thread slots.  Their time was flat in the number of rays
// (59 us at 8192 rays, 63 at 32,000) and the divisions were half of it (a
// variant that multiplied by reciprocals took 25 and 27 us).  Here:
// - G lanes of one warp per ray, G in {8, 16, 32} chosen by the wrapper
//   (tighten.py:lane_group): enough for B x G threads to fill the card,
//   and at most 8 rounds per pass over the probes; 32 at 256 probes, 16
//   at 64.  Smaller groups measured slower: each group's ballot makes the
//   warp wait for it.  The probes of a ray run side by side;
// - the scan of probe.cuh stops at the first and the last occupied probe;
// - no division in the loop: the probe fraction multiplies by the
//   reciprocal of the probe count and the cell ids by the reciprocal of
//   the cell size, as the reference's XLA computes its divisions by these
//   constants (probe.cuh, coarse.cuh).
// What is left is instruction issue over the probes the scan evaluates,
// and the launch.
//
// Shared memory per block of 256 threads: the 1024-word (4 KB) bitfield,
// staged once per block; every bit test is a shared-memory read, and the
// lanes of a group probe neighbouring cells of one ray, which mostly hit
// one word.
//
// No atomics: two launches are bit-equal.  Bit-exactness with the
// reference is the contract (probe.cuh gives the argument).

#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"
#include "probe.cuh"

namespace {

using tnerf::Coarse;
using tnerf::kWords;
constexpr int kThreads = 256;

// Stage the bitfield; returns RN(1 / probes).
__device__ __forceinline__ float stage(uint32_t* words, const uint32_t* words_in, int probes) {
  for (int i = threadIdx.x; i < kWords; i += kThreads) words[i] = words_in[i];
  __syncthreads();
  return __frcp_rn((float)probes);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
tighten_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ te_in, const float* __restrict__ tx_in,
               const uint32_t* __restrict__ words_in, float* __restrict__ t0_out,
               float* __restrict__ t1_out, int n, Coarse g, int probes, float pad_diag) {
  __shared__ uint32_t words[kWords];
  const float rcp_probes = stage(words, words_in, probes);
  const int r = (blockIdx.x * kThreads + threadIdx.x) / G;
  if (r >= n) return;  // whole groups: a group serves one ray
  const tnerf::LaneGroup<G> lg;
  float t0, t1;
  tnerf::probe_tighten<G>(words, g, rcp_probes, tnerf::load_ray(o, d, r), te_in[r], tx_in[r],
                          probes, pad_diag, lg, t0, t1);
  if (lg.lane == 0) {
    t0_out[r] = t0;
    t1_out[r] = t1;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
tighten_mask_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ te_in, const float* __restrict__ tx_in,
                    const uint32_t* __restrict__ words_in, float* __restrict__ t0_out,
                    float* __restrict__ t1_out, uint8_t* __restrict__ mask_out, int n, Coarse g,
                    int probes, float pad_diag, int n_samples) {
  __shared__ uint32_t words[kWords];
  const float rcp_probes = stage(words, words_in, probes);
  const int r = (blockIdx.x * kThreads + threadIdx.x) / G;
  if (r >= n) return;
  const tnerf::LaneGroup<G> lg;
  const tnerf::RayGeom ray = tnerf::load_ray(o, d, r);
  float t0, t1;
  tnerf::probe_tighten<G>(words, g, rcp_probes, ray, te_in[r], tx_in[r], probes, pad_diag, lg,
                          t0, t1);
  if (lg.lane == 0) {
    t0_out[r] = t0;
    t1_out[r] = t1;
  }

  // Phase 2: the occupancy bit at the midpoints of the tightened span.
  const bool open = t1 > t0;
  const float dt = __fmul_rn(__fsub_rn(t1, t0), __frcp_rn((float)n_samples));
  auto bit = [&](int s) -> uint32_t {
    const float t = __fadd_rn(t0, __fmul_rn(dt, __fadd_rn((float)s, 0.5f)));
    return (open && tnerf::occ_at(words, g, ray, t)) ? 1u : 0u;
  };
  uint8_t* row = mask_out + (size_t)r * n_samples;
  // stores: a byte to a 2-byte boundary, `pairs` 2-byte stores, a tail byte
  const int head = min((int)((uintptr_t)row & 1u), n_samples);
  const int pairs = (n_samples - head) >> 1;
  const int units = n_samples - pairs;
  for (int u = lg.lane; u < units; u += G) {
    if (u >= head && u < head + pairs) {
      const int s = head + 2 * (u - head);
      *reinterpret_cast<uint16_t*>(row + s) = (uint16_t)(bit(s) | (bit(s + 1) << 8));
    } else {
      const int s = u < head ? u : u + pairs;
      row[s] = (uint8_t)bit(s);
    }
  }
}

// coarse.cuh's cell id of n coordinates (chip_smoke.py holds it against the
// plain version's arithmetic, tighten.py:cell_ids, on the card).
__global__ void cell_id_check_kernel(const float* __restrict__ p, int* __restrict__ ids, int n,
                                     float lo, float rcp, int res_c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    ids[i] = tnerf::cell_id(p[i], lo, rcp, res_c);
}

int blocks_for(int n, int group) {
  return (int)(((long long)n * group + kThreads - 1) / kThreads);
}

// the lane groups tighten.py:lane_group chooses
#define TNERF_FOR_GROUP(group, LAUNCH)                                          \
  switch (group) {                                                              \
    case 8: LAUNCH(8); break;                                                   \
    case 16: LAUNCH(16); break;                                                 \
    case 32: LAUNCH(32); break;                                                 \
    default: return (int)cudaErrorInvalidValue;                                 \
  }

}  // namespace

extern "C" int tnerf_tighten_range(const float* o, const float* d, const float* te,
                                   const float* tx, const int32_t* words, float* t0,
                                   float* t1, int n, int res_c, float lo_x, float lo_y,
                                   float lo_z, float rcp_x, float rcp_y, float rcp_z,
                                   int probes, float pad_diag, int group, void* stream) {
  Coarse g{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z};
#define LAUNCH(G)                                                                         \
  tighten_kernel<G><<<blocks_for(n, G), kThreads, 0, (cudaStream_t)stream>>>(            \
      o, d, te, tx, reinterpret_cast<const uint32_t*>(words), t0, t1, n, g, probes, pad_diag)
  TNERF_FOR_GROUP(group, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int tnerf_tighten_sample_mask(const float* o, const float* d, const float* te,
                                         const float* tx, const int32_t* words, float* t0,
                                         float* t1, uint8_t* mask, int n, int n_samples,
                                         int res_c, float lo_x, float lo_y, float lo_z,
                                         float rcp_x, float rcp_y, float rcp_z, int probes,
                                         float pad_diag, int group, void* stream) {
  Coarse g{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z};
#define LAUNCH(G)                                                                         \
  tighten_mask_kernel<G><<<blocks_for(n, G), kThreads, 0, (cudaStream_t)stream>>>(       \
      o, d, te, tx, reinterpret_cast<const uint32_t*>(words), t0, t1, mask, n, g, probes, \
      pad_diag, n_samples)
  TNERF_FOR_GROUP(group, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int tnerf_cell_id_check(const float* p, int* ids, int n, float lo, float rcp,
                                   int res_c, void* stream) {
  cell_id_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(p, ids, n, lo, rcp, res_c);
  return (int)cudaGetLastError();
}
