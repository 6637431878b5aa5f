// Kernel B5: the grid walk (3-D DDA) of the intervals renderer, for sm_90a.
//
// Replaces the TPU kernel tnerf/grid/pallas_dda.py:_dda_kernel (:61; wrappers
// march_pallas_raw :151, traverse_grid_pallas :232).  Python side:
// tnerf_torch/grid/dda.py (march_raw, its plain version march_raw_plain and
// traverse_grid_dda).
//
// Per ray an Amanatides-Woo walk of `steps` steps over the res^3 grid.  Each
// step writes the depth at which it starts and the flat id (ix res + iy) res
// + iz of the cell it crosses, or -1.  With occupancy, a step inside an
// occupied coarse cell crosses one fine cell; inside an empty coarse cell it
// jumps to that coarse cell's exit plane and derives the cell it lands in
// from the position just beyond.  Without occupancy every cell counts as
// occupied (the dense walk).
//
// What bounds it on an H100: bytes.  A ray reads 44 B once and writes 8 B per
// step, against about 60 scalar operations per step, so at 384 steps the
// stores are the cost.  The design follows: one thread per ray, the walk's
// state (t, ix, iy, iz) in registers, the coarse bitfield (at most 32^3 bits,
// 4 KB) staged once per block in shared memory, and a steps-major output so
// that the 32 rays of a warp store 128 contiguous bytes per step.  Nothing
// of the TPU kernel's [8, 128] ray tiles, its padding of the rays to 1024 or
// its 128-word limit is carried over.
//
// Rounding decides cells: a one-ulp change of a crossing depth flips the tie
// rule (x before y before z) and so the cell sequence.  Every product, sum
// and quotient is rounded separately (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn keep nvcc from contracting them into FMAs), in the reference's
// association, with a true division by the cell size, so the kernel is
// bit-equal to march_raw_plain.  Float-to-int conversions saturate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 1024;  // 32^3 coarse bits

struct DdaGrid {
  int res, cfactor, cres;
  float lo[3], h[3], ch[3];  // box corner, fine cell size, coarse cell size
};

__device__ __forceinline__ int floor_div(int a, int f) {
  return a >= 0 ? a / f : -((f - 1 - a) / f);
}

// floor((o + d t - lo) / h), saturating
__device__ __forceinline__ int cell_of(float o, float d, float t, float lo, float h) {
  return __float2int_rd(__fdiv_rn(__fsub_rn(__fadd_rn(o, __fmul_rn(d, t)), lo), h));
}

// depth at which the ray crosses plane number k (cell size h) of one axis
__device__ __forceinline__ float plane_t(int k, float lo, float h, float o, float inv) {
  return __fmul_rn(__fsub_rn(__fadd_rn(lo, __fmul_rn((float)k, h)), o), inv);
}

__device__ __forceinline__ int clampi(int v, int a, int b) { return min(max(v, a), b); }

template <bool kOcc>
__global__ void __launch_bounds__(kThreads)
dda_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ inv_d, const float* __restrict__ te_in,
           const float* __restrict__ tx_in, const uint32_t* __restrict__ words_in,
           float* __restrict__ t0_out, int32_t* __restrict__ cell_out, int n, int steps,
           DdaGrid g) {
  __shared__ uint32_t words[kOcc ? kMaxWords : 1];
  if (kOcc) {
    const int n_words = (g.cres * g.cres * g.cres + 31) >> 5;
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = words_in[i];
    __syncthreads();
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float ivx = inv_d[3 * r], ivy = inv_d[3 * r + 1], ivz = inv_d[3 * r + 2];
  const float te = te_in[r], tx = tx_in[r];
  const bool hit_box = tx > te;
  const int px = ivx > 0.0f, py = ivy > 0.0f, pz = ivz > 0.0f;
  const int sx = 2 * px - 1, sy = 2 * py - 1, sz = 2 * pz - 1;
  const float eps = 1e-6f;
  const int res = g.res;

  const float t_in = __fadd_rn(te, eps);
  int ix = clampi(cell_of(ox, dx, t_in, g.lo[0], g.h[0]), 0, res - 1);
  int iy = clampi(cell_of(oy, dy, t_in, g.lo[1], g.h[1]), 0, res - 1);
  int iz = clampi(cell_of(oz, dz, t_in, g.lo[2], g.h[2]), 0, res - 1);
  float t_cur = te;

  for (int s = 0; s < steps; ++s) {
    const float txn = plane_t(ix + px, g.lo[0], g.h[0], ox, ivx);
    const float tyn = plane_t(iy + py, g.lo[1], g.h[1], oy, ivy);
    const float tzn = plane_t(iz + pz, g.lo[2], g.h[2], oz, ivz);
    const float t_fine = fminf(txn, fminf(tyn, tzn));
    const bool inb = ix >= 0 && ix < res && iy >= 0 && iy < res && iz >= 0 && iz < res;
    bool c_occ = inb;
    float t_step = t_fine;
    if (kOcc) {
      const int cx = floor_div(ix, g.cfactor), cy = floor_div(iy, g.cfactor),
                cz = floor_div(iz, g.cfactor);
      const int cflat = clampi((cx * g.cres + cy) * g.cres + cz, 0,
                               g.cres * g.cres * g.cres - 1);
      c_occ = ((words[cflat >> 5] >> (cflat & 31)) & 1u) && inb;
      const float ctx = plane_t(cx + px, g.lo[0], g.ch[0], ox, ivx);
      const float cty = plane_t(cy + py, g.lo[1], g.ch[1], oy, ivy);
      const float ctz = plane_t(cz + pz, g.lo[2], g.ch[2], oz, ivz);
      const float t_coarse = fminf(ctx, fminf(cty, ctz));
      t_step = c_occ ? t_fine : fmaxf(t_coarse, __fadd_rn(t_cur, eps));
    }
    const bool valid = fminf(t_step, tx) > __fadd_rn(t_cur, 1e-7f) && hit_box && c_occ;
    const size_t at = (size_t)s * (size_t)n + (size_t)r;
    t0_out[at] = t_cur;
    cell_out[at] = valid ? (ix * res + iy) * res + iz : -1;

    const bool fx = c_occ && txn <= tyn && txn <= tzn;  // ties: x before y before z
    const bool fy = c_occ && !fx && tyn <= tzn;
    const bool fz = c_occ && !fx && !fy;
    if (kOcc && !c_occ) {
      const float tj = __fadd_rn(t_step, eps);
      ix = clampi(cell_of(ox, dx, tj, g.lo[0], g.h[0]), -1, res);
      iy = clampi(cell_of(oy, dy, tj, g.lo[1], g.h[1]), -1, res);
      iz = clampi(cell_of(oz, dz, tj, g.lo[2], g.h[2]), -1, res);
    } else {
      ix = fx ? ix + sx : ix;
      iy = fy ? iy + sy : iy;
      iz = fz ? iz + sz : iz;
    }
    t_cur = fmaxf(t_cur, t_step);
  }
}

}  // namespace

// o, d (the directions with |d| < 1e-12 replaced), inv_d = 1 / d: [n, 3];
// te, tx: [n]; words: the coarse bitfield (bit i of word i / 32, flat index
// (x cres + y) cres + z), read only if use_occ; t0, cell: [steps, n].
extern "C" int tnerf_dda_march(const float* o, const float* d, const float* inv_d,
                               const float* te, const float* tx, const int32_t* words,
                               float* t0, int32_t* cell, int n, int steps, int res, int cfactor,
                               int use_occ, float lo_x, float lo_y, float lo_z, float h_x,
                               float h_y, float h_z, float ch_x, float ch_y, float ch_z,
                               void* stream) {
  DdaGrid g{res, cfactor, res / cfactor, {lo_x, lo_y, lo_z}, {h_x, h_y, h_z}, {ch_x, ch_y, ch_z}};
  if (use_occ && (g.cres > 32 || g.cres * cfactor != res)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  if (use_occ)
    dda_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(o, d, inv_d, te, tx, w, t0,
                                                                      cell, n, steps, g);
  else
    dda_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(o, d, inv_d, te, tx, w, t0,
                                                                       cell, n, steps, g);
  return (int)cudaGetLastError();
}
