// Kernel B5: the grid walk (3-D DDA) of the intervals renderer, for sm_90a.
//
// Replaces the TPU kernel tnerf/grid/pallas_dda.py:_dda_kernel (:61; wrappers
// march_pallas_raw :151, traverse_grid_pallas :232).  Python side:
// tnerf_torch/grid/dda.py (march_raw, its plain version march_raw_plain,
// traverse_grid_dda and block_shape, which sizes the launch).
//
// Per ray an Amanatides-Woo walk of `steps` steps over the res^3 grid.  Each
// step writes the depth at which it starts and the flat id (ix res + iy) res
// + iz of the cell it crosses, or -1.  With occupancy, a step inside an
// occupied coarse cell crosses one fine cell; inside an empty coarse cell it
// jumps to that coarse cell's exit plane and derives the cell it lands in
// from the position just beyond.  Without occupancy every cell counts as
// occupied (the dense walk).
//
// One thread per ray.  The walk is a serial recurrence in (t, ix, iy, iz),
// and bit-equality with the reference fixes the order of its operations, so
// a ray's steps cannot be split between threads; the state lives in
// registers for the whole walk.
//
// What bounds it on an H100 depends on the shape.
// - The intervals training batch (4096 rays x 49 steps at 16^3) and an eval
//   view (16,384 rays): latency.  4096 threads are one warp per SM at most,
//   so each warp waits on its own dependent chain, step after step.  The
//   first version (commit cbff516) gave 256 rays to a block, so 16 of the
//   132 SMs worked, and its chain ran about 1300 cycles a step: a correctly
//   rounded division for every cell id, an integer division by the coarse
//   factor per axis, and a branch around the jump that a warp runs on both
//   sides.  Here: the host sizes the block (block_shape) so that every SM
//   has one at the training batch; a cell id multiplies by the reciprocal of
//   the cell size, as the reference's XLA computes its division by that
//   constant (computed once on the host); a power-of-two coarse factor is a
//   shift; and the step is branch-free: both the fine step and the jump are
//   computed and one is selected, so the chain is the longer of the two
//   (the crossing depths, the coarse bit from shared memory, the jump's
//   cell ids), not their sum.
// - 640,000 rays x 384 steps at 128^3, dense: bytes.  A ray reads 44 B once
//   and writes 8 B per step, so the stores are the cost (2 GB).  The output
//   is steps-major, so the rays of a warp store contiguous bytes per step,
//   and the stores are streaming (__stcs): the output is not read back by
//   the kernel and should not evict its inputs from L2.
//
// The coarse bitfield (at most 32^3 bits, 4 KB) is staged once per block in
// shared memory while the block loads its rays; every step reads one word.
// Nothing of the TPU kernel's [8, 128] ray tiles, its padding of the rays to
// 1024 or its 128-word limit is carried over.
//
// Rounding decides cells: a one-ulp change of a crossing depth flips the tie
// rule (x before y before z) and so the cell sequence.  Every product and
// sum is rounded separately (__fmul_rn / __fadd_rn / __fsub_rn keep nvcc
// from contracting them into FMAs), in the reference's association, so the
// kernel is bit-equal to march_raw_plain, which is bit-equal to the
// reference kernel.  Float-to-int conversions saturate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWords = 1024;  // 32^3 coarse bits

struct DdaGrid {
  int res, cfactor, cshift, cres;  // cshift: log2(cfactor), or -1 if not a power of two
  float lo[3], h[3], ch[3], rcp[3];  // box corner, fine and coarse cell size, 1 / h
};

// floor(i / cfactor) for i >= -1
__device__ __forceinline__ int coarse_of(int i, const DdaGrid& g) {
  if (g.cshift >= 0) return i >> g.cshift;  // arithmetic shift: -1 stays -1
  return i >= 0 ? i / g.cfactor : -((g.cfactor - 1 - i) / g.cfactor);
}

// floor((o + d t - lo) * rcp), saturating: the reference's (p - lo) / h
__device__ __forceinline__ int cell_of(float o, float d, float t, float lo, float rcp) {
  return __float2int_rd(__fmul_rn(__fsub_rn(__fadd_rn(o, __fmul_rn(d, t)), lo), rcp));
}

// depth at which the ray crosses plane number k (cell size h) of one axis
__device__ __forceinline__ float plane_t(int k, float lo, float h, float o, float inv) {
  return __fmul_rn(__fsub_rn(__fadd_rn(lo, __fmul_rn((float)k, h)), o), inv);
}

__device__ __forceinline__ int clampi(int v, int a, int b) { return min(max(v, a), b); }

// a streaming store: the kernel never reads its output back
template <class T>
__device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }

template <bool kOcc>
__global__ void __launch_bounds__(kMaxThreads)
dda_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ inv_d, const float* __restrict__ te_in,
           const float* __restrict__ tx_in, const uint32_t* __restrict__ words_in,
           float* __restrict__ t0_out, int32_t* __restrict__ cell_out, int n, int steps,
           DdaGrid g) {
  __shared__ uint32_t words[kOcc ? kMaxWords : 1];
  if (kOcc) {
    const int n_words = (g.cres * g.cres * g.cres + 31) >> 5;
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = __ldg(words_in + i);
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int rr = min(r, n - 1);  // the last block's spare threads load a real ray
  const float ox = o[3 * rr], oy = o[3 * rr + 1], oz = o[3 * rr + 2];
  const float dx = d[3 * rr], dy = d[3 * rr + 1], dz = d[3 * rr + 2];
  const float ivx = inv_d[3 * rr], ivy = inv_d[3 * rr + 1], ivz = inv_d[3 * rr + 2];
  const float te = te_in[rr], tx = tx_in[rr];
  if (kOcc) __syncthreads();
  if (r >= n) return;
  const bool hit_box = tx > te;
  const int px = ivx > 0.0f, py = ivy > 0.0f, pz = ivz > 0.0f;
  const int sx = 2 * px - 1, sy = 2 * py - 1, sz = 2 * pz - 1;
  const float eps = 1e-6f;
  const int res = g.res;
  const int n_coarse = g.cres * g.cres * g.cres;

  const float t_in = __fadd_rn(te, eps);
  int ix = clampi(cell_of(ox, dx, t_in, g.lo[0], g.rcp[0]), 0, res - 1);
  int iy = clampi(cell_of(oy, dy, t_in, g.lo[1], g.rcp[1]), 0, res - 1);
  int iz = clampi(cell_of(oz, dz, t_in, g.lo[2], g.rcp[2]), 0, res - 1);
  float t_cur = te;
  float* t0_at = t0_out + r;
  int32_t* cell_at = cell_out + r;

  for (int s = 0; s < steps; ++s, t0_at += n, cell_at += n) {
    const float txn = plane_t(ix + px, g.lo[0], g.h[0], ox, ivx);
    const float tyn = plane_t(iy + py, g.lo[1], g.h[1], oy, ivy);
    const float tzn = plane_t(iz + pz, g.lo[2], g.h[2], oz, ivz);
    const float t_fine = fminf(txn, fminf(tyn, tzn));
    const bool inb = (unsigned)ix < (unsigned)res && (unsigned)iy < (unsigned)res &&
                     (unsigned)iz < (unsigned)res;
    bool c_occ = inb;
    float t_step = t_fine;
    int jx = 0, jy = 0, jz = 0;
    if (kOcc) {
      const int cx = coarse_of(ix, g), cy = coarse_of(iy, g), cz = coarse_of(iz, g);
      const int cflat = clampi((cx * g.cres + cy) * g.cres + cz, 0, n_coarse - 1);
      c_occ = ((words[cflat >> 5] >> (cflat & 31)) & 1u) && inb;
      const float ctx = plane_t(cx + px, g.lo[0], g.ch[0], ox, ivx);
      const float cty = plane_t(cy + py, g.lo[1], g.ch[1], oy, ivy);
      const float ctz = plane_t(cz + pz, g.lo[2], g.ch[2], oz, ivz);
      const float t_jump = fmaxf(fminf(ctx, fminf(cty, ctz)), __fadd_rn(t_cur, eps));
      // the cell just beyond the jump, computed on every lane (no branch)
      const float tj = __fadd_rn(t_jump, eps);
      jx = clampi(cell_of(ox, dx, tj, g.lo[0], g.rcp[0]), -1, res);
      jy = clampi(cell_of(oy, dy, tj, g.lo[1], g.rcp[1]), -1, res);
      jz = clampi(cell_of(oz, dz, tj, g.lo[2], g.rcp[2]), -1, res);
      t_step = c_occ ? t_fine : t_jump;
    }
    const bool valid = fminf(t_step, tx) > __fadd_rn(t_cur, 1e-7f) && hit_box && c_occ;
    store(t0_at, t_cur);
    store(cell_at, valid ? (ix * res + iy) * res + iz : -1);

    const bool fx = txn <= tyn && txn <= tzn;  // ties: x before y before z
    const bool fy = !fx && tyn <= tzn;
    const bool fz = !fx && !fy;
    if (kOcc) {
      ix = c_occ ? (fx ? ix + sx : ix) : jx;
      iy = c_occ ? (fy ? iy + sy : iy) : jy;
      iz = c_occ ? (fz ? iz + sz : iz) : jz;
    } else {
      // c_occ = inb: a walk outside the box stays where it is
      ix = c_occ && fx ? ix + sx : ix;
      iy = c_occ && fy ? iy + sy : iy;
      iz = c_occ && fz ? iz + sz : iz;
    }
    t_cur = fmaxf(t_cur, t_step);
  }
}

}  // namespace

// o, d (the directions with |d| < 1e-12 replaced), inv_d = 1 / d: [n, 3];
// te, tx: [n]; words: the coarse bitfield (bit i of word i / 32, flat index
// (x cres + y) cres + z), read only if use_occ; t0, cell: [steps, n];
// threads: rays per block (grid/dda.py:block_shape).
extern "C" int tnerf_dda_march(const float* o, const float* d, const float* inv_d,
                               const float* te, const float* tx, const int32_t* words,
                               float* t0, int32_t* cell, int n, int steps, int res, int cfactor,
                               int use_occ, float lo_x, float lo_y, float lo_z, float h_x,
                               float h_y, float h_z, float ch_x, float ch_y, float ch_z,
                               float rcp_x, float rcp_y, float rcp_z, int threads,
                               void* stream) {
  int cshift = -1;
  for (int k = 0; k < 31; ++k)
    if ((1 << k) == cfactor) cshift = k;
  DdaGrid g{res, cfactor, cshift, res / cfactor, {lo_x, lo_y, lo_z}, {h_x, h_y, h_z},
            {ch_x, ch_y, ch_z}, {rcp_x, rcp_y, rcp_z}};
  if (use_occ && (g.cres > 32 || g.cres * cfactor != res)) return (int)cudaErrorInvalidValue;
  if (threads < 1 || threads > kMaxThreads || n < 1 || steps < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + threads - 1) / threads;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  if (use_occ)
    dda_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(o, d, inv_d, te, tx, w, t0,
                                                                     cell, n, steps, g);
  else
    dda_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(o, d, inv_d, te, tx, w, t0,
                                                                      cell, n, steps, g);
  return (int)cudaGetLastError();
}
