// Kernel B2: backward of the fused frequency-encode + MLP + composite
// renderer onto the packed weights and biases, for sm_90a.
//
// Replaces the TPU kernel tnerf/render/pallas_fused2.py:_bwd_kernel (:438,
// built by make_fused_trainable :582).  Python side:
// tnerf_torch/render/fused.py (fused_backward_plain + wrapper + the
// autograd Function).  Given the forward's inputs, the transmittance
// `tchk` at which each ray enters each chunk of kBwdRows samples (saved by
// the forward kernel) and the cotangent `gout` [B, 6] of (r, g, b, acc,
// depth, T_final), it adds dL/dW [NL, 128, 128] (in-major, as W) and
// dL/dBias [NL, 128] into zeroed int64 sums in fixed point (below).  Per
// tile, chunks last to first:
//   1. mask = mask_in * coarse_bit, and the forward kernel's skip rule: a
//      chunk whose rays were all at or below term_eps when the forward
//      entered its (128-sample) chunk, or that has no live sample, was not
//      shaded and gets no gradient;
//   2. the chunk's forward again (encoding, placement, coarse test and head
//      activations as B1, fused.cuh), keeping every layer's bf16 input;
//   3. the compositing VJP:  dw = g_r r + g_g g + g_b b + g_acc + g_dep t,
//      G = dw w, dtau = -suffix(G) + dw T0 E e^-tau - gT T0 Texp,
//      dsig = dtau dt mask, dsraw = dsig (1 - e^-sig), d{r,g,b}pre =
//      w g_c c (1 - c), and the carry gT <- sum(dw E F) + gT Texp toward
//      earlier chunks, starting from gout[:, 5];
//   4. the MLP backward, last layer first: gb = bf16(g); dW[l] += a_in^T gb
//      and dBias[l] += colsum(gb), each tile's partial formed in f32;
//      g = (gb @ W[l]^T) * (a_in > 0).
// No gradient reaches gamma, beta, the ray or the mask (as on the TPU).
// Per-sample placement (the TPU kernel's tmode=True) is the kernel's second
// instantiation: depth ts[ray, s] and step dts[ray, s] take the place of
// te + (s + 0.5) dt and dt (fused.cuh:Placement), so dsig = dtau dts mask;
// ts and dts get no gradient either.
//
// What bounds it on an H100: the tensor cores do 26 products of 64 x 128 x
// 128 per 64-row tile (forward again, weight gradient, input gradient):
// 54.5 MFLOP, 7.4 us of one SM at the card's 989 TFLOP/s.  Against that,
// per tile: 16 weight tiles of 32 KB to bring in, and a partial dW of
// 16,384 entries per layer to add into one int64 sum shared by every SM.
//
// Design (redesigned for Hopper; the first version ran mma.sync from
// padded rows and restaged both weight orientations per layer):
// - Products on wgmma.  Two consumer warpgroups split each product: the
//   forward a @ W and the input gradient g @ W^T by output column halves,
//   the weight gradient a^T g by input-feature halves.  Every tile is held
//   once, unpadded, in the 128-byte swizzled layout of hopper.cuh; wgmma
//   reads a layer input K-major for the forward and MN-major for the weight
//   gradient, the gradient tile K-major for the input gradient and
//   MN-major for the weight gradient, and the one weight tile (in-major,
//   as W) MN-major for the forward and K-major for the input gradient.
//   ReLU' comes from the stored bf16 layer input.  The layer-0 input (the
//   encoding) is not stored: the forward reads it from the gradient tile,
//   which is free then, and layer 0's weight gradient recomputes it.  The
//   gradient at layer m's output goes into the slot of layer m + 2's input
//   (free once layer m + 2 is done), so a layer needs one block barrier,
//   not two; only the last two layers' gradients share the gradient tile.
// - Weights by TMA.  The grid is persistent, one CTA per SM (the occupancy
//   query's count); CTA k takes tiles k, k + n_ctas, ...  Each layer's
//   32 KB weight tile comes into a two-slot ring by TMA (128-byte swizzle,
//   the layout wgmma reads), issued by one thread as soon as a slot is
//   released, so the load of the next layer's tile overlaps this layer's
//   products.  Every chunk walks the same sequence of weight tiles; a
//   chunk the skip rule drops walks it without computing.  Multicasting
//   each load to a thread-block cluster was built and measured first
//   (PERF.md, section 6): the CTAs of a cluster must then release every slot
//   together, and that lockstep cost more than the L2 reads it saves
//   (4.30 ms at 8 CTAs a cluster, 4.11 at 4, 3.44 at 2, 2.87 without).
// - The dW reduction, in 64-bit fixed point.  The reference adds each
//   block's weight gradient into one dW held in VMEM across a sequential
//   grid, so its gradient is the same on every run.  Here every CTA adds
//   its tiles' partials into one sum in device memory, in no fixed order,
//   so the adds must not depend on order: each element of a warp's f32
//   partial (and each tile's bias column sum) is scaled by 2^shift (exact),
//   rounded once to an integer (__float2ll_rn) and added with
//   red.global.add.u64 into an int64 sum, skipped where it rounds to zero
//   (dead ReLU units, masked samples, the head's unused columns).  Integer
//   addition is associative, so the sums, and the f32 gradient the wrapper
//   makes of them, are the same bits for any order of adds, grid size or
//   tile-to-CTA schedule.  The wrapper picks shift (render/fused.py
//   GRAD_SHIFT = 40: a quantum of 2^-40 = 9.1e-13, 1e-4 of Adam's eps, a
//   range of +-2^23 = 8.4e6, where the first 100 steps of the prims, CDF
//   and 13-layer runs kept every sum under 0.2 and every partial under
//   7.3e-5: tools/torch_grad_range.py, PERF.md) and the
//   bound `grad_limit` on one partial in quanta, 2^62 over the launch's
//   (tile, chunk) count rounded up to a power of two, so no sum can wrap.
//   A partial beyond it, or not finite, sets the flag word to a quiet
//   NaN's bits instead, which the wrapper turns into a non-finite gradient.
//   The L2 serves these atomics by the 32-byte sector, and PTX has no
//   vector form of a 64-bit integer red: an int64 entry is twice the bytes
//   of the f32 it replaced, so the adds go out a whole sector at a time
//   (`red_partial`); even so B2 takes about 30% longer than with f32
//   red.global.add.v4 of the same partials, which do not repeat (PERF.md,
//   section 6, with the variants measured: every other column per add,
//   private per-CTA f32 slices).
//   Reductions inside a cluster over distributed shared memory were
//   measured first and dropped (PERF.md): with every SM reducing at once,
//   red.shared::cluster took 57 us per tile and layer, ordered
//   st.shared::cluster with a fixed-order sum 9.2 us, red.global.add.v4.f32
//   4.6 us, a cluster barrier alone 0.7 us.  The adds are issued as soon as
//   the layer's products are done (issuing them under the next layer's
//   products measured slower).
// - The compositing VJP runs on the tile's 64 rows (two warps); its scans
//   along a ray (exclusive tau sum, suffix sum of G, sum of dw E F) are
//   segmented warp scans (__shfl_*) with a carry across the two warps.
//
// - Depth past shared memory.  A tile keeps at most kResident = 8 layer
//   inputs in shared memory (MAX_BWD_LAYERS - 1 in render/fused.py).  A
//   deeper model (the kDeep instantiation) keeps its last kResident inputs
//   there and spills each of the n_spilled = NL - 9 earlier ones, 16 KB of
//   a 64 x 128 tile as wgmma reads it, to a per-CTA scratch in device
//   memory during the forward recompute (one cp.async.bulk store by thread
//   0, its shared-memory read waited at the end of the layer that reads the
//   input); the grid is
//   persistent, so the scratch is [n_ctas, NL - 9, 64, 128] bf16 (17 MB at
//   NL = 17 on 132 CTAs, inside the 50 MB L2), allocated by the caller.
//   The backward brings input l - 1 back by cp.async.bulk on an mbarrier as
//   layer l starts, so the copy overlaps layer l's products.  Inputs and
//   gradients rotate through four of the slots below the resident ones
//   (`slot`): input v, and the gradient at layer v - 2's output, lie in
//   slot (v - NL + 8) mod 4 for v <= NL - 5, which is free by the time
//   either is written.  Biases of layers past the ninth are read from
//   global memory.  A chunk the skip rule drops stores and reloads nothing.
//
// Shared memory at NL = 9, and at every deeper NL (232,448 bytes a block
// can have):
//   layer inputs 1..8: 8 x 16,384 = 131,072; gradient tile 16,384; weight
//   ring 2 x 32,768 = 65,536; biases 4,608, coarse words 4,096, per-row
//   scalars, head, bias column sums and mbarriers 4,640; alignment slack
//   1,024: 227,360 in all.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"
#include "fused.cuh"
#include "hopper.cuh"

namespace {

using namespace tnerf::hopper;
using tnerf::Coarse;
using tnerf::kLanes;

constexpr int kRows = tnerf::kBwdRows;  // sample rows per tile
constexpr int kFwdRows = 128;           // the forward kernel's chunk, its skip granularity
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kTileBytes = kRows * kLanes * 2;
constexpr int kWBytes = kLanes * kLanes * 2;
constexpr int kMaxSmem = 232448;  // bytes a block can have on sm_90
constexpr int kMaxLayers = 9;     // layers whose inputs all stay resident (MAX_BWD_LAYERS)
constexpr int kResident = kMaxLayers - 1;  // layer inputs of a tile in shared memory
constexpr int kRing = 4;                   // slots the spilled inputs rotate through
// Built with -DTNERF_NO_SPILL (for tools/torch_b2_spill_cost.py only) the
// kernel leaves out its traffic to and from the scratch: the same products
// and slots, the spill's cost taken away, a wrong gradient past 9 layers.
#ifdef TNERF_NO_SPILL
constexpr bool kSpill = false;
#else
constexpr bool kSpill = true;
#endif

static_assert(kRows == 64 && kLanes == 128, "the wgmma tilings below assume 64 x 128 tiles");

struct Fixed {
  float bias[kMaxLayers][kLanes];  // layers 0..8; deeper ones from global memory
  uint32_t words[tnerf::kWords];  // coarse bitfield
  float head[kRows][4];  // last layer's lanes 0..3, raw
  float t[kRows], m[kRows], step[kRows], buf[kRows];
  float T0[kRows], gT[kRows];  // per ray of the tile
  float colsum[2][2][kLanes];  // bias gradient of two layers in turn, row halves
  uint64_t full[2];            // weight slot holds its load (TMA bytes arrived)
  uint64_t reload[2];          // a spilled layer input is back in its slot (reloads in turn)
};

static_assert(kResident >= kRing, "a spilled input's slot must be free one layer ahead");

constexpr size_t smem_bytes(int n_layers) {
  const int slots = n_layers > kMaxLayers ? kResident : (n_layers > 1 ? n_layers - 1 : 1);
  return 1024 + (size_t)(slots + 1) * kTileBytes + 2 * (size_t)kWBytes + sizeof(Fixed);
}

// Inclusive scan of v over segments of `ch` rows of the tile, by threads
// 0..63 (row = thread), forward or (kRev) from the segment's end; `buf`
// ends up holding every row's result.  Named barrier 1.
template <bool kRev>
__device__ __forceinline__ float seg_scan(float v, int row, int ch, float* buf) {
  const int lane = row & 31, seg = row / ch;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = kRev ? __shfl_down_sync(0xffffffffu, v, off) : __shfl_up_sync(0xffffffffu, v, off);
    const bool in = kRev ? (lane + off < 32 && (row + off) / ch == seg)
                         : (lane >= off && (row - off) / ch == seg);
    if (in) v += u;
  }
  buf[row] = v;
  named_sync(1, kRows);
  // carry across the two warps: row 31's (forward) or row 32's (reverse)
  // partial belongs to this row's segment when the segment straddles them
  if (kRev ? (row < 32 && 32 / ch == seg) : (row >= 32 && 31 / ch == seg)) v += buf[kRev ? 32 : 31];
  named_sync(1, kRows);
  buf[row] = v;
  named_sync(1, kRows);
  return v;
}

// The flag word once a partial is out of range: a quiet NaN read as float32.
constexpr uint32_t kFlagNaN = 0x7fc00000u;

// x added into the int64 sum at p in fixed point: rounded once to a
// multiple of 1 / scale (scale = 2^shift, an exact multiply), nothing added
// where that is zero; `over` set where |x| scale exceeds `limit` or is not
// finite.
__device__ __forceinline__ void red_fixed(unsigned long long* p, float x, float scale,
                                          float limit, bool& over) {
  const float y = x * scale;
  over |= !(fabsf(y) <= limit);
  const long long q = __float2ll_rn(y);
  if (q != 0) asm volatile("red.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(q) : "memory");
}

// dW rows k0 + (lane / 4) (+ 8 h), columns n0 + 8 i + 2 m (+ 1) hold
// f[4 i + 2 h] (f[4 i + 2 h + 1]), m = lane % 4: added into the fixed-point
// sums a whole 32-byte sector at a time.  The four lanes of a row hold its
// eight columns in pairs; lanes m and m ^ 2 trade their second columns, so
// that the first add of each (i, h) covers columns 0 .. 3 (lanes 0, 1
// their own first columns, lanes 2, 3 the second columns of lanes 0, 1)
// and the second add columns 4 .. 7.  The L2 serves atomics by the sector:
// adding the pairs as they lie (every other column per instruction)
// measured twice the cost (PERF.md).
__device__ __forceinline__ void red_partial(unsigned long long* dw, const float (&f)[32], int k0,
                                           int n0, int lane, float scale, float limit,
                                           uint32_t* flag) {
  const int m = lane & 3;
  const bool high = m & 2;
  const int own = 2 * m, got = 2 * (m ^ 2) + 1;  // this lane's first column, the traded second
  unsigned long long* p = dw + (size_t)(k0 + (lane >> 2)) * kLanes + n0;
  unsigned long long* p0 = p + (high ? got : own);  // columns 0 .. 3 of the eight
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
      red_fixed(p1 + at, high ? a : y, scale, limit, over);
    }
  if (over) atomicOr(flag, kFlagNaN);
}

// The backward products of one layer for this warpgroup, issued and
// committed as one straight-line group: e = g @ W^T over the first kKt
// 16-wide steps of the contraction (kIg), f0 / f1 = a^T g for dW columns
// 0..63 / 64..127 (f1 only if kFull), over the tile's 64 rows.
template <bool kIg, int kKt, bool kFull>
__device__ __forceinline__ void bwd_products(float (&e)[32], float (&f0)[32], float (&f1)[32],
                                             const unsigned char* a, const unsigned char* g,
                                             const unsigned char* w, int wg) {
  wgmma_fence();
  if constexpr (kIg) {
#pragma unroll
    for (int kk = 0; kk < kKt; ++kk)
      wgmma_m64n64k16<0, 0>(e, desc(smem_u32(g + (kk >> 2) * kBlockBytes + (kk & 3) * 32)),
                            desc(smem_u32(w + ((kk >> 2) * 2 + wg) * kBlockBytes + (kk & 3) * 32)),
                            kk);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc(smem_u32(a + wg * kBlockBytes + kk * 2048));
    wgmma_m64n64k16<1, 1>(f0, da, desc(smem_u32(g + kk * 2048)), kk);
    if constexpr (kFull) wgmma_m64n64k16<1, 1>(f1, da, desc(smem_u32(g + kBlockBytes + kk * 2048)), kk);
  }
  wgmma_commit();
}

// g at layer l - 1's output into `gn`: e = g @ W[l]^T (this warpgroup's
// 64 input features) times ReLU' of layer l's stored input `a`, in bf16.
__device__ __forceinline__ void relu_grad(unsigned char* gn, const unsigned char* a,
                                          const float (&e)[32], int wg, int r0, int cq) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 64 * wg + 8 * i + cq;
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(a + tile_offset(r0, col));
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(a + tile_offset(r0 + 8, col));
    *reinterpret_cast<__nv_bfloat162*>(gn + tile_offset(r0, col)) =
        __floats2bfloat162_rn(__low2float(lo) > 0.f ? e[4 * i] : 0.f,
                              __high2float(lo) > 0.f ? e[4 * i + 1] : 0.f);
    *reinterpret_cast<__nv_bfloat162*>(gn + tile_offset(r0 + 8, col)) =
        __floats2bfloat162_rn(__low2float(hi) > 0.f ? e[4 * i + 2] : 0.f,
                              __high2float(hi) > 0.f ? e[4 * i + 3] : 0.f);
  }
  fence_async_smem();
}

// The weight-tile sequence of one chunk: layers 0..NL-1 for the forward,
// then NL-2..1 for the input gradients (layer NL-1's tile is still held).
__device__ __forceinline__ int load_layer(int j, int n_layers) {
  return j < n_layers ? j : 2 * n_layers - 2 - j;
}

// Layer 0's input, the encoding of the tile's rows, into `dst` (a [64][128]
// tile), by 256 threads: a thread keeps one feature pair for all its rows,
// so it reads (gamma, beta) once for each ray of the tile.
template <bool kTmode>
__device__ __forceinline__ void encode_tile(unsigned char* dst, const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            const tnerf::Placement<kTmode>& place,
                                            const float* t_row, int tid, int c, int ch, int R,
                                            int ray0, int B, int S) {
  const int f = (tid & 63) * 2;
  int cached = -1;
  float2 g = make_float2(0.f, 0.f), b = g;
  for (int row = tid >> 6; row < kRows; row += 4) {
    const int j = row / ch, s = c * ch + row % ch, ray = ray0 + j;
    float v0 = 0.f, v1 = 0.f;
    if (j < R && ray < B && s < S) {
      if (ray != cached) {
        g = *reinterpret_cast<const float2*>(gamma + (size_t)ray * kLanes + f);
        b = *reinterpret_cast<const float2*>(beta + (size_t)ray * kLanes + f);
        cached = ray;
      }
      const float u = place.abscissa(s, t_row[row]);
      v0 = tnerf::encode_feature(g.x, b.x, u, f);
      v1 = tnerf::encode_feature(g.y, b.y, u, f + 1);
    }
    *reinterpret_cast<__nv_bfloat162*>(dst + tile_offset(row, f)) = __floats2bfloat162_rn(v0, v1);
  }
}

template <bool kTmode, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
fused_backward_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const tnerf::Placement<kTmode> place, const float* __restrict__ o,
                      const float* __restrict__ d, const float* __restrict__ mask,
                      const uint32_t* __restrict__ words, const float* __restrict__ tchk,
                      const float* __restrict__ gout, unsigned long long* __restrict__ dW,
                      unsigned long long* __restrict__ dB, uint32_t* __restrict__ flag,
                      uint8_t* __restrict__ shaded, unsigned char* __restrict__ spill, int B,
                      int S, int n_layers, int use_coarse, Coarse cg, float term_eps,
                      float grad_scale, float grad_limit) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int n_slots = kDeep ? kResident : (n_layers > 1 ? n_layers - 1 : 1);
  // layer inputs 1..n_spilled go to the scratch, the others stay; 0 at
  // compile time up to 9 layers, so no deep-only step is left in that code
  const int n_spilled = kDeep ? n_layers - 1 - kResident : 0;
  unsigned char* acts = base;                                  // layer inputs
  unsigned char* gt = base + (size_t)n_slots * kTileBytes;     // gradient tile (encoding in the forward)
  unsigned char* wring = gt + kTileBytes;                      // two weight slots
  Fixed& sm = *reinterpret_cast<Fixed*>(wring + 2 * kWBytes);
  // Layer v's input (v >= 1): slot v - 1, or with spilled inputs slot
  // v - n_spilled - 1 for a resident one and the ring of slots 0..3 below.
  auto slot = [&](int v) {
    const int k = v - n_spilled - 1;
    return acts + (size_t)(kDeep && k < 0 ? k & (kRing - 1) : k) * kTileBytes;
  };
  // This CTA's scratch tile of spilled input v.
  auto spilled = [&](int v) {
    return spill + ((size_t)blockIdx.x * n_spilled + (v - 1)) * kTileBytes;
  };
  // Where the gradient at layer m's output lies: the gradient tile for the
  // last two layers, else the slot of layer m + 2's input, free by then.
  auto g_at = [&](int m) { return m >= n_layers - 2 ? gt : slot(m + 2); };
  // Layer 0's input for its weight gradient: the gradient tile once the
  // gradient has moved to the slots, else slot 0.
  unsigned char* enc = n_layers > 2 ? gt : acts;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, w4 = (tid >> 5) & 3;
  const int r0 = 16 * w4 + (lane >> 2), cq = 2 * (lane & 3);  // accumulator rows r0, r0 + 8
  const int ch = S < kRows ? S : kRows;  // samples per ray per chunk
  const int R = kRows / ch;              // rays per tile
  const int n_tiles = (B + R - 1) / R;
  const int n_chunks = (S + ch - 1) / ch;
  const int fch = S < kFwdRows ? S : kFwdRows;
  const int my_tiles = (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int per_chunk = n_layers + (n_layers > 2 ? n_layers - 2 : 0);
  const long long n_loads = (long long)my_tiles * n_chunks * per_chunk;

  auto issue = [&](long long i) {  // one thread: load i into its slot
    const int layer = load_layer((int)(i % per_chunk), n_layers), s = (int)(i & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)  // column half h: rows 0..127, blocks (0, h), (1, h)
      tma_load(wring + s * kWBytes + h * 2 * kBlockBytes, &wmap, h * 64, layer * kLanes,
               &sm.full[s]);
  };
  auto acquire = [&](long long i) { mbar_wait(&sm.full[i & 1], (uint32_t)((i >> 1) & 1)); };
  // After a __syncthreads that follows the last read of load i's slot:
  // the slot takes load i + 2.
  auto release = [&](long long i) {
    if (tid != 0 || i + 2 >= n_loads) return;
    mbar_expect_tx(&sm.full[i & 1], kWBytes);
    issue(i + 2);
  };

  if (tid == 0) {
    prefetch_tensormap(&wmap);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    if (n_spilled > 0) {
      mbar_init(&sm.reload[0], 1);
      mbar_init(&sm.reload[1], 1);
    }
    fence_mbar_init();
    for (int s = 0; s < 2 && s < n_loads; ++s) {
      mbar_expect_tx(&sm.full[s], kWBytes);
      issue(s);
    }
  }
  for (int i = tid; i < (n_layers < kMaxLayers ? n_layers : kMaxLayers) * kLanes; i += kThreads)
    sm.bias[i / kLanes][i % kLanes] = bias[i];
  if (use_coarse)
    for (int i = tid; i < tnerf::kWords; i += kThreads) sm.words[i] = words[i];
  __syncthreads();

  long long li = 0;     // index of the chunk's first weight load
  uint32_t reloads = 0;  // spilled inputs brought back by earlier chunks
  // Reload j (layer v's input is the chunk's (n_spilled - v)-th) completes
  // on barrier j % 2 in its phase j / 2: reload j + 2 is issued a block
  // barrier after every thread has waited for reload j.
  auto reload_id = [&](int v) { return reloads + (uint32_t)(n_spilled - v); };
  for (int tile = (int)blockIdx.x; tile < n_tiles; tile += (int)gridDim.x) {
    const int ray0 = tile * R;
    for (int j = tid; j < kRows; j += kThreads)
      sm.gT[j] = (j < R && ray0 + j < B) ? gout[(size_t)(ray0 + j) * 6 + 5] : 0.f;

    for (int c = n_chunks - 1; c >= 0; --c, li += per_chunk) {
      // Phase 1: per-row depth and mask, per-ray entry transmittance, the skip rule.
      bool any = false, live = false;
      if (tid < kRows) {
        const int row = tid, j = row / ch, s = c * ch + row % ch, ray = ray0 + j;
        float m = 0.f, t = 0.f, step = 0.f;
        if (j < R && ray < B && s < S) {
          place.sample(ray, s, S, t, step);
          m = mask[(size_t)ray * S + s];
          if (use_coarse && m != 0.f) {
            const float x = __fadd_rn(o[3 * ray], __fmul_rn(t, d[3 * ray]));
            const float y = __fadd_rn(o[3 * ray + 1], __fmul_rn(t, d[3 * ray + 1]));
            const float z = __fadd_rn(o[3 * ray + 2], __fmul_rn(t, d[3 * ray + 2]));
            m = tnerf::occ_bit(sm.words, cg, x, y, z) ? m : 0.f;
          }
        }
        sm.t[row] = t;
        sm.m[row] = m;
        sm.step[row] = step;
        any = m != 0.f;
        if (row < R) {
          float T0 = 0.f;
          if (ray0 + row < B) {
            const float* tc = tchk + (size_t)(ray0 + row) * n_chunks;
            T0 = tc[c];
            // T at which the forward kernel entered its chunk holding this one
            live = tc[((c * ch) / fch) * fch / ch] > term_eps;
          }
          sm.T0[row] = T0;
        }
      }
      const bool any_sample = __syncthreads_or(any);
      const bool compute = any_sample && __syncthreads_or(live);
      if (shaded != nullptr && tid < R && ray0 + tid < B)
        shaded[(size_t)(ray0 + tid) * n_chunks + c] = compute ? 1 : 0;

      // Phase 2: encode the tile's rows into the gradient tile (layer 0's input).
      if (compute) {
        encode_tile(gt, gamma, beta, place, sm.t, tid, c, ch, R, ray0, B, S);
        fence_async_smem();
      }
      __syncthreads();

      // Phase 3: the forward MLP, keeping every layer's input.
      for (int l = 0; l < n_layers; ++l) {
        acquire(li + l);
        if (compute && (l + 1 < n_layers || wg == 0)) {  // the head's lanes 0..3 are warpgroup 0's
          const unsigned char* a = l == 0 ? gt : slot(l);
          const unsigned char* w = wring + ((li + l) & 1) * kWBytes;
          float acc[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_m64n64k16<0, 1>(acc, desc(smem_u32(a + (kk >> 2) * kBlockBytes + (kk & 3) * 32)),
                                  desc(smem_u32(w + (wg * 2 + (kk >> 2)) * kBlockBytes + (kk & 3) * 2048)),
                                  kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          const float* bl = kDeep && l >= kMaxLayers ? bias + (size_t)l * kLanes : sm.bias[l];
          if (l + 1 < n_layers) {
            unsigned char* out = slot(l + 1);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = 64 * wg + 8 * i + cq;
              const float b0 = bl[col], b1 = bl[col + 1];
              *reinterpret_cast<__nv_bfloat162*>(out + tile_offset(r0, col)) = __floats2bfloat162_rn(
                  fmaxf(acc[4 * i] + b0, 0.f), fmaxf(acc[4 * i + 1] + b1, 0.f));
              *reinterpret_cast<__nv_bfloat162*>(out + tile_offset(r0 + 8, col)) = __floats2bfloat162_rn(
                  fmaxf(acc[4 * i + 2] + b0, 0.f), fmaxf(acc[4 * i + 3] + b1, 0.f));
            }
            fence_async_smem();
          } else if ((lane & 3) < 2) {
            sm.head[r0][cq] = acc[0] + bl[cq];
            sm.head[r0][cq + 1] = acc[1] + bl[cq + 1];
            sm.head[r0 + 8][cq] = acc[2] + bl[cq];
            sm.head[r0 + 8][cq + 1] = acc[3] + bl[cq + 1];
          }
        }
        // a spilled input's slot is written again four layers on: its store
        // has read it once this layer, the last to read it, is done
        if (kSpill && compute && tid == 0 && l >= 1 && l <= n_spilled) bulk_wait_all<true>();
        __syncthreads();
        if (l + 1 < n_layers) release(li + l);  // the last layer's tile serves its input gradient
        if (kSpill && compute && tid == 0 && l + 1 <= n_spilled) {
          bulk_store(spilled(l + 1), slot(l + 1), kTileBytes);
          bulk_commit();
        }
      }
      if (n_layers == 1) release(li);

      // Phase 4: the compositing VJP on the tile's rows (threads 0..63):
      // the gradient at the last layer's output into the gradient tile.
      if (compute && tid < kRows) {
        const int row = tid, j = row / ch, ray = ray0 + j;
        const bool valid = j < R && ray < B && c * ch + row % ch < S;
        const int last_row = valid ? (j + 1) * ch - 1 : row;  // the ray's last row in the tile
        float cr = 0.f, cgr = 0.f, cb = 0.f, sig = 0.f, tau = 0.f, dt = 0.f, T0 = 0.f;
        float gr = 0.f, gg = 0.f, gbl = 0.f, ga = 0.f, gd = 0.f;
        if (valid) {  // (a) head activations and optical depth
          cr = tnerf::sigmoidf(sm.head[row][0]);
          cgr = tnerf::sigmoidf(sm.head[row][1]);
          cb = tnerf::sigmoidf(sm.head[row][2]);
          sig = tnerf::density_softplus(sm.head[row][3]);
          dt = sm.step[row];
          tau = __fmul_rn(__fmul_rn(sig, dt), sm.m[row]);
          const float* go = gout + (size_t)ray * 6;
          gr = go[0];
          gg = go[1];
          gbl = go[2];
          ga = go[3];
          gd = go[4];
          T0 = sm.T0[j];
        }
        // (b) exclusive sums of tau along the ray, and its total
        const float incl = seg_scan<false>(tau, row, ch, sm.buf);
        const float total = sm.buf[last_row];
        // (c) weights and their cotangent
        const float E = expf(-(incl - tau)), emt = expf(-tau), F = 1.f - emt;
        const float Texp = expf(-total);
        const float w = T0 * E * F;
        const float dw = valid ? gr * cr + gg * cgr + gbl * cb + ga + gd * sm.t[row] : 0.f;
        const float G = dw * w;
        // (d) suffix sums of G (exclusive), and sum of dw E F along the ray
        named_sync(1, kRows);  // every row has read buf
        const float suf = seg_scan<true>(G, row, ch, sm.buf) - G;
        named_sync(1, kRows);
        seg_scan<false>(dw * E * F, row, ch, sm.buf);
        const float sef = sm.buf[last_row];
        const float gTj = sm.gT[j < R ? j : 0];
        // (e) gradient at the last layer's output, bf16
        float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
        if (valid) {
          const float dtau = -suf + dw * (T0 * E * emt) - gTj * (T0 * Texp);
          const float dsig = dtau * dt * sm.m[row];
          q3 = dsig * (1.f - expf(-sig));
          q0 = (w * gr) * cr * (1.f - cr);
          q1 = (w * gg) * cgr * (1.f - cgr);
          q2 = (w * gbl) * cb * (1.f - cb);
        }
        const __nv_bfloat162 p01 = __floats2bfloat162_rn(q0, q1), p23 = __floats2bfloat162_rn(q2, q3);
        uint4 first;
        first.x = *reinterpret_cast<const uint32_t*>(&p01);
        first.y = *reinterpret_cast<const uint32_t*>(&p23);
        first.z = first.w = 0u;
        *reinterpret_cast<uint4*>(gt + tile_offset(row, 0)) = first;
#pragma unroll
        for (int cc = 1; cc < kLanes / 8; ++cc)
          *reinterpret_cast<uint4*>(gt + tile_offset(row, 8 * cc)) = make_uint4(0u, 0u, 0u, 0u);
        fence_async_smem();
        named_sync(1, kRows);  // every row has read gT
        if (valid && row % ch == 0) sm.gT[j] = sef + gTj * Texp;  // carry to the earlier chunk
      }
      __syncthreads();

      // Phase 5: the MLP backward, last layer first.
      if (kSpill && n_spilled > 0 && compute && tid == 0) {  // the spilled inputs are in the scratch
        bulk_wait_all<false>();
        fence_async_all();
      }
      for (int l = n_layers - 1; l >= 0; --l) {
        const bool last = l == n_layers - 1;  // only columns 0..3 of g are set
        const long long wl = last ? li + n_layers - 1 : li + 2 * n_layers - 2 - l;
        // layer l - 1's input back from the scratch while this layer runs:
        // its slot last held layer l + 3's input and layer l + 1's gradient
        if (kSpill && compute && tid == 0 && l - 1 >= 1 && l - 1 <= n_spilled) {
          const uint32_t j = reload_id(l - 1);
          fence_async_smem();
          mbar_expect_tx(&sm.reload[j & 1], kTileBytes);
          bulk_load(slot(l - 1), spilled(l - 1), kTileBytes, &sm.reload[j & 1]);
        }
        if (kSpill && compute && l >= 1 && l <= n_spilled) {
          const uint32_t j = reload_id(l);
          mbar_wait(&sm.reload[j & 1], (j >> 1) & 1);
        }
        if (l > 0 && !last) acquire(wl);
        if (l == 0 && compute) {  // layer 0's input, the encoding, again
          encode_tile(enc, gamma, beta, place, sm.t, tid, c, ch, R, ray0, B, S);
          fence_async_smem();
          __syncthreads();
        }
        // the next gradient goes to another tile, except from the last
        // layer, where it overwrites this one once every warp has read it
        unsigned char* g = g_at(l);
        unsigned char* gn = l > 0 ? g_at(l - 1) : g;
        const bool apart = gn != g;
        float e[32], f0[32], f1[32];
        if (compute) {
          const unsigned char* a = l == 0 ? enc : slot(l);
          const unsigned char* w = wring + (wl & 1) * kWBytes;
          if (l > 0 && last)  // the head: g has 4 columns, one contraction step
            bwd_products<true, 1, false>(e, f0, f1, a, g, w, wg);
          else if (l > 0)
            bwd_products<true, 8, true>(e, f0, f1, a, g, w, wg);
          else if (last)
            bwd_products<false, 0, false>(e, f0, f1, a, g, w, wg);
          else
            bwd_products<false, 0, true>(e, f0, f1, a, g, w, wg);
          {  // bias gradient: column sums of g while the products run
            const int col = tid & (kLanes - 1), h = tid >> 7;
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            if (!last || col < 4)
#pragma unroll
              for (int r = 0; r < 32; ++r)
                part[r & 3] += __bfloat162float(
                    *reinterpret_cast<const __nv_bfloat16*>(g + tile_offset(32 * h + r, col)));
            sm.colsum[l & 1][h][col] = (part[0] + part[1]) + (part[2] + part[3]);
          }
          wgmma_wait<0>();
          fence_regs(e);
          fence_regs(f0);
          fence_regs(f1);
          unsigned long long* dwl = dW + (size_t)l * kLanes * kLanes;
          red_partial(dwl, f0, 64 * wg + 16 * w4, 0, lane, grad_scale, grad_limit, flag);
          if (!last)
            red_partial(dwl, f1, 64 * wg + 16 * w4, 64, lane, grad_scale, grad_limit, flag);
          // g at layer l - 1's output, into another tile: no barrier first
          if (l > 0 && apart) relu_grad(gn, slot(l), e, wg, r0, cq);
        }
        __syncthreads();  // every read of g and W is done; the next g and the column sums are written
        if (l > 0) release(wl);
        if (compute && tid < kLanes) {
          bool over = false;
          red_fixed(dB + l * kLanes + tid, sm.colsum[l & 1][0][tid] + sm.colsum[l & 1][1][tid],
                    grad_scale, grad_limit, over);
          if (over) atomicOr(flag, kFlagNaN);
        }
        if (l > 0 && !apart) {
          if (compute) relu_grad(gn, slot(l), e, wg, r0, cq);
          __syncthreads();  // g rewritten
        }
      }
      if (compute) reloads += n_spilled;
    }
  }
}

// The kernel for n_layers: the instantiation with spilled inputs past
// kMaxLayers.  Up to kMaxLayers the kernel is compiled with none (n_spilled
// = 0 at compile time): one instantiation for every depth measured 3.5%
// slower at 9 layers (PERF.md, PR 14).
template <bool kTmode>
auto kernel_for(int n_layers) {
  return n_layers > kMaxLayers ? fused_backward_kernel<kTmode, true>
                               : fused_backward_kernel<kTmode, false>;
}

// CTAs of the kernel the card holds at once (negative: a CUDA error).
template <bool kTmode>
int max_ctas(int n_layers) {
  const size_t smem = smem_bytes(n_layers);
  if (n_layers < 1 || smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
  const auto kernel = kernel_for<kTmode>(n_layers);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

template <bool kTmode>
int launch_backward(const void* w, const float* bias, const float* gamma, const float* beta,
                    const tnerf::Placement<kTmode>& place, const float* o, const float* d,
                    const float* mask, const int32_t* words, const float* tchk,
                    const float* gout, unsigned long long* dW, unsigned long long* dB,
                    uint32_t* flag, uint8_t* shaded, void* spill, int B, int S, int n_layers,
                    int n_ctas, int use_coarse, const Coarse& cg, float term_eps,
                    float grad_scale, float grad_limit, void* stream) {
  const size_t smem = smem_bytes(n_layers);
  if (n_layers < 1 || smem > kMaxSmem || n_ctas < 1 ||
      (n_layers > kMaxLayers && spill == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  const int map_err = weight_map(&wmap, w, n_layers);
  if (map_err != (int)cudaSuccess) return map_err;
  const auto kernel = kernel_for<kTmode>(n_layers);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_ctas, kThreads, smem, (cudaStream_t)stream>>>(
      wmap, bias, gamma, beta, place, o, d, mask, reinterpret_cast<const uint32_t*>(words), tchk,
      gout, dW, dB, flag, shaded, static_cast<unsigned char*>(spill), B, S, n_layers, use_coarse,
      cg, term_eps, grad_scale, grad_limit);
  return (int)cudaGetLastError();
}

}  // namespace

// CTAs of the kernel the card holds at once for n_layers (uniform placement
// if tmode == 0); negative: minus a cudaError_t.
extern "C" int tnerf_fused_backward_max_ctas(int n_layers, int tmode) {
  return tmode ? max_ctas<true>(n_layers) : max_ctas<false>(n_layers);
}

// dW, dB: zeroed int64 sums of the gradient times grad_scale (= 2^shift);
// flag: a zeroed word, set to a quiet NaN's bits where a partial exceeds
// grad_limit quanta or is not finite.
extern "C" int tnerf_fused_backward(const void* w, const float* bias, const float* gamma,
                                    const float* beta, const float* te, const float* dt,
                                    const float* o, const float* d, const float* mask,
                                    const int32_t* words, const float* tchk, const float* gout,
                                    unsigned long long* dW, unsigned long long* dB,
                                    uint32_t* flag, uint8_t* shaded, void* spill, int B, int S,
                                    int n_layers, int n_ctas, int use_coarse, int res_c,
                                    float lo_x, float lo_y, float lo_z, float rcp_x, float rcp_y,
                                    float rcp_z, float term_eps, float grad_scale,
                                    float grad_limit, void* stream) {
  return launch_backward<false>(w, bias, gamma, beta, {te, dt, nullptr, nullptr}, o, d, mask,
                                words, tchk, gout, dW, dB, flag, shaded, spill, B, S, n_layers,
                                n_ctas, use_coarse,
                                Coarse{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z}, term_eps,
                                grad_scale, grad_limit, stream);
}

// Per-sample placement: ts, dts [B, S] in the place of te, dt [B].
extern "C" int tnerf_fused_backward_tmode(const void* w, const float* bias, const float* gamma,
                                          const float* beta, const float* ts, const float* dts,
                                          const float* o, const float* d, const float* mask,
                                          const int32_t* words, const float* tchk,
                                          const float* gout, unsigned long long* dW,
                                          unsigned long long* dB, uint32_t* flag,
                                          uint8_t* shaded, void* spill, int B, int S,
                                          int n_layers, int n_ctas, int use_coarse, int res_c,
                                          float lo_x, float lo_y, float lo_z, float rcp_x,
                                          float rcp_y, float rcp_z, float term_eps,
                                          float grad_scale, float grad_limit, void* stream) {
  return launch_backward<true>(w, bias, gamma, beta, {nullptr, nullptr, ts, dts}, o, d, mask,
                               words, tchk, gout, dW, dB, flag, shaded, spill, B, S, n_layers,
                               n_ctas, use_coarse,
                               Coarse{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z}, term_eps,
                               grad_scale, grad_limit, stream);
}
