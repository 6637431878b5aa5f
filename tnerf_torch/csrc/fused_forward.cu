// Kernel B1: fused frequency-encode + MLP + composite forward, for sm_90a.
//
// Replaces the TPU kernel tnerf/render/pallas_fused2.py:_fwd_kernel (:350,
// called at :646, built by make_fused_trainable :582).  Python side:
// tnerf_torch/render/fused.py (plain version + wrapper).  What it computes,
// per ray and sample s (t = te + (s + 0.5) dt):
//   feature f = act_f(gamma_f + (s + 0.5) beta_f), act = identity for
//     f < 5 and sin otherwise, rounded to bf16;
//   (per-sample placement, the TPU kernel's tmode=True, is the kernel's
//   second instantiation: t = ts[ray, s], feature f = act_f(gamma_f + t
//   beta_f) with (gamma, beta) folded at (0, 1), and dts[ray, s] in dt's
//   place below; fused.cuh:Placement holds the difference)
//   NL - 1 hidden layers bf16 x bf16 -> f32 + bias, ReLU, rounded to bf16,
//     and a last layer in f32: sigmoid RGB on lanes 0..2, softplus(x - 1)
//     density on lane 3 (any NL >= 1);
//   mask = mask_in * coarse_bit(o + t d) (coarse.cuh arithmetic);
//   tau = sigma dt mask, w = T0 exp(-excl) (1 - exp(-tau));
//   out = (sum w rgb, sum w, sum w t, T_final);
//   for training also tchk [B, ceil(S / 64)]: the transmittance at which
//   each ray enters every 64-sample chunk, from which the backward kernel
//   (fused_backward.cu) restarts each of its chunks.
//
// What bounds it on an H100: the tensor cores.  A sample costs
// 2 (8 * 128 * 128 + 128 * 4) = 263,168 FLOP of bf16 products at the
// default width against ~1 KB of per-ray inputs shared by all its samples,
// far above the card's ~295 FLOP/byte balance point.  What stands between
// it and that bound (PERF.md, PR 6): the weight tiles, which every SM reads
// from L2 for each round of tiles, and the encoding's 123 accurate sines
// per sample.
//
// Design (redesigned for Hopper; the first version staged each layer's
// weights through registers for every 128-row tile, multiplied with
// mma.sync from padded shared memory, wrote every layer's activations back
// to shared memory and composited with one thread per ray):
// - The tile is B2's: 64 rows, one 64-sample chunk of one ray (S >= 64) or
//   64 / S rays (S < 64); render/fused.py:bwd_tiles.  Each of two
//   warpgroups holds two tiles at a time (one A fragment each) and walks
//   their chunks first to last, in step, carrying the rays' transmittance
//   across chunks.  So every weight tile read from L2 serves 256 rows, and
//   the per-row phases (depth and mask, compositing) keep all four warps of
//   a warpgroup busy, one tile on each half.  Eight warps leave a thread up
//   to 255 registers; it uses 226.
// - Products on wgmma with A from registers.  A hidden layer is two
//   m64n64k16 sequences (output columns 0..63, 64..127) against B in shared
//   memory; its f32 accumulator gets bias + ReLU, is rounded to bf16 and
//   repacked in place as the next layer's A (an m64nN accumulator's columns
//   16 k .. 16 k + 15 are an A fragment's k-th step).  Activations never
//   touch shared memory.  The head is an m64n8k16 product (lanes 0..3 used)
//   against a K-major copy of the last layer's first 8 columns, built once
//   per CTA.
// - The encoding is computed straight into A-fragment registers: each
//   thread encodes exactly the elements it holds.  Its sines are sinf's own
//   fast path written with selects instead of branches
//   (fused.cuh:sin_fast_path, bit-equal to sinf), so a thread's 64 sines
//   overlap each other instead of running one after another; a chunk with
//   an argument beyond that path (|x| >= 105615) is encoded again by sinf.
// - Weights by TMA (in-major, as W, through the tensor map B2 uses; wgmma
//   reads them MN-major), with the layer's 512 bias bytes by a bulk copy,
//   into kSlots slots of 32 KB: the first min(NL - 1, kSlots - kMinRing)
//   hidden layers stay resident for the whole launch, the others stream
//   through the remaining slots as a ring (half the default model's weight
//   bytes per chunk).  The CTA's first thread issues the first loads; after
//   that the last warp to release a ring slot loads it again.  There is no
//   producer warp: a ninth warp would cap every thread at 168 registers (a
//   quarter of the SM's registers serves each quarter of its warps).  Every
//   chunk walks the same sequence of tiles; a chunk the skip rule drops, or
//   a warpgroup without a tile in a round, waits for and releases its slots
//   without computing.
// - Persistent grid: one CTA per SM (the occupancy query's count); CTA k
//   takes tiles k, k + n_ctas, ... in rounds of four, its i-th tile going
//   to warpgroup (i % 4) / 2 (render/fused.py:fwd_schedule).
// - Compositing by segmented warp scans: the head's four lanes per row go
//   to a [64][4] f32 buffer per tile, and 64 threads (one per row) compute
//   the exclusive tau sum, the weights and the per-ray sums with __shfl
//   scans, carrying across their two warps through shared memory.
// - The skip rule is B2's (fused_backward.cu): a tile's chunk is not shaded
//   when none of its samples is live, or when every ray of the tile had
//   T <= term_eps at the entry of the 128-sample chunk (kFwdRows) that
//   holds it.  A skipped chunk leaves T and tchk as they are.  `shaded`
//   (optional) records the decision per ray and chunk.
// - No atomics on results: two launches are bit-equal.  Per-ray sums run in
//   another order than the plain version's serial one (within B1_ATOL).
// Measured and dropped (PERF.md, PR 6): a producer warp; one tile for each
// of two or three warpgroups; the next chunk's encoding interleaved between
// each layer's wgmma issue and its wait (slower at every setting); deeper rings
// with fewer resident layers; streaming layers 1, 3, 5, 7 in place of 4..7;
// a staggered start of the warpgroups; L1 prefetch of the next chunk.
//
// Parity with the plain version: the sample depth, the sample position of
// the coarse test and the encoding argument are rounded op by op
// (__fmul_rn / __fadd_rn) in the plain version's association; the sines are
// sinf's values (see above), expf and log1pf the accurate library
// functions (no --use_fast_math: the folded encoding reaches |x| ~ 1.6e3
// rad, where __sinf is wrong).
//
// Shared memory (232,448 bytes a block can have; independent of NL):
//   weight slots 6 x 33,792 = 202,752 (32 KB of weights + 512 bytes of bias
//   each, 1024-aligned); head weights 2,048; coarse words 4,096; per tile
//   head 1,024, per-row t / mask / step 768, per-ray T, entry T and sums
//   1,792, scan carry 32 (x 4 = 14,464); head bias, mbarriers and release
//   counts 112; alignment slack 1,024: 224,496 in all, one CTA per SM.

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

constexpr int kRows = tnerf::kBwdRows;  // sample rows per tile: B2's tile
constexpr int kFwdRows = 128;           // skip granularity (kFwdRows in fused_backward.cu)
constexpr int kGroups = 2;  // warpgroups (FWD_GROUPS in render/fused.py)
constexpr int kPair = 2;    // tiles a warpgroup holds at once (FWD_TILES_PER_GROUP)
constexpr int kThreads = 128 * kGroups;
constexpr int kSlots = 6;    // weight tiles held: resident layers, then the ring
constexpr int kMinRing = 2;  // slots the ring keeps
constexpr int kWBytes = kLanes * kLanes * 2;
constexpr int kBiasBytes = kLanes * 4;
constexpr int kSlotBytes = kWBytes + 1024;  // weights, then the layer's bias
constexpr int kHeadBytes = 8 * kLanes * 2;  // head weights, K-major [8][128]
constexpr int kMaxSmem = 232448;

static_assert(kRows == 64 && kLanes == 128, "the wgmma tilings below assume 64 x 128 tiles");

// Built with -DTNERF_FWD_CLOCK (tools/torch_b1_turns.py --clock), thread 0
// of every warpgroup adds the clock64 cycles of each phase into
// fwd_clock[phase]: 0 per-row depth, mask and skip rule, 1 hidden layers,
// 2 waits for weight tiles, 3 encoding, 4 head, 5 compositing and its
// barriers.
#ifdef TNERF_FWD_CLOCK
__device__ unsigned long long fwd_clock[8];
#define FWD_LAP(k)                                       \
  do {                                                   \
    if (clock_on) {                                      \
      const long long now = clock64();                   \
      clock_acc[k] += now - clock_t0;                    \
      clock_t0 = now;                                    \
    }                                                    \
  } while (0)
#else
#define FWD_LAP(k) \
  do {             \
  } while (0)
#endif

struct Group {
  float head[kRows][4];                   // last layer's lanes 0..3 + bias
  float t[kRows], m[kRows], step[kRows];  // per row of the chunk
  float T[kRows], Tent[kRows];  // per ray: T now, T at the 128-sample chunk's entry
  float acc[kRows][5];          // per ray: r, g, b, acc, depth
  float carry[8];               // scan partials of row 31
};

struct Fixed {
  uint32_t words[tnerf::kWords];  // coarse bitfield
  Group grp[kGroups * kPair];  // tile 2 g + p is warpgroup g's p-th
  float head_bias[8];
  uint64_t resident;      // the resident layers have arrived
  uint64_t full[kSlots];  // ring slot holds its load (TMA bytes arrived)
  int released[kSlots];   // warps done with the ring slot's load
};

constexpr size_t kSmemBytes = 1024 + (size_t)kSlots * kSlotBytes + kHeadBytes + sizeof(Fixed);
static_assert(kSmemBytes <= kMaxSmem, "shared memory budget");

// Barrier ids of warpgroup g: 1 + 3 g over its 128 threads, 2 + 3 g + p over
// the 64 that composite its p-th tile.
__device__ __forceinline__ int bar_wg(int g) { return 1 + 3 * g; }
__device__ __forceinline__ int bar_rows(int g, int p) { return 2 + 3 * g + p; }

// Inclusive scans of v[0..N) over segments of `ch` rows of the tile, by
// threads 0..63 of a warpgroup (row = thread); a segment that straddles the
// two warps takes row 31's partials from `carry`.
template <int N>
__device__ __forceinline__ void seg_scan(float (&v)[N], int row, int ch, float* carry, int bar) {
  const int lane = row & 31, seg = row / ch;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool in = lane >= off && (row - off) / ch == seg;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float u = __shfl_up_sync(0xffffffffu, v[n], off);
      if (in) v[n] += u;
    }
  }
  if (31 / ch == 32 / ch) {  // the same for every row
    if (row == 31)
#pragma unroll
      for (int n = 0; n < N; ++n) carry[n] = v[n];
    named_sync(bar, kRows);
    if (row >= 32 && seg == 31 / ch)
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] += carry[n];
  }
}

// The bf16 pair of features (f, f + 1) of one row into an A-fragment register.
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Where this thread's two fragment rows (r0, r0 + 8) of a chunk get their
// encoding: the rows' rays' (gamma, beta) rows and abscissas.  A row that
// is not a sample points at ray 0 and is not valid.
struct EncodeRows {
  const float* g[2];
  const float* b[2];
  float u[2];
  bool valid[2];
};

// Slice kk of layer 0's input, the encoding, into this thread's A fragment:
// a[4 kk .. 4 kk + 3], features 16 kk + 8 h + cq, + 1 (h = 0, 1) of rows r0
// (even registers) and r0 + 8 (odd); zero for a row that is not a sample.
// With kExact the sines are sinf; else sin_fast_path, whose selects let the
// slice's 8 sines and the next slice's loads overlap, and `big` is set
// where sinf would have reduced otherwise.
template <bool kExact>
__device__ __forceinline__ void encode_slice(uint32_t (&a)[32], const EncodeRows& e, int kk,
                                             int cq, bool& big) {
  float2 g[2][2], b[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      g[r][h] = *reinterpret_cast<const float2*>(e.g[r] + 16 * kk + 8 * h + cq);
      b[r][h] = *reinterpret_cast<const float2*>(e.b[r] + 16 * kk + 8 * h + cq);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = 16 * kk + 8 * h + cq;
      // gamma + u beta, rounded op by op (fused.cuh:encode_feature)
      const float x0 = __fadd_rn(g[r][h].x, __fmul_rn(e.u[r], b[r][h].x));
      const float x1 = __fadd_rn(g[r][h].y, __fmul_rn(e.u[r], b[r][h].y));
      float v0, v1;
      if constexpr (kExact) {
        v0 = tnerf::encode_feature(g[r][h].x, b[r][h].x, e.u[r], f);
        v1 = tnerf::encode_feature(g[r][h].y, b[r][h].y, e.u[r], f + 1);
      } else {
        v0 = f < 5 ? x0 : tnerf::sin_fast_path(x0);
        v1 = f + 1 < 5 ? x1 : tnerf::sin_fast_path(x1);
        big |= e.valid[r] &
               (((f >= 5) & tnerf::big_sin_arg(x0)) | ((f + 1 >= 5) & tnerf::big_sin_arg(x1)));
      }
      a[4 * kk + 2 * h + r] = e.valid[r] ? pack2(v0, v1) : 0u;
    }
}

// One hidden layer: a (this warpgroup's 64 rows, bf16, A fragment) times the
// weight tile at w (two m64n64k16 sequences, output columns 0..63 and
// 64..127, one straight-line group), + bias, ReLU, rounded to bf16, back
// into a: accumulator pair (d[2 m], d[2 m + 1]) is row r0 + 8 (m & 1),
// columns 8 (m / 2) + cq, + 1 of its half, the next layer's a[16 h + m].
// Nothing reads the accumulators before the group retires.
__device__ __forceinline__ void hidden_layer(uint32_t (&a)[32], const unsigned char* w,
                                             const float* bias, int cq) {
  float d0[32], d1[32];
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_rs<1>(d0, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                          desc(smem_u32(w + (kk >> 2) * kBlockBytes + (kk & 3) * 2048)), kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n64k16_rs<1>(d1, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                          desc(smem_u32(w + (2 + (kk >> 2)) * kBlockBytes + (kk & 3) * 2048)),
                          kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d0);
  fence_regs(d1);
  fence_regs(a);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const float2 b0 = *reinterpret_cast<const float2*>(bias + 8 * (m >> 1) + cq);
    const float2 b1 = *reinterpret_cast<const float2*>(bias + 64 + 8 * (m >> 1) + cq);
    a[m] = pack2(fmaxf(d0[2 * m] + b0.x, 0.f), fmaxf(d0[2 * m + 1] + b0.y, 0.f));
    a[16 + m] = pack2(fmaxf(d1[2 * m] + b1.x, 0.f), fmaxf(d1[2 * m + 1] + b1.y, 0.f));
  }
}

// The head: lanes 0..7 of a times the K-major head tile; h[0..1] are row r0's
// columns cq, cq + 1 and h[2..3] row r0 + 8's.
__device__ __forceinline__ void head_layer(float (&h)[4], uint32_t (&a)[32],
                                           const unsigned char* hw) {
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_m64n8k16_rs<0>(h, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                         desc(smem_u32(hw + (kk >> 2) * 1024 + (kk & 3) * 32)), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(h);
  fence_regs(a);
}

template <bool kTmode>
__global__ void __launch_bounds__(kThreads, 1)
fused_forward_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const tnerf::Placement<kTmode> place,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ mask, const uint32_t* __restrict__ words_in,
                     float* __restrict__ out, float* __restrict__ tchk,
                     uint8_t* __restrict__ shaded, int B, int S, int n_layers, int use_coarse,
                     Coarse cg, float term_eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* head_w = slots + kSlots * kSlotBytes;
  Fixed& sm = *reinterpret_cast<Fixed*>(head_w + kHeadBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = S < kRows ? S : kRows;  // samples per ray per chunk
  const int R = kRows / ch;              // rays per tile
  const int n_tiles = (B + R - 1) / R;
  const int n_chunks = (S + ch - 1) / ch;
  const int fch = S < kFwdRows ? S : kFwdRows;
  const int my_tiles =
      (int)blockIdx.x < n_tiles ? (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int per_round = kGroups * kPair;  // tiles of the CTA in flight at once
  const int n_items = (my_tiles + per_round - 1) / per_round * n_chunks;  // chunks per tile
  const int per_pass = n_layers - 1;  // hidden layers
  // Hidden layers 0..n_res-1 stay in slots 0..n_res-1 for the whole launch;
  // the others stream through the remaining n_ring slots, n_stream a chunk.
  const int n_res = per_pass < kSlots - kMinRing ? per_pass : kSlots - kMinRing;
  const int n_ring = kSlots - n_res, n_stream = per_pass - n_res;
  const long long n_loads = (long long)n_items * n_stream;
  unsigned char* ring = slots + n_res * kSlotBytes;

  // one weight tile (and its bias) into a slot, completing on bar
  auto load = [&](unsigned char* slot, int layer, uint64_t* bar) {
    mbar_expect_tx(bar, kWBytes + kBiasBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h)  // column half h: rows 0..127, blocks (0, h), (1, h)
      tma_load(slot + h * 2 * kBlockBytes, &wmap, h * 64, layer * kLanes, bar);
    bulk_load(slot + kWBytes, bias + (size_t)layer * kLanes, kBiasBytes, bar);
  };
  // ring load i: layer n_res + i % n_stream into slot i % n_ring
  auto load_ring = [&](long long i) {
    const int q = (int)(i % n_ring);
    load(ring + q * kSlotBytes, n_res + (int)(i % n_stream), &sm.full[q]);
  };
  if (tid == 0) {
    prefetch_tensormap(&wmap);
    mbar_init(&sm.resident, n_res > 0 ? n_res : 1);
    for (int q = 0; q < kSlots; ++q) {
      mbar_init(&sm.full[q], 1);
      sm.released[q] = 0;
    }
    fence_mbar_init();
    for (int l = 0; l < n_res; ++l) load(slots + l * kSlotBytes, l, &sm.resident);
    for (long long i = 0; i < n_ring && i < n_loads; ++i) load_ring(i);
  }
  if (use_coarse)
    for (int i = tid; i < tnerf::kWords; i += kThreads) sm.words[i] = words_in[i];
  {  // the head's weights, columns 0..7 of the last layer, K-major and swizzled
    const __nv_bfloat16* wl = w + (size_t)(n_layers - 1) * kLanes * kLanes;
    for (int i = tid; i < 8 * kLanes; i += kThreads) {
      const int n = i & 7, k = i >> 3;
      *reinterpret_cast<__nv_bfloat16*>(head_w + (k >> 6) * 1024 + n * 128 +
                                        ((((k & 63) >> 3) ^ n) << 4) + ((k & 7) << 1)) =
          wl[k * kLanes + n];
    }
    if (tid < 8) sm.head_bias[tid] = bias[(n_layers - 1) * kLanes + tid];
  }
  fence_async_smem();
  __syncthreads();

#ifdef TNERF_FWD_CLOCK
  const bool clock_on = (tid & 127) == 0;
  long long clock_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, clock_t0 = clock64();
#endif
  const int g = warp >> 2, wt = tid & 127, w4 = warp & 3;
  const int r0 = 16 * w4 + (lane >> 2), cq = 2 * (lane & 3);  // fragment rows r0, r0 + 8
  const int h = wt >> 6, row = wt & 63;  // the tile of the pair whose row this thread handles
  Group& G = sm.grp[kPair * g + h];
  if (n_res > 0) mbar_wait(&sm.resident, 0u);
  for (int it = 0; it < n_items; ++it) {  // chunk c of the warpgroup's tiles of round it / n_chunks
    const int c = it % n_chunks;
    int ray0[kPair];
    bool have[kPair];
#pragma unroll
    for (int p = 0; p < kPair; ++p) {
      const int q = (it / n_chunks) * per_round + kPair * g + p;  // among the CTA's tiles
      have[p] = q < my_tiles;
      ray0[p] = ((int)blockIdx.x + q * (int)gridDim.x) * R;
    }

    // Every thread one row of tile h: depth, mask and step.  Threads 0..R-1
    // of each half, one ray each: the transmittance at the chunk's entry
    // into tchk, and at the entry of the 128-sample chunk that holds it for
    // the skip rule.
    bool any = false, live = false;
    if (have[h]) {
      const int j = row / ch, s = c * ch + row % ch, ray = ray0[h] + j;
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
      G.t[row] = t;
      G.m[row] = m;
      G.step[row] = step;
      any = m != 0.f;
      if (row < R && ray0[h] + row < B) {
        if (c == 0) {
          G.T[row] = 1.f;
#pragma unroll
          for (int n = 0; n < 5; ++n) G.acc[row][n] = 0.f;
        }
        const float T0 = G.T[row];
        if ((c * ch) % fch == 0) G.Tent[row] = T0;
        live = G.Tent[row] > term_eps;
        if (tchk != nullptr) tchk[(size_t)(ray0[h] + row) * n_chunks + c] = T0;
      }
    }
    bool compute[kPair];
#pragma unroll
    for (int p = 0; p < kPair; ++p)
      compute[p] = bar_or(bar_wg(g), 128, h == p && any) && bar_or(bar_wg(g), 128, h == p && live);
    if (shaded != nullptr && have[h] && row < R && ray0[h] + row < B)
      shaded[(size_t)(ray0[h] + row) * n_chunks + c] = compute[h] ? 1 : 0;
    FWD_LAP(0);

    // The encodings into this thread's A fragments, one per tile.
    uint32_t a[kPair][32];
#pragma unroll
    for (int p = 0; p < kPair; ++p) {
      if (!compute[p]) continue;
      EncodeRows e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int fr = r0 + 8 * r, j = fr / ch, s = c * ch + fr % ch, ray = ray0[p] + j;
        e.valid[r] = j < R && ray < B && s < S;
        e.g[r] = gamma + (e.valid[r] ? (size_t)ray * kLanes : 0);
        e.b[r] = beta + (e.valid[r] ? (size_t)ray * kLanes : 0);
        e.u[r] = e.valid[r] ? place.abscissa(s, sm.grp[kPair * g + p].t[fr]) : 0.f;
      }
      bool big = false;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) encode_slice<false>(a[p], e, kk, cq, big);
      if (big)  // an argument beyond sinf's fast path: the encoding again, by sinf
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) encode_slice<true>(a[p], e, kk, cq, big);
    }
    FWD_LAP(3);

    // The hidden layers: resident tiles, then the ring's, each multiplying
    // both of the warpgroup's tiles.  A chunk that is not shaded still waits
    // for and releases its ring loads.
    for (int l = 0; l < per_pass; ++l) {
      const bool from_ring = l >= n_res;
      const long long i = (long long)it * n_stream + (l - n_res);  // ring load, if streamed
      const int q = (int)(i % n_ring);
      const unsigned char* wl = from_ring ? ring + q * kSlotBytes : slots + l * kSlotBytes;
      if (from_ring) mbar_wait(&sm.full[q], (uint32_t)((i / n_ring) & 1));
      FWD_LAP(2);
#pragma unroll
      for (int p = 0; p < kPair; ++p)
        if (compute[p]) hidden_layer(a[p], wl, reinterpret_cast<const float*>(wl + kWBytes), cq);
      FWD_LAP(1);
      if (from_ring) {  // the last warp to be done with the slot loads it again
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          if (atomicAdd(&sm.released[q], 1) == 4 * kGroups - 1) {
            __threadfence_block();
            sm.released[q] = 0;
            if (i + n_ring < n_loads) load_ring(i + n_ring);
          }
        }
      }
    }

    // The heads, raw values of lanes 0..3 into the tiles' row buffers.
#pragma unroll
    for (int p = 0; p < kPair; ++p) {
      if (!compute[p]) continue;
      float hv[4];
      head_layer(hv, a[p], head_w);
      if (cq < 4) {
        Group& P = sm.grp[kPair * g + p];
        P.head[r0][cq] = hv[0] + sm.head_bias[cq];
        P.head[r0][cq + 1] = hv[1] + sm.head_bias[cq + 1];
        P.head[r0 + 8][cq] = hv[2] + sm.head_bias[cq];
        P.head[r0 + 8][cq + 1] = hv[3] + sm.head_bias[cq + 1];
      }
    }
    FWD_LAP(4);
    named_sync(bar_wg(g), 128);

    // Every thread one row of tile h: activations and compositing along
    // each ray, both tiles at once.
    if (compute[h]) {
      const int j = row / ch, ray = ray0[h] + j;
      const bool valid = j < R && ray < B && c * ch + row % ch < S;
      float cr = 0.f, cgr = 0.f, cb = 0.f, tau = 0.f;
      if (valid) {
        const float* hr = G.head[row];
        cr = tnerf::sigmoidf(hr[0]);
        cgr = tnerf::sigmoidf(hr[1]);
        cb = tnerf::sigmoidf(hr[2]);
        const float sig = tnerf::density_softplus(hr[3]);
        tau = __fmul_rn(__fmul_rn(sig, G.step[row]), G.m[row]);
      }
      float incl[1] = {tau};
      seg_scan<1>(incl, row, ch, G.carry, bar_rows(g, h));
      const float T0 = G.T[j];
      const float wgt = T0 * expf(-(incl[0] - tau)) * (1.f - expf(-tau));
      float sums[5] = {wgt * cr, wgt * cgr, wgt * cb, wgt, wgt * G.t[row]};
      seg_scan<5>(sums, row, ch, G.carry + 1, bar_rows(g, h));
      if (row == (j + 1) * ch - 1 && j < R && ray < B) {  // the segment's last row
#pragma unroll
        for (int n = 0; n < 5; ++n) G.acc[j][n] += sums[n];
        G.T[j] = T0 * expf(-incl[0]);
      }
    }
    named_sync(bar_wg(g), 128);  // T and sums written; the row buffers are free
    FWD_LAP(5);

    if (c == n_chunks - 1 && have[h] && row < R && ray0[h] + row < B) {
      float* po = out + (size_t)(ray0[h] + row) * 6;
#pragma unroll
      for (int n = 0; n < 5; ++n) po[n] = G.acc[row][n];
      po[5] = G.T[row];
    }
  }
#ifdef TNERF_FWD_CLOCK
  if (clock_on)
    for (int k = 0; k < 8; ++k) atomicAdd(&fwd_clock[k], (unsigned long long)clock_acc[k]);
#endif
}

// sin_fast_path and sinf of every x, for the check that they agree.
__global__ void sin_check_kernel(const float* __restrict__ x, float* __restrict__ fast,
                                 float* __restrict__ exact, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    fast[i] = tnerf::sin_fast_path(x[i]);
    exact[i] = sinf(x[i]);
  }
}

// CTAs of the kernel the card holds at once (negative: a CUDA error).
template <bool kTmode>
int max_ctas() {
  cudaError_t err = cudaFuncSetAttribute(fused_forward_kernel<kTmode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_forward_kernel<kTmode>,
                                                      kThreads, kSmemBytes);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

template <bool kTmode>
int launch_forward(const void* w, const float* bias, const float* gamma, const float* beta,
                   const tnerf::Placement<kTmode>& place, const float* o, const float* d,
                   const float* mask, const int32_t* words, float* out, float* tchk,
                   uint8_t* shaded, int B, int S, int n_layers, int n_ctas, int use_coarse,
                   const Coarse& cg, float term_eps, void* stream) {
  if (n_layers < 1 || n_ctas < 1 || (reinterpret_cast<uintptr_t>(bias) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  const int map_err = weight_map(&wmap, w, n_layers);
  if (map_err != (int)cudaSuccess) return map_err;
  cudaError_t err = cudaFuncSetAttribute(fused_forward_kernel<kTmode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  fused_forward_kernel<kTmode><<<n_ctas, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      wmap, reinterpret_cast<const __nv_bfloat16*>(w), bias, gamma, beta, place, o, d, mask,
      reinterpret_cast<const uint32_t*>(words), out, tchk, shaded, B, S, n_layers, use_coarse, cg,
      term_eps);
  return (int)cudaGetLastError();
}

}  // namespace

// CTAs of the kernel the card holds at once (uniform placement if tmode ==
// 0); negative: minus a cudaError_t.
extern "C" int tnerf_fused_forward_max_ctas(int tmode) {
  return tmode ? max_ctas<true>() : max_ctas<false>();
}

extern "C" int tnerf_fused_forward(const void* w, const float* bias, const float* gamma,
                                   const float* beta, const float* te, const float* dt,
                                   const float* o, const float* d, const float* mask,
                                   const int32_t* words, float* out, float* tchk, uint8_t* shaded,
                                   int B, int S, int n_layers, int n_ctas, int use_coarse,
                                   int res_c, float lo_x, float lo_y, float lo_z, float rcp_x,
                                   float rcp_y, float rcp_z, float term_eps, void* stream) {
  return launch_forward<false>(w, bias, gamma, beta, {te, dt, nullptr, nullptr}, o, d, mask,
                               words, out, tchk, shaded, B, S, n_layers, n_ctas, use_coarse,
                               Coarse{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z}, term_eps,
                               stream);
}

// Per-sample placement: ts, dts [B, S] in the place of te, dt [B].
extern "C" int tnerf_fused_forward_tmode(const void* w, const float* bias, const float* gamma,
                                         const float* beta, const float* ts, const float* dts,
                                         const float* o, const float* d, const float* mask,
                                         const int32_t* words, float* out, float* tchk,
                                         uint8_t* shaded, int B, int S, int n_layers, int n_ctas,
                                         int use_coarse, int res_c, float lo_x, float lo_y,
                                         float lo_z, float rcp_x, float rcp_y, float rcp_z,
                                         float term_eps, void* stream) {
  return launch_forward<true>(w, bias, gamma, beta, {nullptr, nullptr, ts, dts}, o, d, mask,
                              words, out, tchk, shaded, B, S, n_layers, n_ctas, use_coarse,
                              Coarse{res_c, lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z}, term_eps,
                              stream);
}

// sin_fast_path (fast) and sinf (exact) of x [n], for chip_smoke.py's check.
extern "C" int tnerf_sin_fast_check(const float* x, float* fast, float* exact, int n,
                                    void* stream) {
  sin_check_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(x, fast, exact, n);
  return (int)cudaGetLastError();
}

#ifdef TNERF_FWD_CLOCK
// The clock split's sums into host[8], then zeroed.
extern "C" int tnerf_fused_forward_clock(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, fwd_clock, sizeof(fwd_clock));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(fwd_clock, zero, sizeof(zero));
}
#endif
