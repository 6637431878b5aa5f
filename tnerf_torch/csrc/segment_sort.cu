// Stable sort of the table lookups by row: the first half of their table
// gradient (fields/hashgrid.py:segment_sort, then csrc/segment_sum.cu).
//
// Replaces no Pallas kernel: the reference's lookups are jnp gathers whose
// transpose XLA computes as a scatter-add in a fixed order
// (tnerf/fields/hashgrid.py:193, tnerf/fields/triplane.py:191, :385).  The
// segment sum adds a row's cotangents in lookup order, so it needs the
// lookups grouped by row with their order kept: the stable sort of the row
// ids, which is unique, so any correct stable sort gives the same bits.
//
//   keys[j], payload[j]: the j-th lookup in (row, lookup index) order;
//   offsets[r]: the first j of row r (offsets[rows] = n).
//
// The payload is the lookup's values themselves where a row is narrow (F <=
// 4 floats: the hash grid's 2), so the sum reads them contiguously, and the
// lookup's index otherwise (CP's 64 features, the triplane's 16), so the sum
// reads whole contiguous rows of values.
//
// Scheme: a least-significant-digit radix sort over the row id's
// ceil(log2 rows) bits only, in `passes` digits of `bits` bits (at most 9:
// 512 digits; the split is fields/hashgrid.py:sort_passes), keys as 32-bit
// row ids read from the int64 lookup indices by the first pass.
//   1. segment_sort_hist_kernel: every pass's digit counts over all keys
//      (shared-memory histograms, then integer atomics: exact, whatever
//      their order).
//   2. segment_sort_pass_kernel, once per pass: a tile of 4096 keys per
//      block, tiles numbered by an atomic counter in the order the blocks
//      start, so a tile only waits on tiles whose blocks already run.  A
//      warp ranks its 512 keys by digit (__match_any_sync, counts per warp
//      in shared memory), the warps' counts are scanned in warp order, the
//      tile publishes its digit counts and finds the counts of the tiles
//      before it by a decoupled look-back over 32-bit status words (flag
//      and count in one word; kLookback words loaded at once, so a walk
//      over tiles that have only published their own counts waits on one
//      load in kLookback), the keys are placed in digit order in shared
//      memory and written out, a digit's run of the tile to consecutive
//      addresses.  Equal digits keep tile order and, within a tile, index
//      order: each pass is stable, so the sort is.
//   3. segment_row_starts_kernel: each row's start from the run boundaries
//      of the sorted keys.
// One memset and 2 + passes launches; no library sort or scan.  Keys must
// lie in [0, rows); others leave the kernels in bounds and their rows
// unspecified.
//
// Bound: bytes.  Each pass reads and writes the keys and payload once; the
// first pass reads the int64 indices (and the values) instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // fields/hashgrid.py:SORT_TILE
constexpr int kMaxBits = 9;
constexpr int kMaxPasses = 4;
constexpr int kHistThreads = 256;
constexpr int kHistItems = 16;  // keys a thread loads at once
constexpr int kHistBlocks = 264;
constexpr int kLookback = 16;
constexpr int kStartsItems = 8;  // keys a thread of the row-starts kernel reads

// A tile's status word for one digit: 0 until published, then 1 + the
// tile's own count (at most kTile), or kInclusive | the count of this tile
// and all before it (under 2^31 lookups).
constexpr unsigned kInclusive = 1u << 31;

// the first pass reads the int64 indices and the values (narrow rows) or the
// lookup index (wide rows); later passes the previous pass's output
enum Source { kFromValues = 0, kFromIds = 1, kFromSorted = 2 };

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kHistThreads)
    segment_sort_hist_kernel(const int64_t* __restrict__ idx, int n, int passes, int bits,
                             unsigned* __restrict__ hist) {
  __shared__ unsigned h[kMaxPasses << kMaxBits];
  const int radix = 1 << bits;
  const unsigned mask = radix - 1;
  for (int i = threadIdx.x; i < passes * radix; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const int64_t chunk = (int64_t)kHistThreads * kHistItems;
  for (int64_t i0 = blockIdx.x * chunk + threadIdx.x; i0 < n; i0 += (int64_t)gridDim.x * chunk) {
    unsigned key[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const int64_t i = i0 + (int64_t)k * kHistThreads;
      key[k] = i < n ? (unsigned)idx[i] : 0xffffffffu;
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k)
      if (key[k] != 0xffffffffu)
        for (int p = 0; p < passes; ++p)
          atomicAdd(&h[p * radix + ((key[k] >> (p * bits)) & mask)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * radix; i += blockDim.x)
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
}

// Exclusive scan of v[0, radix) in shared memory, in place, by the whole
// block (radix <= 2 * kThreads): a thread scans a run of consecutive entries.
__device__ void block_exclusive_scan(unsigned* v, int radix, unsigned* warp_sum) {
  const int per = (radix + kThreads - 1) / kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = threadIdx.x * per;
  __syncthreads();
  unsigned own = 0;
  for (int i = 0; i < per; ++i)
    if (b0 + i < radix) own += v[b0 + i];
  unsigned x = own;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  unsigned run = x - own;
  for (int w = 0; w < warp; ++w) run += warp_sum[w];
  for (int i = 0; i < per; ++i)
    if (b0 + i < radix) {
      const unsigned c = v[b0 + i];
      v[b0 + i] = run;
      run += c;
    }
  __syncthreads();
}

struct PassArgs {
  const int64_t* idx;        // first pass: the lookup indices
  const float* values;       // first pass from values: [n, PW]
  const unsigned* keys_in;   // later passes
  const unsigned* pay_in;    // later passes: [n, PW]
  unsigned* keys_out;
  unsigned* pay_out;         // [n, PW]
  const unsigned* hist;      // this pass's digit counts over all keys
  unsigned* status;          // [tiles, radix], zero on entry
  unsigned* tile_counter;      // zero on entry
  int n, shift, bits;
};

template <int PW, int kSrc>
__global__ void __launch_bounds__(kThreads) segment_sort_pass_kernel(PassArgs a) {
  extern __shared__ unsigned smem[];
  const int radix = 1 << a.bits;
  const unsigned mask = radix - 1;
  unsigned* warp_cnt = smem;                   // [kWarps, radix]: a warp's count, then start
  unsigned* tile_base = warp_cnt + kWarps * radix;  // [radix]: count in the tile, then start
  unsigned* out_base = tile_base + radix;      // [radix]: where the digit's run goes, less
                                               // its start in the tile
  unsigned* skeys = out_base + radix;          // [kTile]
  unsigned* spay = skeys + kTile;              // [kTile, PW]
  __shared__ unsigned s_tile, warp_sum[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  for (int i = tid; i < kWarps * radix; i += kThreads) warp_cnt[i] = 0;
  for (int d = tid; d < radix; d += kThreads) out_base[d] = a.hist[d];
  __syncthreads();
  const unsigned tile = s_tile;
  const int64_t base = (int64_t)tile * kTile;
  const int valid = (int)(a.n - base < kTile ? a.n - base : kTile);

  // warp w holds the tile's keys [w * 32 * kItems, (w + 1) * 32 * kItems),
  // key k of lane l at w * 32 * kItems + k * 32 + l: (warp, k, lane) is
  // index order
  unsigned key[kItems], pay[kItems][PW], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int t = warp * 32 * kItems + k * 32 + lane;
    const int64_t i = base + t;
    key[k] = 0;
    if (t < valid) {
      if (kSrc == kFromSorted) {
        key[k] = a.keys_in[i];
#pragma unroll
        for (int w = 0; w < PW; ++w) pay[k][w] = a.pay_in[i * PW + w];
      } else {
        key[k] = (unsigned)a.idx[i];
        if (kSrc == kFromIds) {
          pay[k][0] = (unsigned)i;
        } else {
#pragma unroll
          for (int w = 0; w < PW; ++w) pay[k][w] = __float_as_uint(a.values[i * PW + w]);
        }
      }
    }
  }

  // rank within the warp: the keys of one digit before this one, in order
  const unsigned lower = (1u << lane) - 1;
  unsigned* cnt = warp_cnt + warp * radix;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool ok = warp * 32 * kItems + k * 32 + lane < valid;
    const unsigned d = ok ? (key[k] >> a.shift) & mask : 0xffffffffu;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned before = ok ? cnt[d] : 0;
    __syncwarp();
    rank[k] = before + __popc(peers & lower);
    if (ok && (peers & lower) == 0) cnt[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // a warp's start within its digit in the tile: the counts of the warps before it
  for (int d = tid; d < radix; d += kThreads) {
    unsigned run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = warp_cnt[w * radix + d];
      warp_cnt[w * radix + d] = run;
      run += c;
    }
    tile_base[d] = run;
    store_status(a.status + (int64_t)tile * radix + d, tile == 0 ? kInclusive | run : 1 + run);
  }
  block_exclusive_scan(out_base, radix, warp_sum);  // each digit's start in the output

  // the digit's count in the tiles before this one: walk back over their
  // status words, kLookback at a time and a thread's digits together,
  // adding own counts, until one holds an inclusive count; at a tile not
  // yet published (its block runs), load again from there
  constexpr int kPer = (1 << kMaxBits) / kThreads;  // digits a thread looks back for
  unsigned before[kPer];
  int j[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    before[u] = 0;
    j[u] = tid + u * kThreads < radix ? (int)tile - 1 : -1;
  }
  while (true) {
    bool walking = false;
#pragma unroll
    for (int u = 0; u < kPer; ++u) walking |= j[u] >= 0;
    if (!walking) break;
    unsigned s[kPer][kLookback];
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int q = 0; q < kLookback; ++q)
        s[u][q] = j[u] - q >= 0
                      ? load_status(a.status + (int64_t)(j[u] - q) * radix + tid + u * kThreads)
                      : kInclusive;  // before tile 0: nothing, inclusive
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      bool stop = false, found = false;
      int walked = 0;
#pragma unroll
      for (int q = 0; q < kLookback; ++q) {
        if (stop) continue;
        if (s[u][q] == 0) {
          stop = true;
        } else if (s[u][q] & kInclusive) {
          before[u] += s[u][q] & ~kInclusive;
          stop = found = true;
        } else {
          before[u] += s[u][q] - 1;
          ++walked;
        }
      }
      j[u] = found ? -1 : j[u] - walked;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int d = tid + u * kThreads;
    if (d >= radix) continue;
    if (tile != 0)
      store_status(a.status + (int64_t)tile * radix + d, kInclusive | (before[u] + tile_base[d]));
    out_base[d] += before[u];
  }
  block_exclusive_scan(tile_base, radix, warp_sum);  // each digit's start in the tile
  for (int d = tid; d < radix; d += kThreads) out_base[d] -= tile_base[d];
  __syncthreads();

  // the tile in digit order in shared memory, then out: a digit's run of the
  // tile to consecutive addresses
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (warp * 32 * kItems + k * 32 + lane < valid) {
      const unsigned d = (key[k] >> a.shift) & mask;
      const unsigned at = tile_base[d] + cnt[d] + rank[k];
      skeys[at] = key[k];
#pragma unroll
      for (int w = 0; w < PW; ++w) spay[at * PW + w] = pay[k][w];
    }
  }
  __syncthreads();
  for (int t = tid; t < valid; t += kThreads) {
    const unsigned k = skeys[t];
    const int64_t to = (int64_t)(unsigned)(out_base[(k >> a.shift) & mask] + t);
    a.keys_out[to] = k;
#pragma unroll
    for (int w = 0; w < PW; ++w) a.pay_out[to * PW + w] = spay[t * PW + w];
  }
}

// offsets[r] = the first j with keys[j] >= r: where the sorted keys step
// from below r to r or above (offsets[rows] = n).  A thread reads
// kStartsItems keys and fills the rows each step passes over; a step over
// 32 rows or more (a level's rows past its dense grid, the rows after the
// last key) is filled by the whole warp.
__global__ void segment_row_starts_kernel(const unsigned* __restrict__ keys, int n, int rows,
                                          int* __restrict__ offsets) {
  const int64_t j0 = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * kStartsItems;
  const int lane = threadIdx.x & 31;
  unsigned k[kStartsItems];
#pragma unroll
  for (int q = 0; q < kStartsItems; ++q) k[q] = j0 + q < n ? keys[j0 + q] : 0;
  int64_t prev = j0 > 0 && j0 < n ? (int64_t)keys[j0 - 1] : -1;
#pragma unroll
  for (int q = 0; q <= kStartsItems; ++q) {  // key q's step, then the one after the last key
    int64_t lo = 0, hi = -1, at = 0;           // rows [lo, hi] start at `at`
    if (q < kStartsItems) {
      if (j0 + q < n) {
        lo = prev + 1;
        hi = (int64_t)k[q] < rows ? (int64_t)k[q] : rows;
        at = j0 + q;
        prev = k[q];
      }
    } else if (j0 < n && j0 + kStartsItems >= n) {
      lo = prev + 1;
      hi = rows;
      at = n;
    }
    const bool wide = hi - lo >= 31;
    if (!wide)
      for (int64_t r = lo; r <= hi; ++r) offsets[r] = (int)at;
    for (unsigned wides = __ballot_sync(0xffffffffu, wide); wides; wides &= wides - 1) {
      const int from = __ffs(wides) - 1;
      const int64_t l = __shfl_sync(0xffffffffu, lo, from), h = __shfl_sync(0xffffffffu, hi, from);
      const int v = (int)__shfl_sync(0xffffffffu, at, from);
      for (int64_t r = l + lane; r <= h; r += 32) offsets[r] = v;
    }
  }
}

size_t smem_bytes(int bits, int pw) {
  return sizeof(unsigned) * ((size_t)(kWarps + 2) * (1u << bits) + (size_t)kTile * (1 + pw));
}

template <int PW, int kSrc>
int launch_pass(const PassArgs& a, int tiles, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.bits, PW);
  static unsigned opted_in = 0;  // the devices this instantiation may use it on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1u)) {
    err = cudaFuncSetAttribute(segment_sort_pass_kernel<PW, kSrc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxBits, PW));
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  segment_sort_pass_kernel<PW, kSrc><<<tiles, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int PW>
int launch_pass_pw(int src, const PassArgs& a, int tiles, cudaStream_t stream) {
  if (src == kFromSorted) return launch_pass<PW, kFromSorted>(a, tiles, stream);
  if (src == kFromValues) return launch_pass<PW, kFromValues>(a, tiles, stream);
  if (PW == 1) return launch_pass<1, kFromIds>(a, tiles, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_pass_any(int pw, int src, const PassArgs& a, int tiles, cudaStream_t stream) {
  switch (pw) {
    case 1: return launch_pass_pw<1>(src, a, tiles, stream);
    case 2: return launch_pass_pw<2>(src, a, tiles, stream);
    case 3: return launch_pass_pw<3>(src, a, tiles, stream);
    case 4: return launch_pass_pw<4>(src, a, tiles, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The stable sort of n lookups idx (int64, in [0, rows)) by row.  by_value:
// the payload is values [n, pw] (pw = F <= 4), else the lookup index (pw =
// 1).  keys_out / pay_out receive the sorted keys and payload, keys_tmp /
// pay_tmp are a second buffer of the same sizes, offsets [rows + 1].
// zeroed: passes << bits unsigned digit counts, passes tile counters, then
// passes x tiles x 2^bits status words; the function clears
// it first.  tile must be this file's kTile (the wrapper's constant).
extern "C" int tnerf_segment_sort(const int64_t* idx, const float* values, int n, int rows,
                                  int passes, int bits, int by_value, int pw, int tile,
                                  unsigned* keys_out, unsigned* pay_out, unsigned* keys_tmp,
                                  unsigned* pay_tmp, int* offsets, void* zeroed,
                                  size_t zeroed_bytes, void* stream_) {
  const cudaStream_t stream = (cudaStream_t)stream_;
  if (tile != kTile || n <= 0 || rows <= 0 || passes < 1 || passes > kMaxPasses || bits < 1 ||
      bits > kMaxBits || pw < 1 || pw > 4 || (!by_value && pw != 1))
    return (int)cudaErrorInvalidValue;
  const int radix = 1 << bits;
  const int tiles = (n + kTile - 1) / kTile;
  unsigned* hist = (unsigned*)zeroed;
  unsigned* counters = hist + passes * radix;
  unsigned* status = counters + passes;
  if ((char*)(status + (size_t)passes * tiles * radix) > (char*)zeroed + zeroed_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(zeroed, 0, zeroed_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int hist_blocks = (n + kHistThreads * kHistItems - 1) / (kHistThreads * kHistItems);
  segment_sort_hist_kernel<<<hist_blocks < kHistBlocks ? hist_blocks : kHistBlocks,
                             kHistThreads, 0, stream>>>(idx, n, passes, bits, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int p = 0; p < passes; ++p) {
    // the last pass writes keys_out / pay_out
    const bool to_out = (passes - 1 - p) % 2 == 0;
    PassArgs a;
    a.idx = idx;
    a.values = values;
    a.keys_in = to_out ? keys_tmp : keys_out;
    a.pay_in = to_out ? pay_tmp : pay_out;
    a.keys_out = to_out ? keys_out : keys_tmp;
    a.pay_out = to_out ? pay_out : pay_tmp;
    a.hist = hist + p * radix;
    a.status = status + (size_t)p * tiles * radix;
    a.tile_counter = counters + p;
    a.n = n;
    a.shift = p * bits;
    a.bits = bits;
    const int src = p > 0 ? kFromSorted : by_value ? kFromValues : kFromIds;
    const int e = launch_pass_any(pw, src, a, tiles, stream);
    if (e != 0) return e;
  }
  const int threads = 256;
  const int per_block = threads * kStartsItems;
  segment_row_starts_kernel<<<(n + per_block - 1) / per_block, threads, 0, stream>>>(
      keys_out, n, rows, offsets);
  return (int)cudaGetLastError();
}
