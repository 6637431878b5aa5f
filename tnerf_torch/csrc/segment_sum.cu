// Fixed-order segment sum: the table gradient of every lookup of the
// hash-grid, triplane and CP encodes (fields/hashgrid.py:segment_sum_rows),
// the second half after the stable sort by row (csrc/segment_sort.cu).
//
// Replaces no Pallas kernel: the reference's lookups are jnp gathers whose
// transpose XLA computes as a scatter-add in a fixed order
// (tnerf/fields/hashgrid.py:193, tnerf/fields/triplane.py:191, :385).
// PyTorch's own backward of a gather sums a row's cotangents in no fixed
// order on the card (`embedding`), one after another (indexing), or by
// atomics (`index_add_`); this kernel repeats bit for bit, with no atomics
// (ROADMAP Queue C 7).
//
//   out[r, f] = sum over j in [offsets[r], offsets[r + 1]) of v(j, f),
//   v(j, f) = payload[j * F + f]            (by value: narrow rows, F <= 4)
//           = values[payload[j] * F + f]    (by index: wide rows)
//
// The sorted stream holds a row's cotangents in lookup order (or their
// lookup indices), offsets each row's start in it.  A row gets a group of
// E x FT threads: entry lane e adds entries start + e, start + e + E, ...
// one after another, feature lane fl the features fl, fl + FT, ...; then
// the E partial sums of a feature are added by a fixed pairwise tree in
// shared memory.  E grows with the rows' mean length (segment_shape in the
// wrapper), so a table of few rows with thousands of cotangents each (CP's
// and the triplane's lines) still fills the card.  The plain version
// (`segment_sum_rows_plain`) adds in the same order, so the two agree bit
// for bit.  Where a row's group fits a warp, segment_sum_warp_kernel walks
// several rows per warp with the same lanes and tree.
//
// Bound: bytes (the sorted stream and each row's offset read once, and by
// index each value once, each output written once); one add per value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kByValue>
__device__ __forceinline__ float value_at(const float* __restrict__ values,
                                          const unsigned* __restrict__ payload, int64_t j,
                                          int F, int f) {
  if (kByValue) return __uint_as_float(payload[j * F + f]);
  return values[(int64_t)payload[j] * F + f];
}

constexpr int kInFlight = 8;  // loads a lane keeps in flight

template <bool kByValue>
__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const unsigned* __restrict__ payload,
                                   const int* __restrict__ offsets, float* __restrict__ out,
                                   int rows, int F, int FT, int E, int rows_per_block) {
  extern __shared__ float part[];  // one partial per thread
  const int t = threadIdx.x;
  const int group = E * FT;
  const int local = t / group;
  const int lane = t - local * group;
  const int e = lane / FT;
  const int fl = lane - e * FT;
  const int r = blockIdx.x * rows_per_block + local;
  const bool active = r < rows;
  const int64_t start = active ? offsets[r] : 0;
  const int64_t end = active ? offsets[r + 1] : 0;
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    float acc = 0.0f;
    if (active && f < F) {
      int64_t j = start + e;
      // kInFlight loads in flight, added in their order
      for (; j + (kInFlight - 1) * (int64_t)E < end; j += kInFlight * (int64_t)E) {
        float v[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
          v[q] = value_at<kByValue>(values, payload, j + q * (int64_t)E, F, f);
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) acc += v[q];
      }
      for (; j < end; j += E) acc += value_at<kByValue>(values, payload, j, F, f);
    }
    part[t] = acc;
    __syncthreads();
    for (int s = E >> 1; s > 0; s >>= 1) {
      if (e < s) part[t] += part[t + s * FT];
      __syncthreads();
    }
    if (active && e == 0 && f < F) out[(int64_t)r * F + f] = part[t];
    __syncthreads();
  }
}

// Rows whose group of E x FT lanes fits a warp (E * FT divides 32, so FT =
// F): a warp holds 32 / (E * FT) rows at once and kSets such sets, their
// loads in flight together, and the E partials of a feature meet by
// shuffles down the same tree.  The hash grid's rows (F = 2, about a dozen
// lookups each, E = 16) would otherwise give each block a few loads and
// four barriers.
template <bool kByValue, int kSets>
__global__ void segment_sum_warp_kernel(const float* __restrict__ values,
                                        const unsigned* __restrict__ payload,
                                        const int* __restrict__ offsets, float* __restrict__ out,
                                        int rows, int F, int E) {
  const int lane = threadIdx.x & 31;
  const int group = E * F;
  const int local = lane / group;
  const int e = (lane - local * group) / F;
  const int f = lane - local * group - e * F;
  const int per_set = 32 / group;
  const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int64_t r0 = warp * per_set * kSets + local;
  int64_t j[kSets], end[kSets];
  float first[kSets], acc[kSets];
#pragma unroll
  for (int i = 0; i < kSets; ++i) {
    const int64_t r = r0 + (int64_t)i * per_set;
    j[i] = r < rows ? offsets[r] + e : 0;
    end[i] = r < rows ? offsets[r + 1] : 0;
  }
#pragma unroll
  for (int i = 0; i < kSets; ++i)
    first[i] = j[i] < end[i] ? value_at<kByValue>(values, payload, j[i], F, f) : 0.0f;
#pragma unroll
  for (int i = 0; i < kSets; ++i) {
    acc[i] = 0.0f;
    if (j[i] < end[i]) {
      acc[i] += first[i];
      int64_t k = j[i] + E;
      for (; k + 3 * (int64_t)E < end[i]; k += 4 * (int64_t)E) {
        const float v0 = value_at<kByValue>(values, payload, k, F, f),
                    v1 = value_at<kByValue>(values, payload, k + E, F, f),
                    v2 = value_at<kByValue>(values, payload, k + 2 * E, F, f),
                    v3 = value_at<kByValue>(values, payload, k + 3 * E, F, f);
        acc[i] += v0;
        acc[i] += v1;
        acc[i] += v2;
        acc[i] += v3;
      }
      for (; k < end[i]; k += E) acc[i] += value_at<kByValue>(values, payload, k, F, f);
    }
  }
#pragma unroll
  for (int i = 0; i < kSets; ++i) {
    for (int s = E >> 1; s > 0; s >>= 1) {
      const float other = __shfl_down_sync(0xffffffffu, acc[i], s * F);
      if (e < s) acc[i] += other;
    }
    const int64_t r = r0 + (int64_t)i * per_set;
    if (e == 0 && r < rows) out[r * F + f] = acc[i];
  }
}

constexpr int kWarpSets = 4;

}  // namespace

// values [n, F] (read by index only), payload the sorted stream of
// csrc/segment_sort.cu (by_value: [n, F] values, else [n] lookup indices),
// offsets [rows + 1] int32, out [rows, F].
extern "C" int tnerf_segment_sum(const float* values, const unsigned* payload, const int* offsets,
                                 float* out, int rows, int F, int FT, int E, int rows_per_block,
                                 int by_value, void* stream) {
  if (E * FT <= 32 && 32 % (E * FT) == 0) {
    const int rows_per_warp = 32 / (E * FT) * kWarpSets;
    const int64_t warps = (rows + rows_per_warp - 1) / rows_per_warp;
    const int blocks = (int)((warps + 7) / 8);
    if (by_value)
      segment_sum_warp_kernel<true, kWarpSets><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          values, payload, offsets, out, rows, F, E);
    else
      segment_sum_warp_kernel<false, kWarpSets><<<blocks, 256, 0, (cudaStream_t)stream>>>(
          values, payload, offsets, out, rows, F, E);
    return (int)cudaGetLastError();
  }
  const int threads = rows_per_block * E * FT;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = threads * sizeof(float);
  if (by_value)
    segment_sum_kernel<true><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        values, payload, offsets, out, rows, F, FT, E, rows_per_block);
  else
    segment_sum_kernel<false><<<blocks, threads, smem, (cudaStream_t)stream>>>(
        values, payload, offsets, out, rows, F, FT, E, rows_per_block);
  return (int)cudaGetLastError();
}
