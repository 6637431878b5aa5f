// The yardstick of the table lookups' gradient: the segment-sum kernel as it
// was while the stable sort ran before it as `torch.sort` (int64 keys) and
// the row starts as `torch.searchsorted` (commit c713ce8).  Not part of the
// port: tools/torch_segment_turns.py builds it into a library of its own
// and times that whole path against fields/hashgrid.py:segment_sum_rows.
//
//   out[r, f] = sum over j in [offsets[r], offsets[r + 1]) of
//               values[order[j], f]
//
// order: the stable sort of the lookup indices, offsets: each row's start
// in it.  The lanes and the tree are csrc/segment_sum.cu's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_parent_kernel(const float* __restrict__ values,
                                   const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ offsets,
                                   float* __restrict__ out, int rows, int F, int FT, int E,
                                   int rows_per_block) {
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
      // four loads in flight, added in their order
      for (; j + 3 * (int64_t)E < end; j += 4 * (int64_t)E) {
        const int64_t i0 = order[j], i1 = order[j + E], i2 = order[j + 2 * E],
                      i3 = order[j + 3 * E];
        const float v0 = values[i0 * F + f], v1 = values[i1 * F + f],
                    v2 = values[i2 * F + f], v3 = values[i3 * F + f];
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
      }
      for (; j < end; j += E) acc += values[order[j] * F + f];
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

}  // namespace

extern "C" int tnerf_segment_sum_parent(const float* values, const int64_t* order,
                                 const int64_t* offsets, float* out, int rows, int F, int FT,
                                 int E, int rows_per_block, void* stream) {
  const int threads = rows_per_block * E * FT;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  segment_sum_parent_kernel<<<blocks, threads, threads * sizeof(float), (cudaStream_t)stream>>>(
      values, order, offsets, out, rows, F, FT, E, rows_per_block);
  return (int)cudaGetLastError();
}
