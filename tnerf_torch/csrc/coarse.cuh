// The coarse occupancy bit test shared by the tighten (B3) and fused
// forward (B1) kernels: the port of tnerf/grid/pallas_dda.py:_occ_bit_rows.
//
// Bit-exact with the reference: the cell id divides by the cell size with
// a correctly rounded division (never a multiply by the reciprocal),
// floors, clamps the float before the int conversion (XLA's conversion
// saturates) and clips to [0, res_c - 1].  Words are tested as unsigned:
// bit 31 is the int32 sign bit, and the reference's arithmetic shift
// followed by `& 1` gives the same answer.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tnerf {

constexpr int kWords = 1024;  // 32^3 bits

struct Coarse {
  int res_c;
  float lo_x, lo_y, lo_z, cell_x, cell_y, cell_z;
};

__device__ __forceinline__ int cell_id(float p, float lo, float cell, int res_c) {
  float c = floorf(__fdiv_rn(__fsub_rn(p, lo), cell));
  c = fminf(fmaxf(c, -1.0f), (float)res_c);
  int i = (int)c;
  return min(max(i, 0), res_c - 1);
}

__device__ __forceinline__ bool occ_bit(const uint32_t* words, const Coarse& g,
                                        float x, float y, float z) {
  int ci = cell_id(x, g.lo_x, g.cell_x, g.res_c);
  int cj = cell_id(y, g.lo_y, g.cell_y, g.res_c);
  int ck = cell_id(z, g.lo_z, g.cell_z, g.res_c);
  int cflat = (ci * g.res_c + cj) * g.res_c + ck;
  return (words[cflat >> 5] >> (cflat & 31)) & 1u;
}

}  // namespace tnerf
