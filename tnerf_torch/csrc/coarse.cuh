// The coarse occupancy bit test shared by the tighten (B3, B4) and fused
// (B1, B2) kernels: the port of tnerf/grid/pallas_dda.py:_occ_bit_rows.
//
// Bit-exact with the reference.  Its source divides by the cell size, a
// compile-time constant, and XLA's algebraic simplifier rewrites x / c for
// a constant c into x * RN(1 / c), the reciprocal rounded once to float32
// (under jit, and inside a Pallas kernel in interpret mode).  So the cell
// id here is floor((p - lo) * rcp) with rcp = RN(1 / cell) computed on the
// host (grid/tighten.py:_coarse_floats, render/fused.py:_coarse_args),
// clipped to [0, res_c - 1]; for a cell size that is a power of two it
// equals the division.  Words are tested as unsigned: bit 31 is the int32
// sign bit, and the reference's arithmetic shift followed by `& 1` gives
// the same answer.
//
// The floor and the flat index are formed in floats, without a conversion
// instruction.  q + 1.5 * 2^23 - 1.5 * 2^23 rounds q to the nearest
// integer r exactly for |q| < 2^22, and floor(q) is r, or r - 1 where r >
// q; every larger |q|, an infinity and NaN (which the reference's
// saturating conversion sends to 0) clip as the reference's ids do.  The
// flat index (i res_c + j) res_c + k is an integer below 2^15, exact in a
// float, and is read out of the bits of flat + 2^23.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tnerf {

constexpr int kWords = 1024;  // 32^3 bits

// res_c, the box corner and the reciprocals of the coarse cell size
struct Coarse {
  int res_c;
  float lo_x, lo_y, lo_z, rcp_x, rcp_y, rcp_z;
};

// clip(floor((p - lo) * rcp), 0, top) as a float
__device__ __forceinline__ float cell_floor(float p, float lo, float rcp, float top) {
  const float q = __fmul_rn(__fsub_rn(p, lo), rcp);
  const float m = 12582912.0f;  // 1.5 * 2^23
  const float r = __fsub_rn(__fadd_rn(q, m), m);
  const float fl = r > q ? __fsub_rn(r, 1.0f) : r;
  return fminf(fmaxf(fl, 0.0f), top);
}

// the coarse cell id of one coordinate
__device__ __forceinline__ int cell_id(float p, float lo, float rcp, int res_c) {
  return (int)cell_floor(p, lo, rcp, (float)(res_c - 1));
}

__device__ __forceinline__ bool occ_bit(const uint32_t* words, const Coarse& g,
                                        float x, float y, float z) {
  const float top = (float)(g.res_c - 1), rc = (float)g.res_c;
  const float fx = cell_floor(x, g.lo_x, g.rcp_x, top);
  const float fy = cell_floor(y, g.lo_y, g.rcp_y, top);
  const float fz = cell_floor(z, g.lo_z, g.rcp_z, top);
  const float flat = __fmaf_rn(__fmaf_rn(fx, rc, fy), rc, fz);
  const int cflat = __float_as_int(__fadd_rn(flat, 8388608.0f)) & 0x7fffff;
  return (words[cflat >> 5] >> (cflat & 31)) & 1u;
}

}  // namespace tnerf
