// The probe phase shared by the tighten (B3) and tighten + sample mask (B4)
// kernels: the port of tnerf/grid/pallas_dda.py:_probe_tighten (:299).  Any
// parity fix lands here once and both kernels inherit it.
//
// `probes` midpoint probes of [te, tx] test the coarse bitfield; the span
// shrinks to the first and last occupied probe, padded by one probe step
// plus pad_diag (one fine-cell diagonal); a ray that no probe hits keeps
// its full span.  Bit-exact with the reference: every multiply and add is
// rounded separately (__fmul_rn / __fadd_rn stop nvcc contracting them into
// FMAs) in the reference's association, and the cell test is coarse.cuh's
// occ_bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"

namespace tnerf {

struct RayGeom {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ RayGeom load_ray(const float* o, const float* d, int r) {
  return RayGeom{o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

// The occupancy bit at depth t of the ray (position o + d t, rounded op by op).
__device__ __forceinline__ bool occ_at(const uint32_t* words, const Coarse& g, const RayGeom& r,
                                       float t) {
  const float x = __fadd_rn(r.ox, __fmul_rn(r.dx, t));
  const float y = __fadd_rn(r.oy, __fmul_rn(r.dy, t));
  const float z = __fadd_rn(r.oz, __fmul_rn(r.dz, t));
  return occ_bit(words, g, x, y, z);
}

__device__ __forceinline__ void probe_tighten(const uint32_t* words, const Coarse& g,
                                              const RayGeom& r, float te, float tx, int probes,
                                              float pad_diag, float& t0, float& t1) {
  const float nprobes = (float)probes;
  const float span = fmaxf(__fsub_rn(tx, te), 0.0f);
  const float step = __fdiv_rn(span, nprobes);
  const float big = 3.0e38f;
  float tf = big, tl = -big;
  if (span > 0.0f) {
    for (int i = 0; i < probes; ++i) {
      const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), nprobes);
      const float t = __fadd_rn(te, __fmul_rn(span, frac));
      if (occ_at(words, g, r, t)) {
        tf = fminf(tf, t);
        tl = fmaxf(tl, t);
      }
    }
  }
  const bool hit = tl >= tf;
  const float pad = __fadd_rn(step, pad_diag);
  t0 = hit ? fmaxf(__fsub_rn(tf, pad), te) : te;
  t1 = hit ? fminf(__fadd_rn(tl, pad), tx) : tx;
}

}  // namespace tnerf
