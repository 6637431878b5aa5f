// The probe phase shared by the tighten (B3) and tighten + sample mask (B4)
// kernels: the port of tnerf/grid/pallas_dda.py:_probe_tighten (:299),
// evaluated by a group of G lanes per ray.  Any parity fix lands here once
// and both kernels inherit it.
//
// `probes` midpoint probes of [te, tx] test the coarse bitfield; the span
// shrinks to the first and last occupied probe, padded by one probe step
// plus pad_diag (one fine-cell diagonal); a ray that no probe hits keeps
// its full span.
//
// The scan.  The group evaluates probes in rounds of G, front to back,
// and stops at the first round that holds an occupied probe: the round's
// __ballot_sync gives the first occupied index and keeps the round's bits.
// Then it scans from the last probe down, in rounds of G, over the probes
// above that round, and stops at the first round that holds an occupied
// probe: its ballot gives the last occupied index (or, where no probe
// above is occupied, the highest bit of the kept round does).  No probe is
// evaluated twice; a ray with no hit makes one full forward pass.
//
// The reference divides by the probe count (`(i + 0.5) / probes`, `span /
// probes`), and XLA's algebraic simplifier turns a division by a constant
// into a multiply by its reciprocal, rounded once to float32; so the port
// multiplies by rcp = RN(1 / probes) (the same as the division for a power
// of two; grid/traversal.py:reciprocal).
//
// Why the scan is bit-exact with the reference, which folds min / max over
// the depths of every occupied probe: t_i = RN(te + RN(span * RN((i + 0.5)
// * rcp))) does not decrease with i for span >= 0, because each rounding
// is monotone.  So the minimum over occupied probes is t at the first
// occupied index and the maximum is t at the last.  For finite te, tx
// (which is what ray_aabb and the near clamp give) no t_i is NaN.  Every
// multiply and add is rounded separately (__fmul_rn / __fadd_rn stop
// nvcc contracting them into FMAs) in the reference's association; step,
// pad and the clamps to [te, tx] are the reference's.
//
// The cell ids are coarse.cuh's: a multiply by the reciprocal of the cell
// size, which is what the reference's XLA computes for its division.
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

// The occupancy bit at depth t of the ray (position o + d t, rounded op by
// op): coarse.cuh's occ_bit.
__device__ __forceinline__ bool occ_at(const uint32_t* words, const Coarse& g, const RayGeom& r,
                                       float t) {
  const float x = __fadd_rn(r.ox, __fmul_rn(r.dx, t));
  const float y = __fadd_rn(r.oy, __fmul_rn(r.dy, t));
  const float z = __fadd_rn(r.oz, __fmul_rn(r.dz, t));
  return occ_bit(words, g, x, y, z);
}

// The G lanes of one warp that serve one ray.
template <int G>
struct LaneGroup {
  int lane;       // 0 .. G - 1
  int shift;      // the group's first lane in the warp
  unsigned mask;  // the group's lanes

  __device__ __forceinline__ LaneGroup() {
    lane = threadIdx.x & (G - 1);
    shift = (threadIdx.x & 31) & ~(G - 1);
    mask = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << shift;
  }
  // bit l: pred of the group's lane l
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return __ballot_sync(mask, pred) >> shift;
  }
};

template <int G>
__device__ __forceinline__ void probe_tighten(const uint32_t* words, const Coarse& g,
                                              float rcp_probes, const RayGeom& r, float te,
                                              float tx, int probes, float pad_diag,
                                              const LaneGroup<G>& lg, float& t0, float& t1) {
  const float span = fmaxf(__fsub_rn(tx, te), 0.0f);
  const float step = __fmul_rn(span, rcp_probes);
  // the depth of probe i, given i + 0.5 as a float (exact below 2^23)
  auto depth = [&](float i_half) {
    return __fadd_rn(te, __fmul_rn(span, __fmul_rn(i_half, rcp_probes)));
  };
  int first = -1, last = -1;
  if (span > 0.0f) {
    unsigned bits = 0;
    int base = 0;
    float fi = (float)lg.lane + 0.5f;
    for (; base < probes; base += G, fi = __fadd_rn(fi, (float)G)) {  // forward
      bits = lg.ballot(base + lg.lane < probes && occ_at(words, g, r, depth(fi)));
      if (bits) break;
    }
    if (bits) {
      first = base + __ffs(bits) - 1;
      last = base + 31 - __clz(bits);
      const int above = base + G;  // backward, over the probes above the kept round
      fi = (float)(probes - 1 - lg.lane) + 0.5f;
      for (int top = probes - 1; top >= above; top -= G, fi = __fsub_rn(fi, (float)G)) {
        const unsigned b = lg.ballot(top - lg.lane >= above && occ_at(words, g, r, depth(fi)));
        if (b) {
          last = top - (__ffs(b) - 1);
          break;
        }
      }
    }
  }
  const float big = 3.0e38f;
  const float tf = first >= 0 ? fminf(big, depth((float)first + 0.5f)) : big;
  const float tl = last >= 0 ? fmaxf(-big, depth((float)last + 0.5f)) : -big;
  const bool hit = tl >= tf;
  const float pad = __fadd_rn(step, pad_diag);
  t0 = hit ? fmaxf(__fsub_rn(tf, pad), te) : te;
  t1 = hit ? fminf(__fadd_rn(tl, pad), tx) : tx;
}

}  // namespace tnerf
