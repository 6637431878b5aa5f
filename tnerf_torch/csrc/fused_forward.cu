// Kernel B1: fused frequency-encode + 9-layer MLP + composite forward,
// for sm_90a.
//
// Replaces the TPU kernel tnerf/render/pallas_fused2.py:_fwd_kernel (:350,
// built by make_fused_trainable :582).  Python side:
// tnerf_torch/render/fused.py (plain version + wrapper).  What it
// computes, per ray and sample s (t = te + (s + 0.5) dt):
//   feature f = act_f(gamma_f + (s + 0.5) beta_f), act = identity for
//     f < 5 and sin otherwise, rounded to bf16;
//   (per-sample placement, the TPU kernel's tmode=True, is the kernel's
//   second instantiation: t = ts[ray, s], feature f = act_f(gamma_f + t
//   beta_f) with (gamma, beta) folded at (0, 1), and dts[ray, s] in dt's
//   place below; fused.cuh:Placement holds the difference)
//   8 hidden layers bf16 x bf16 -> f32 + bias, ReLU, rounded to bf16, and
//     a last layer in f32: sigmoid RGB on lanes 0..2, softplus(x - 1)
//     density on lane 3;
//   mask = mask_in * coarse_bit(o + t d) (coarse.cuh arithmetic);
//   tau = sigma dt mask, w = T0 exp(-excl) (1 - exp(-tau));
//   out = (sum w rgb, sum w, sum w t, T_final);
//   for training also tchk [B, ceil(S / 64)]: the transmittance at which
//   each ray enters every 64th sample, from which the backward kernel
//   (fused_backward.cu) restarts each of its chunks.
// The TPU kernel's lane packing, chunk-major masks, one-hot bridges and
// triangular/segment/pack matrices exist only for the TPU's lanes: here
// each ray's samples are contiguous rows and per-ray sums are plain loops.
//
// What bounds it on an H100: the tensor cores.  Each sample costs
// 9 * 2 * 128^2 = 2.95e5 bf16 FLOP against ~1 KB of per-ray inputs shared
// by all its samples, far above the card's ~295 FLOP/byte balance point.
// Design (a simple, right first version): one block of 8 warps per tile of
// 128 sample rows (R = 128 / S rays of S samples, or one ray in chunks of
// 128 samples when S > 128).  The tile's bf16 activations stay in shared
// memory for all nine layers; each layer's 128x128 bf16 weights are staged
// in shared memory one layer at a time (all nine would need 288 KB, more
// than the 227 KB a block can have); each warp multiplies its 16 rows with
// mma.sync m16n8k16 (bf16 in, f32 accumulate).  Row strides are padded by
// 8 bf16 so the fragment loads are free of bank conflicts.  Compositing is
// one thread per ray in f32.  A tile whose samples are all masked, or
// whose rays have all fallen below term_eps, skips the MLP; a masked
// sample contributes nothing, so the first skip changes no result.
//
// Parity with the plain version: the sample depth, the sample position of
// the coarse test and the encoding argument are rounded op by op
// (__fmul_rn / __fadd_rn) in the plain version's association; sinf, expf
// and log1pf are the accurate library functions (no --use_fast_math: the
// folded encoding reaches |x| ~ 1.6e3 rad, where __sinf is wrong).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"
#include "fused.cuh"

namespace {

using tnerf::Coarse;
using tnerf::kBwdRows;
using tnerf::kLanes;
using tnerf::kStride;
using tnerf::kWords;

constexpr int kRows = 128;             // sample rows per tile
constexpr int kWarps = 8;              // 16 rows each
constexpr int kThreads = kWarps * 32;

struct Smem {
  __nv_bfloat16 act[kRows * kStride];  // activations of the tile's rows
  __nv_bfloat16 w[kLanes * kStride];   // one layer, out-major: w[n][k]
  float head[kRows][4];                // last-layer lanes 0..3
  float t[kRows];                      // sample depth per row
  float m[kRows];                      // sample mask per row
  float step[kRows];                   // quadrature step per row (per-sample placement only)
  uint32_t words[kWords];              // coarse bitfield
  float T[kRows];                      // running transmittance per ray
  float acc[kRows][5];                 // per ray: r, g, b, acc, depth
};

template <bool kTmode>
__global__ void __launch_bounds__(kThreads, 2)
fused_forward_kernel(const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const tnerf::Placement<kTmode> place,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ mask, const uint32_t* __restrict__ words_in,
                     float* __restrict__ out, float* __restrict__ tchk, int B, int S,
                     int n_layers, int use_coarse, Coarse cg, float term_eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ch = S < kRows ? S : kRows;  // samples per ray per chunk
  const int R = kRows / ch;              // rays per tile
  const int ray0 = blockIdx.x * R;
  const int n_chunks = (S + ch - 1) / ch;
  // tchk [B, n_sub]: the transmittance at which each ray enters every
  // bch-th sample, for the backward kernel's chunks (null = not wanted).
  const int bch = S < kBwdRows ? S : kBwdRows;
  const int n_sub = (S + bch - 1) / bch;

  if (use_coarse)
    for (int i = tid; i < kWords; i += kThreads) sm.words[i] = words_in[i];
  for (int j = tid; j < R; j += kThreads) {
    sm.T[j] = 1.f;
#pragma unroll
    for (int q = 0; q < 5; ++q) sm.acc[j][q] = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < n_chunks; ++k) {
    if (tchk != nullptr) {
      // a skipped chunk leaves T as it is, at all of its boundaries; the
      // compositing loop below overwrites the inner ones otherwise
      for (int j = tid; j < R; j += kThreads) {
        if (ray0 + j >= B) continue;
        for (int s = k * ch; s < S && s < (k + 1) * ch; s += bch)
          tchk[(size_t)(ray0 + j) * n_sub + s / bch] = sm.T[j];
      }
    }
    // Phase 1: per-row depth and mask.
    bool any = false;
    for (int row = tid; row < kRows; row += kThreads) {
      const int j = row / ch, s = k * ch + row % ch, ray = ray0 + j;
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
      if constexpr (kTmode) sm.step[row] = step;
      any |= m != 0.f;
    }
    bool live = false;
    for (int j = tid; j < R; j += kThreads) live |= (ray0 + j < B) && sm.T[j] > term_eps;
    const int any_sample = __syncthreads_or(any);
    const int any_live = __syncthreads_or(live);
    if (!any_sample || !any_live) continue;

    // Phase 2: encode the tile's rows into bf16 activations.
    for (int idx = tid; idx < kRows * kLanes; idx += kThreads) {
      const int row = idx / kLanes, f = idx % kLanes;
      const int j = row / ch, s = k * ch + row % ch, ray = ray0 + j;
      float v = 0.f;
      if (j < R && ray < B && s < S) {
        const size_t gi = (size_t)ray * kLanes + f;
        v = tnerf::encode_feature(gamma[gi], beta[gi], place.abscissa(s, sm.t[row]), f);
      }
      sm.act[row * kStride + f] = __float2bfloat16_rn(v);
    }

    // Phase 3: the MLP, one layer's weights in shared memory at a time.
    const int r0 = warp * 16;
    for (int l = 0; l < n_layers; ++l) {
      __syncthreads();  // activations written; previous layer's weights free
      tnerf::stage_matrix(sm.w, wt + (size_t)l * kLanes * kLanes, tid, kThreads);
      __syncthreads();
      const float* bl = bias + l * kLanes;
      if (l + 1 < n_layers) {
        float acc[kLanes / 8][4];
        tnerf::warp_gemm<kLanes / 8, kLanes / 16>(sm.act, sm.w, r0, 0, g, tq, acc);
        __syncwarp();  // this warp's rows are read; overwrite them in place
#pragma unroll
        for (int nt = 0; nt < kLanes / 8; ++nt) {
          const int col = nt * 8 + 2 * tq;
          const float b0 = bl[col], b1 = bl[col + 1];
          *reinterpret_cast<__nv_bfloat162*>(sm.act + (r0 + g) * kStride + col) =
              __floats2bfloat162_rn(fmaxf(acc[nt][0] + b0, 0.f), fmaxf(acc[nt][1] + b1, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(sm.act + (r0 + g + 8) * kStride + col) =
              __floats2bfloat162_rn(fmaxf(acc[nt][2] + b0, 0.f), fmaxf(acc[nt][3] + b1, 0.f));
        }
      } else {
        float acc[1][4];
        tnerf::warp_gemm<1, kLanes / 16>(sm.act, sm.w, r0, 0, g, tq, acc);
        if (tq < 2) {
          const int col = 2 * tq;
          sm.head[r0 + g][col] = acc[0][0] + bl[col];
          sm.head[r0 + g][col + 1] = acc[0][1] + bl[col + 1];
          sm.head[r0 + g + 8][col] = acc[0][2] + bl[col];
          sm.head[r0 + g + 8][col + 1] = acc[0][3] + bl[col + 1];
        }
      }
    }
    __syncthreads();

    // Phase 4: activations per row, then one thread per ray composites.
    for (int row = tid; row < kRows; row += kThreads) {
      const int j = row / ch, ray = ray0 + j;
      float* h = sm.head[row];
      if (j < R && ray < B) {
        const float sig = tnerf::density_softplus(h[3]);
        h[0] = tnerf::sigmoidf(h[0]);
        h[1] = tnerf::sigmoidf(h[1]);
        h[2] = tnerf::sigmoidf(h[2]);
        const float step = kTmode ? sm.step[row] : place.dt[ray];
        h[3] = __fmul_rn(__fmul_rn(sig, step), sm.m[row]);  // tau
      }
    }
    __syncthreads();
    for (int j = tid; j < R; j += kThreads) {
      if (ray0 + j >= B) continue;
      const float T0 = sm.T[j];
      float incl = 0.f, r = 0.f, gg = 0.f, b = 0.f, a = 0.f, dep = 0.f;
      for (int i = 0; i < ch && k * ch + i < S; ++i) {
        const int row = j * ch + i;
        const float tau = sm.head[row][3];
        if (tchk != nullptr && i > 0 && (k * ch + i) % bch == 0)
          tchk[(size_t)(ray0 + j) * n_sub + (k * ch + i) / bch] = T0 * expf(-incl);
        incl += tau;
        const float excl = incl - tau;
        const float w = T0 * expf(-excl) * (1.f - expf(-tau));
        r += w * sm.head[row][0];
        gg += w * sm.head[row][1];
        b += w * sm.head[row][2];
        a += w;
        dep += w * sm.t[row];
      }
      sm.acc[j][0] += r;
      sm.acc[j][1] += gg;
      sm.acc[j][2] += b;
      sm.acc[j][3] += a;
      sm.acc[j][4] += dep;
      sm.T[j] = T0 * expf(-incl);
    }
    __syncthreads();
  }

  for (int j = tid; j < R; j += kThreads) {
    const int ray = ray0 + j;
    if (ray >= B) continue;
    float* po = out + (size_t)ray * 6;
#pragma unroll
    for (int q = 0; q < 5; ++q) po[q] = sm.acc[j][q];
    po[5] = sm.T[j];
  }
}

template <bool kTmode>
int launch_forward(const void* wt, const float* bias, const float* gamma, const float* beta,
                   const tnerf::Placement<kTmode>& place, const float* o, const float* d,
                   const float* mask, const int32_t* words, float* out, float* tchk, int B, int S,
                   int n_layers, int use_coarse, const Coarse& cg, float term_eps, void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fused_forward_kernel<kTmode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ch = S < kRows ? S : kRows;
  const int R = kRows / ch;
  const int blocks = (B + R - 1) / R;
  fused_forward_kernel<kTmode><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(wt), bias, gamma, beta, place, o, d, mask,
      reinterpret_cast<const uint32_t*>(words), out, tchk, B, S, n_layers, use_coarse, cg,
      term_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tnerf_fused_forward(const void* wt, const float* bias, const float* gamma,
                                   const float* beta, const float* te, const float* dt,
                                   const float* o, const float* d, const float* mask,
                                   const int32_t* words, float* out, float* tchk, int B, int S,
                                   int n_layers, int use_coarse, int res_c, float lo_x,
                                   float lo_y, float lo_z, float cell_x, float cell_y,
                                   float cell_z, float term_eps, void* stream) {
  return launch_forward<false>(wt, bias, gamma, beta, {te, dt, nullptr, nullptr}, o, d, mask,
                               words, out, tchk, B, S, n_layers, use_coarse,
                               Coarse{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z}, term_eps,
                               stream);
}

// Per-sample placement: ts, dts [B, S] in the place of te, dt [B].
extern "C" int tnerf_fused_forward_tmode(const void* wt, const float* bias, const float* gamma,
                                         const float* beta, const float* ts, const float* dts,
                                         const float* o, const float* d, const float* mask,
                                         const int32_t* words, float* out, float* tchk, int B,
                                         int S, int n_layers, int use_coarse, int res_c,
                                         float lo_x, float lo_y, float lo_z, float cell_x,
                                         float cell_y, float cell_z, float term_eps,
                                         void* stream) {
  return launch_forward<true>(wt, bias, gamma, beta, {nullptr, nullptr, ts, dts}, o, d, mask,
                              words, out, tchk, B, S, n_layers, use_coarse,
                              Coarse{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z}, term_eps,
                              stream);
}
