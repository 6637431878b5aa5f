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
// dL/dBias [NL, 128] into zeroed buffers.  Per tile, chunks last to first:
//   1. mask = mask_in * coarse_bit, and the forward kernel's skip rule: a
//      chunk whose rays were all at or below term_eps when the forward
//      entered its (128-sample) chunk, or that has no live sample, was not
//      shaded and gets no gradient;
//   2. the chunk's forward again, exactly as B1 (fused.cuh), keeping every
//      layer's bf16 input in shared memory;
//   3. the compositing VJP:  dw = g_r r + g_g g + g_b b + g_acc + g_dep t,
//      G = dw w, dtau = -suffix(G) + dw T0 E e^-tau - gT T0 Texp,
//      dsig = dtau dt mask, dsraw = dsig (1 - e^-sig), d{r,g,b}pre =
//      w g_c c (1 - c), and the carry gT <- sum(dw E F) + gT Texp toward
//      earlier chunks, starting from gout[:, 5];
//   4. the MLP backward, last layer first: gb = bf16(g); dW[l] += a_in^T gb
//      and dBias[l] += colsum(gb) in f32; g = (gb @ W[l]^T) * (a_in > 0).
// No gradient reaches gamma, beta, the ray or the mask (as on the TPU).
// Per-sample placement (the TPU kernel's tmode=True) is the kernel's second
// instantiation: depth ts[ray, s] and step dts[ray, s] take the place of
// te + (s + 0.5) dt and dt (fused.cuh:Placement), so dsig = dtau dts mask;
// ts and dts get no gradient either.
//
// What bounds it on an H100: the tensor cores (three 128-wide products per
// layer and sample against ~1 KB of per-ray inputs), then the reduction.
// Design (a simple, right first version):
// - Shared memory.  Nine layers' inputs for 128 rows would be 288 KB, more
//   than the 227 KB a block can have, so a tile is 64 rows: 9 x 17 KB of
//   activations, one 34 KB weight tile, one 17 KB gradient tile, 212 KB in
//   all, one block of 8 warps per SM.  With S >= 64 a tile is one ray's
//   chunk of 64 samples; with fewer samples it holds 64 / S rays.
// - Operand orientation.  mma.sync m16n8k16 wants A as pairs along the
//   contraction and B likewise.  Forward (a @ W) stages W out-major (Wt),
//   the input gradient (gb @ W^T) stages W in-major (W as it is), so both
//   read plain 32-bit pairs.  The weight gradient contracts over the
//   tile's rows, which are strided in both operands: ldmatrix.trans loads
//   a_in and gb transposed.
// - The dW reduction.  Blocks run together, so each adds its 128 x 128
//   f32 tile per layer into the one global buffer with red.global.add.f32
//   (atomicAdd whose result is unused); zeros (padded lanes, dead ReLU
//   units, masked samples) are not sent.  The order of those adds differs
//   from run to run, so the gradient is not bit-reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coarse.cuh"
#include "fused.cuh"

namespace {

using tnerf::Coarse;
using tnerf::kLanes;
using tnerf::kStride;
using tnerf::kWords;

constexpr int kRows = tnerf::kBwdRows;  // sample rows per tile
constexpr int kFwdRows = 128;           // the forward kernel's chunk, its skip granularity
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kRows * kStride;  // one activation tile, in bf16
constexpr int kMaxSmem = 232448;        // bytes a block can have on sm_90

static_assert(kRows == 64 && kWarps == 8, "the warp tilings below assume 64 rows and 8 warps");

struct Fixed {
  __nv_bfloat16 w[kLanes * kStride];  // one layer: [output][contraction]
  __nv_bfloat16 g[kTile];             // gradient at a layer's output, bf16
  uint32_t words[kWords];             // coarse bitfield
  float head[kRows][4];               // last layer's lanes 0..3, raw
  float tau[kRows], t[kRows], m[kRows], step[kRows];
  float ex[kRows], G[kRows], dEF[kRows], suf[kRows];  // per row: excl. sum, dw w, dw E F, suffix
  float T0[kRows], Texp[kRows], gT[kRows], gTn[kRows];  // per ray of the tile
};
static_assert(sizeof(Fixed) % 16 == 0, "the activation tiles after Fixed must stay 16-byte aligned");

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void red_add(float* p, float v) {
  if (v != 0.f) atomicAdd(p, v);
}

// dW[k0 .. k0+16)[n0 .. n0 + 8 NT) += a^T g for this warp: a [rows][in
// features] and g [rows][out features] are both row-major by sample, and
// the product contracts over the kRows samples, so both operands are
// loaded transposed.  n_valid: columns at or beyond it are not sent.
template <int NT>
__device__ __forceinline__ void warp_wgrad(const __nv_bfloat16* a, const __nv_bfloat16* gb, int k0,
                                           int n0, int lane, float* dw, int n_valid) {
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int mat = lane >> 3, i = lane & 7;
#pragma unroll
  for (int kt = 0; kt < kRows / 16; ++kt) {
    const int r0 = kt * 16;
    // A[m = in feature][k = row]: matrices (rows r0.., cols k0..), (r0.., k0+8..),
    // (r0+8.., k0..), (r0+8.., k0+8..) -> a0..a3
    uint32_t a0, a1, a2, a3;
    ldmatrix_x4_trans(a0, a1, a2, a3, a + (r0 + i + (mat >> 1) * 8) * kStride + k0 + (mat & 1) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B[k = row][n = out feature]: matrices (rows r0.., cols n..), (r0+8.., n..)
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, gb + (r0 + i + (mat & 1) * 8) * kStride + n0 + nt * 8);
      tnerf::mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
    }
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + nt * 8 + 2 * tq;
    float* p = dw + (size_t)(k0 + g) * kLanes + col;
    if (col < n_valid) {
      red_add(p, acc[nt][0]);
      red_add(p + 8 * kLanes, acc[nt][2]);
    }
    if (col + 1 < n_valid) {
      red_add(p + 1, acc[nt][1]);
      red_add(p + 8 * kLanes + 1, acc[nt][3]);
    }
  }
}

template <bool kTmode>
__global__ void __launch_bounds__(kThreads, 1)
fused_backward_kernel(const __nv_bfloat16* __restrict__ wt, const __nv_bfloat16* __restrict__ wk,
                      const float* __restrict__ bias, const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const tnerf::Placement<kTmode> place, const float* __restrict__ o,
                      const float* __restrict__ d, const float* __restrict__ mask,
                      const uint32_t* __restrict__ words_in, const float* __restrict__ tchk,
                      const float* __restrict__ gout, float* __restrict__ dW,
                      float* __restrict__ dB, int B, int S, int n_layers, int use_coarse,
                      Coarse cg, float term_eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Fixed& sm = *reinterpret_cast<Fixed*>(smem_raw);
  // acts[l]: layer l's input (the encoding for l = 0, else layer l-1's ReLU output)
  __nv_bfloat16* acts = reinterpret_cast<__nv_bfloat16*>(smem_raw + sizeof(Fixed));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ch = S < kRows ? S : kRows;  // samples per ray per chunk
  const int R = kRows / ch;              // rays per tile
  const int ray0 = blockIdx.x * R;
  const int n_chunks = (S + ch - 1) / ch;
  const int fch = S < kFwdRows ? S : kFwdRows;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 64;  // this warp's rows and columns

  if (use_coarse)
    for (int i = tid; i < kWords; i += kThreads) sm.words[i] = words_in[i];
  for (int j = tid; j < kRows; j += kThreads)
    sm.gT[j] = (j < R && ray0 + j < B) ? gout[(size_t)(ray0 + j) * 6 + 5] : 0.f;
  __syncthreads();

  for (int c = n_chunks - 1; c >= 0; --c) {
    // Phase 1: per-row depth and mask, per-ray entry transmittance.
    bool any = false;
    for (int row = tid; row < kRows; row += kThreads) {
      const int j = row / ch, s = c * ch + row % ch, ray = ray0 + j;
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
      any |= m != 0.f;
    }
    bool live = false;
    for (int j = tid; j < R; j += kThreads) {
      const int ray = ray0 + j;
      float T0 = 0.f;
      if (ray < B) {
        const float* tc = tchk + (size_t)ray * n_chunks;
        T0 = tc[c];
        // T at which the forward kernel entered its chunk holding this one
        live |= tc[((c * ch) / fch) * fch / ch] > term_eps;
      }
      sm.T0[j] = T0;
    }
    const int any_sample = __syncthreads_or(any);
    const int any_live = __syncthreads_or(live);
    if (!any_sample || !any_live) continue;

    // Phase 2: encode the tile's rows into acts[0].
    for (int idx = tid; idx < kRows * kLanes; idx += kThreads) {
      const int row = idx / kLanes, f = idx % kLanes;
      const int j = row / ch, s = c * ch + row % ch, ray = ray0 + j;
      float v = 0.f;
      if (j < R && ray < B && s < S) {
        const size_t gi = (size_t)ray * kLanes + f;
        v = tnerf::encode_feature(gamma[gi], beta[gi], place.abscissa(s, sm.t[row]), f);
      }
      acts[row * kStride + f] = __float2bfloat16_rn(v);
    }

    // Phase 3: the forward MLP, keeping every layer's input.
    for (int l = 0; l < n_layers; ++l) {
      __syncthreads();  // layer input written; previous weights free
      tnerf::stage_matrix(sm.w, wt + (size_t)l * kLanes * kLanes, tid, kThreads);
      __syncthreads();
      const __nv_bfloat16* a_in = acts + l * kTile;
      const float* bl = bias + l * kLanes;
      if (l + 1 < n_layers) {
        float acc[8][4];
        tnerf::warp_gemm<8, kLanes / 16>(a_in, sm.w, r0, c0, g, tq, acc);
        __nv_bfloat16* a_out = acts + (l + 1) * kTile;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = c0 + nt * 8 + 2 * tq;
          const float b0 = bl[col], b1 = bl[col + 1];
          *reinterpret_cast<__nv_bfloat162*>(a_out + (r0 + g) * kStride + col) =
              __floats2bfloat162_rn(fmaxf(acc[nt][0] + b0, 0.f), fmaxf(acc[nt][1] + b1, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(a_out + (r0 + g + 8) * kStride + col) =
              __floats2bfloat162_rn(fmaxf(acc[nt][2] + b0, 0.f), fmaxf(acc[nt][3] + b1, 0.f));
        }
      } else if (c0 == 0) {
        float acc[1][4];
        tnerf::warp_gemm<1, kLanes / 16>(a_in, sm.w, r0, 0, g, tq, acc);
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

    // Phase 4: the compositing VJP.  Thread `row` owns one sample through
    // (a), (c) and (e); thread j owns ray j's two scans (b) and (d).
    const int row = tid;
    bool valid = false;
    int j = 0, ray = 0;
    float cr = 0.f, cg_ = 0.f, cb = 0.f, sig = 0.f, tau = 0.f, dt = 0.f;
    if (row < kRows) {
      j = row / ch;
      ray = ray0 + j;
      valid = j < R && ray < B && c * ch + row % ch < S;
      if (valid) {  // (a) head activations and optical depth
        const float* h = sm.head[row];
        cr = tnerf::sigmoidf(h[0]);
        cg_ = tnerf::sigmoidf(h[1]);
        cb = tnerf::sigmoidf(h[2]);
        sig = tnerf::density_softplus(h[3]);
        dt = sm.step[row];
        tau = __fmul_rn(__fmul_rn(sig, dt), sm.m[row]);
      }
      sm.tau[row] = tau;
    }
    __syncthreads();
    if (tid < R) {  // (b) exclusive sums of tau along the ray
      float incl = 0.f;
      for (int i = 0; i < ch; ++i) {
        sm.ex[tid * ch + i] = incl;
        incl += sm.tau[tid * ch + i];
      }
      sm.Texp[tid] = expf(-incl);
    }
    __syncthreads();
    float w = 0.f, dw = 0.f, E = 0.f, emt = 1.f, T0 = 0.f, gr = 0.f, gg = 0.f, gb = 0.f;
    if (row < kRows) {  // (c) weights and their cotangent
      float G = 0.f, dEF = 0.f;
      if (valid) {
        const float* go = gout + (size_t)ray * 6;
        gr = go[0];
        gg = go[1];
        gb = go[2];
        T0 = sm.T0[j];
        E = expf(-sm.ex[row]);
        emt = expf(-tau);
        const float F = 1.f - emt;
        w = T0 * E * F;
        dw = gr * cr + gg * cg_ + gb * cb + go[3] + go[4] * sm.t[row];
        G = dw * w;
        dEF = dw * E * F;
      }
      sm.G[row] = G;
      sm.dEF[row] = dEF;
    }
    __syncthreads();
    if (tid < R) {  // (d) suffix sums of G, and the carry to the earlier chunk
      float run = 0.f, sef = 0.f;
      for (int i = ch - 1; i >= 0; --i) {
        sm.suf[tid * ch + i] = run;
        run += sm.G[tid * ch + i];
        sef += sm.dEF[tid * ch + i];
      }
      sm.gTn[tid] = sef + sm.gT[tid] * sm.Texp[tid];
    }
    __syncthreads();
    if (row < kRows) {  // (e) gradient at the last layer's output, bf16
      float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
      if (valid) {
        const float dtau = -sm.suf[row] + dw * (T0 * E * emt) - sm.gT[j] * (T0 * sm.Texp[j]);
        const float dsig = dtau * dt * sm.m[row];
        q3 = dsig * (1.f - expf(-sig));
        q0 = (w * gr) * cr * (1.f - cr);
        q1 = (w * gg) * cg_ * (1.f - cg_);
        q2 = (w * gb) * cb * (1.f - cb);
      }
      __nv_bfloat162* gp = reinterpret_cast<__nv_bfloat162*>(sm.g + row * kStride);
      gp[0] = __floats2bfloat162_rn(q0, q1);
      gp[1] = __floats2bfloat162_rn(q2, q3);
#pragma unroll
      for (int q = 2; q < 8; ++q) gp[q] = __floats2bfloat162_rn(0.f, 0.f);  // columns 4..15
    }
    __syncthreads();
    if (tid < R) sm.gT[tid] = sm.gTn[tid];

    // Phase 5: the MLP backward, last layer first.
    for (int l = n_layers - 1; l >= 0; --l) {
      const bool last = l == n_layers - 1;  // only columns 0..3 of g are set
      const __nv_bfloat16* a_in = acts + l * kTile;
      // in-major weights for the input gradient (sm.w was last read before a sync)
      if (l > 0) tnerf::stage_matrix(sm.w, wk + (size_t)l * kLanes * kLanes, tid, kThreads);
      {  // bias gradient: column sums of g, two threads (32 rows each) per column
        const int col = tid & (kLanes - 1), r_lo = (tid >> 7) * (kRows / 2);
        if (!last || col < 4) {
          float ssum = 0.f;
          for (int r = r_lo; r < r_lo + kRows / 2; ++r)
            ssum += __bfloat162float(sm.g[r * kStride + col]);
          red_add(dB + l * kLanes + col, ssum);
        }
      }
      float* dwl = dW + (size_t)l * kLanes * kLanes;
      if (last) {
        warp_wgrad<1>(a_in, sm.g, warp * 16, 0, lane, dwl, 4);
      } else {
        warp_wgrad<8>(a_in, sm.g, warp * 16, 0, lane, dwl, kLanes);
        warp_wgrad<8>(a_in, sm.g, warp * 16, 64, lane, dwl, kLanes);
      }
      if (l > 0) {
        __syncthreads();  // weights staged
        float acc[8][4];
        if (last)
          tnerf::warp_gemm<8, 1>(sm.g, sm.w, r0, c0, g, tq, acc);
        else
          tnerf::warp_gemm<8, kLanes / 16>(sm.g, sm.w, r0, c0, g, tq, acc);
        __syncthreads();  // every warp has read g
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {  // ReLU': this layer's input is the ReLU output
          const int col = c0 + nt * 8 + 2 * tq;
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(
              a_in + (r0 + g) * kStride + col);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(
              a_in + (r0 + g + 8) * kStride + col);
          *reinterpret_cast<__nv_bfloat162*>(sm.g + (r0 + g) * kStride + col) =
              __floats2bfloat162_rn(__low2float(lo) > 0.f ? acc[nt][0] : 0.f,
                                    __high2float(lo) > 0.f ? acc[nt][1] : 0.f);
          *reinterpret_cast<__nv_bfloat162*>(sm.g + (r0 + g + 8) * kStride + col) =
              __floats2bfloat162_rn(__low2float(hi) > 0.f ? acc[nt][2] : 0.f,
                                    __high2float(hi) > 0.f ? acc[nt][3] : 0.f);
        }
      }
      __syncthreads();  // g rewritten (or, after layer 0, the tiles are free)
    }
  }
}

template <bool kTmode>
int launch_backward(const void* wt, const void* wk, const float* bias, const float* gamma,
                    const float* beta, const tnerf::Placement<kTmode>& place, const float* o,
                    const float* d, const float* mask, const int32_t* words, const float* tchk,
                    const float* gout, float* dW, float* dB, int B, int S, int n_layers,
                    int use_coarse, const Coarse& cg, float term_eps, void* stream) {
  const size_t smem = sizeof(Fixed) + (size_t)n_layers * kTile * sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;  // more layers than fit a block
  cudaError_t err = cudaFuncSetAttribute(
      fused_backward_kernel<kTmode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ch = S < kRows ? S : kRows;
  const int R = kRows / ch;
  const int blocks = (B + R - 1) / R;
  fused_backward_kernel<kTmode><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(wt), reinterpret_cast<const __nv_bfloat16*>(wk),
      bias, gamma, beta, place, o, d, mask, reinterpret_cast<const uint32_t*>(words), tchk,
      gout, dW, dB, B, S, n_layers, use_coarse, cg, term_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tnerf_fused_backward(const void* wt, const void* wk, const float* bias,
                                    const float* gamma, const float* beta, const float* te,
                                    const float* dt, const float* o, const float* d,
                                    const float* mask, const int32_t* words, const float* tchk,
                                    const float* gout, float* dW, float* dB, int B, int S,
                                    int n_layers, int use_coarse, int res_c, float lo_x,
                                    float lo_y, float lo_z, float cell_x, float cell_y,
                                    float cell_z, float term_eps, void* stream) {
  return launch_backward<false>(wt, wk, bias, gamma, beta, {te, dt, nullptr, nullptr}, o, d,
                                mask, words, tchk, gout, dW, dB, B, S, n_layers, use_coarse,
                                Coarse{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z},
                                term_eps, stream);
}

// Per-sample placement: ts, dts [B, S] in the place of te, dt [B].
extern "C" int tnerf_fused_backward_tmode(const void* wt, const void* wk, const float* bias,
                                          const float* gamma, const float* beta,
                                          const float* ts, const float* dts, const float* o,
                                          const float* d, const float* mask,
                                          const int32_t* words, const float* tchk,
                                          const float* gout, float* dW, float* dB, int B, int S,
                                          int n_layers, int use_coarse, int res_c, float lo_x,
                                          float lo_y, float lo_z, float cell_x, float cell_y,
                                          float cell_z, float term_eps, void* stream) {
  return launch_backward<true>(wt, wk, bias, gamma, beta, {nullptr, nullptr, ts, dts}, o, d,
                               mask, words, tchk, gout, dW, dB, B, S, n_layers, use_coarse,
                               Coarse{res_c, lo_x, lo_y, lo_z, cell_x, cell_y, cell_z},
                               term_eps, stream);
}
