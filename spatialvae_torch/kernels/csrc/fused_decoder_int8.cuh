// The int8 decoder's backward passes for Hopper (sm_90a): K5's scale and
// gradient passes, and the modes of them that the kernel microbenchmark's
// two backward runs compute (tools/kernel_bench.py).  Included by
// fused_decoder_int8.cu (K4, K5, grouped_dw) and kernel_bench_bwd.cu, which
// compiles the microbenchmark's modes in instantiations of their own, so the
// default K5 kernels keep their code (every mode branch is `if constexpr`).
//
// Modes (template argument T1):
//   K5        the default: fused_decoder_int8.cu's header comment.
//   T1_PLAIN  `fplain_kernel` (tools/kernel_bench.py:535, pallas_call :619,
//             run `fused-plain`): the loss and gradient of one (image,
//             pt-pixel) step with its own scale.  The head's forward runs in
//             the kernel (z = cast(a1) . wht^T + bht, s = sigmoid(z)) and
//             the cotangent is the BCE's: dz2 = 0 where s(1-s) = 0, else
//             s - yt; the loss -sum(yt*max(log s, -100) + (1-yt)*max(log1p(-s),
//             -100)) rides at dfold[b][3][0].  a1 is rebuilt in f32 (no
//             residual).  sg = max|dh1| over the step / 127 + 1e-30 (the
//             group is the step: Pt = pt); dh1q = clip(round(dh1 * (1/sg)))
//             (the reciprocal rounded, then the product); dh0 =
//             bf16(da0 * (1 - a0^2)) and the dfold rows sum bf16(x0)*dh0,
//             bf16(x1)*dh0 and dh0 (the TPU's bf16 x3 . dh0 contraction;
//             bf16 products are exact in f32).  dW1, db1, dWh^T, dbh as K5.
//   T1_FIX    `bwdfix_kernel` (:714, pallas_call :766, run `bwd-fixscale`):
//             K5's gradient pass from the bf16 residual with the constant
//             scale 0.01 and no scale pass: dh1q = clip(round(dh1 * 100)),
//             dW1 = sum over steps of f32(a0q^T . dh1q) (unscaled: the
//             grouped dW kernel runs with every group's scale 1), da0 =
//             dh1q . W1q^T unscaled, dh0 = da0 * (1 - a0^2); dfold rows as
//             K5; no db1, dWh^T or dbh.

#pragma once

#include "int8_tile.cuh"

// A build-time switch that exists only for a faulty copy of `chip_smoke.py
// --limits kernel_bench`: -DSVT_KB_FIX_NO_TANH_PRIME=1 drops the (1 - a1^2)
// factor from T1_FIX's dh1.  The library is built with it at 0.
#ifndef SVT_KB_FIX_NO_TANH_PRIME
#define SVT_KB_FIX_NO_TANH_PRIME 0
#endif

namespace {

using namespace svt8;

enum BwdMode { K5 = 0, T1_PLAIN = 1, T1_FIX = 2 };

// a1 of the block's (PT, 512) columns n0 .. n0+511 in the accumulator
// layout, f32: with RECOMPUTE tanh((tile @ W1q) * (sw/127) + b1) exactly as
// the forward built it (sm.tile must hold a0q), else the bf16 residual
// a1[(b*HW + pix)*H + n] (b1 unread).  Zero for n >= H and pixels past HW.
template <bool RECOMPUTE, bool WIDE>
__device__ __forceinline__ void int8_a1(
    const Smem& sm, const int8_t* __restrict__ w1qT, float sw,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ a1_res,
    int b, int p0, int HW, int H, int n0, float (&a1)[MTILES][NTILES][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  int acc[MTILES][NTILES][4];
  if (RECOMPUTE)
    tile_gemm_s8<WIDE>(sm.tile, sm.ring, w1qT, padded_k(H), acc, sm.as, n0);
  const float scale = __fmul_rn(sw, 1.f / 127.f);
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + frag_col(warp, t, nt, c);
      const bool on = n < H;
      const float bn = on && RECOMPUTE ? b1[n] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int pix = p0 + frag_row(g, mt, c);
        float v = 0.f;
        if (on && pix < HW) {
          if (RECOMPUTE)
            v = tanhf(__fadd_rn(__fmul_rn(float(acc[mt][nt][c]), scale), bn));
          else
            v = __bfloat162float(a1_res[(size_t(b) * HW + pix) * H + n]);
        }
        a1[mt][nt][c] = v;
      }
    }
}

// dz2 = g*y*(1-y) of the block's pixels into sm.dz (and cast into sm.dzc),
// zero past HW; ends with a barrier.
template <bool BF16>
__device__ __forceinline__ void stage_dz2(const Smem& sm,
                                          const float* __restrict__ y,
                                          const float* __restrict__ gy, int b,
                                          int p0, int HW, int No) {
  const int tid = threadIdx.x;
  if (tid < No * PT) {
    const int o = tid / PT, pix = p0 + tid % PT;
    float d = 0.f;
    if (pix < HW) {
      const size_t at = (size_t(b) * No + o) * HW + pix;
      const float s = y[at];
      d = __fmul_rn(__fmul_rn(gy[at], s), __fsub_rn(1.f, s));
    }
    sm.dz[tid] = d;
    sm.dzc[tid] = operand<BF16>(d);
  }
  __syncthreads();
}

// T1_PLAIN: the head's output z (tid < No*PT) to s = sigmoid(z + bht), the
// BCE cotangent into sm.dz (and cast into sm.dzc) and this thread's loss
// term (0 past HW and for tid >= No*PT); ends with a barrier.
template <bool BF16>
__device__ __forceinline__ float stage_bce(const Smem& sm, float z,
                                           const float* __restrict__ bht,
                                           const float* __restrict__ yt,
                                           int b, int p0, int HW, int No) {
  const int tid = threadIdx.x;
  float per = 0.f;
  if (tid < No * PT) {
    const int o = tid / PT, pix = p0 + tid % PT;
    float d = 0.f;
    if (pix < HW) {
      const float s = 1.f / (1.f + expf(-__fadd_rn(z, bht[o])));
      const float y = yt[(size_t(b) * No + o) * HW + pix];
      const float ls = fmaxf(logf(s), -100.f);
      const float l1 = fmaxf(log1pf(-s), -100.f);
      per = __fadd_rn(__fmul_rn(y, ls), __fmul_rn(__fsub_rn(1.f, y), l1));
      d = __fmul_rn(s, __fsub_rn(1.f, s)) == 0.f ? 0.f : __fsub_rn(s, y);
    }
    sm.dz[tid] = d;
    sm.dzc[tid] = operand<BF16>(d);
  }
  __syncthreads();
  return per;
}

// T1_PLAIN above H = 512: the head's z over every 512-column chunk, a1
// rebuilt chunk by chunk (sm.tile holds a0q); the caller syncs before
// reusing the ring.
template <bool BF16>
__device__ __forceinline__ float head_z_wide(
    const Smem& sm, const int8_t* __restrict__ w1qT, float sw,
    const float* __restrict__ b1, const float* __restrict__ wht, int b,
    int p0, int HW, int H, int No) {
  float z = 0.f;
  for (int n0 = 0; n0 < chunk_end<true>(H); n0 += MAX_H) {
    float a1[MTILES][NTILES][4];
    int8_a1<true, true>(sm, w1qT, sw, b1, nullptr, b, p0, HW, H, n0, a1);
    z += head_dot<BF16>(a1, wht, H, No, reinterpret_cast<float*>(sm.ring),
                        n0);
  }
  return z;
}

// dh1 = (dzc^T . wht)[p][n] * (1 - a1^2)
__device__ __forceinline__ float dh1_at(const Smem& sm,
                                        const float* __restrict__ wht, int H,
                                        int No, int p, int n, float a1) {
  float da1 = 0.f;
  for (int o = 0; o < No; ++o)
    da1 = fmaf(sm.dzc[o * PT + p], __ldg(wht + size_t(o) * H + n), da1);
  return __fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(a1, a1)));
}

// ---- K5 (a): each block's max |dh1|.  T1_PLAIN: y holds the targets, the
// head's forward and the BCE cotangent are formed here (bht), gy is unused.
template <bool BF16, bool RECOMPUTE, bool WIDE, int T1 = K5>
__global__ void __launch_bounds__(NT, 1)
int8_bwd_scale_kernel(const float* __restrict__ fold,
                      const float* __restrict__ coords,
                      const int8_t* __restrict__ w1qT,
                      const float* __restrict__ sw,
                      const float* __restrict__ b1,
                      const float* __restrict__ wht,
                      const __nv_bfloat16* __restrict__ a1_res,
                      const float* __restrict__ y,
                      const float* __restrict__ gy,
                      float* __restrict__ part_max, int8_t* __restrict__ ws,
                      int HW, int H, int No, int blocks,
                      const float* __restrict__ bht) {
  static_assert(T1 != T1_FIX, "the fixed scale has no scale pass");
  static_assert(T1 != T1_PLAIN || RECOMPUTE, "fused-plain rebuilds a1");
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / blocks;
  const int p0 = (blockIdx.x % blocks) * PT;

  if (RECOMPUTE)
    first_layer_q<127, WIDE>(fold, coords, b, p0, HW, H, sm.tile, sm.as);
  if constexpr (T1 == T1_PLAIN && WIDE) {
    const float z = head_z_wide<BF16>(sm, w1qT, *sw, b1, wht, b, p0, HW, H,
                                      No);
    stage_bce<BF16>(sm, z, bht, y, b, p0, HW, No);
  }
  float mx = 0.f;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    float a1[MTILES][NTILES][4];
    int8_a1<RECOMPUTE, WIDE>(sm, w1qT, *sw, b1, a1_res, b, p0, HW, H, n0, a1);
    if constexpr (T1 == T1_PLAIN && !WIDE) {
      const float z = head_dot<BF16>(a1, wht, H, No,
                                     reinterpret_cast<float*>(sm.ring));
      stage_bce<BF16>(sm, z, bht, y, b, p0, HW, No);
    } else if constexpr (T1 == K5) {
      if (n0 == 0) stage_dz2<BF16>(sm, y, gy, b, p0, HW, No);
    }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
        if (n >= H) continue;
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const int p = frag_row(g, mt, c);
          if (p0 + p < HW)
            mx = fmaxf(mx, fabsf(dh1_at(sm, wht, H, No, p, n, a1[mt][nt][c])));
        }
      }
  }
  const float m = block_max(mx, sm.scratch);
  if (threadIdx.x == 0) part_max[blockIdx.x] = m;
}

// ---- K5 (b): quantisation with the group's scale, da0, the per-block
// partials and the workspaces, for images b0 .. b0+Bc-1 (blockIdx.x
// counts the chunk's blocks).  part_max, gscale, part_fold and part_w are
// indexed by the global block / group; aq_ws and q_ws (Bc, Kp, HWp) by the
// chunk's image.  part_fold holds 3 rows of H per block (T1_PLAIN: 4, the
// loss at [3][0]).  T1_PLAIN: y holds the targets, bht the head's bias.
// T1_FIX: part_max and part_w are unused, gscale gets 1 for every group.
template <bool BF16, bool RECOMPUTE, bool WIDE, int T1 = K5>
__global__ void __launch_bounds__(NT, 1)
int8_bwd_grad_kernel(const float* __restrict__ fold,
                     const float* __restrict__ coords,
                     const int8_t* __restrict__ w1qT,
                     const float* __restrict__ sw,
                     const float* __restrict__ b1,
                     const float* __restrict__ wht,
                     const __nv_bfloat16* __restrict__ a1_res,
                     const float* __restrict__ y,
                     const float* __restrict__ gy,
                     const int8_t* __restrict__ w1q,
                     const float* __restrict__ part_max,
                     float* __restrict__ gscale, int8_t* __restrict__ aq_ws,
                     int8_t* __restrict__ q_ws, float* __restrict__ part_fold,
                     float* __restrict__ part_w, int8_t* __restrict__ ws,
                     int b0, int HW, int H, int No, int Pt, int blocks,
                     const float* __restrict__ bht) {
  static_assert(T1 != T1_PLAIN || RECOMPUTE, "fused-plain rebuilds a1");
  static_assert(T1 != T1_FIX || !RECOMPUTE, "bwd-fixscale reads a1");
  constexpr int FROWS = T1 == T1_PLAIN ? 4 : 3;
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bl = blockIdx.x / blocks;
  const int b = b0 + bl;
  const int blk = blockIdx.x % blocks;
  const int p0 = blk * PT;
  const int Kp = padded_k(H);
  const int HWp = blocks * PT;
  const size_t gblk = size_t(b) * blocks + blk;
  const int Mw = H + No * H + No;

  first_layer_q<127, WIDE>(fold, coords, b, p0, HW, H, sm.tile, sm.as);
  tile_to_feature_major<WIDE>(sm.tile, aq_ws + size_t(bl) * Kp * HWp, p0,
                              HWp, Kp, sm.as);
  float per = 0.f;                       // T1_PLAIN: this thread's loss term
  if constexpr (T1 == T1_PLAIN && WIDE) {
    const float z = head_z_wide<BF16>(sm, w1qT, *sw, b1, wht, b, p0, HW, H,
                                      No);
    per = stage_bce<BF16>(sm, z, bht, y, b, p0, HW, No);
  }
  float sg = 0.f;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    float a1[MTILES][NTILES][4];
    int8_a1<RECOMPUTE, WIDE>(sm, w1qT, *sw, b1, a1_res, b, p0, HW, H, n0, a1);
    if constexpr (T1 == T1_PLAIN && !WIDE) {
      const float z = head_dot<BF16>(a1, wht, H, No,
                                     reinterpret_cast<float*>(sm.ring));
      per = stage_bce<BF16>(sm, z, bht, y, b, p0, HW, No);
    }
    if (n0 == 0) {
      if constexpr (T1 != T1_PLAIN) stage_dz2<BF16>(sm, y, gy, b, p0, HW, No);
      if constexpr (T1 == T1_FIX) {
        sg = 0.01f;
        if (tid == 0 && p0 % Pt == 0)
          gscale[size_t(b) * (HW / Pt) + p0 / Pt] = 1.f;
      } else {
        sg = __fadd_rn(
            __fmul_rn(group_max(part_max, b, p0, blocks, Pt), 1.f / 127.f),
            1e-30f);
        if (tid == 0 && p0 % Pt == 0)
          gscale[size_t(b) * (HW / Pt) + p0 / Pt] = __fmul_rn(sg, 1.f / 127.f);
      }
    }
    // T1_PLAIN quantises with the rounded reciprocal, T1_FIX with 1/0.01
    const float rcp = T1 == T1_FIX     ? 100.f
                      : T1 == T1_PLAIN ? __fdiv_rn(1.f, sg)
                                       : 0.f;

    // dh1q into the second tile; db1 partials from the unquantised dh1
    float col[NTILES][2];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) col[nt][0] = col[nt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const int p = frag_row(g, mt, c);
          float q = 0.f;
          if (n < H && p0 + p < HW) {
            const float dh1 = dh1_at(
                sm, wht, H, No, p, n,
                T1 == T1_FIX && SVT_KB_FIX_NO_TANH_PRIME ? 0.f : a1[mt][nt][c]);
            col[nt][c & 1] += dh1;
            const float v = T1 == K5 ? __fdiv_rn(dh1, sg) : __fmul_rn(dh1, rcp);
            q = fminf(fmaxf(qround(v), -127.f), 127.f);
          }
          if (n < Kp) sm.q[p * sm.as + n] = static_cast<int8_t>(q);
        }
      }
    if constexpr (T1 != T1_FIX) {
      float* pw = part_w + gblk * Mw;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = sum_over_g(col[nt][j]);
          const int n = n0 + frag_col(warp, t, nt, j);
          if (g == 0 && n < H) pw[n] = s;
        }
      // dWh^T partials: sum_p cast(dz2[o][p]) * cast(a1[p][n])
      for (int o = 0; o < No; ++o) {
        float s[NTILES][2];
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) s[nt][0] = s[nt][1] = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int mt = 0; mt < MTILES; ++mt)
              s[nt][c & 1] = fmaf(sm.dzc[o * PT + frag_row(g, mt, c)],
                                  operand<BF16>(a1[mt][nt][c]), s[nt][c & 1]);
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float v = sum_over_g(s[nt][j]);
            const int n = n0 + frag_col(warp, t, nt, j);
            if (g == 0 && n < H) pw[H + o * H + n] = v;
          }
      }
    }
  }
  if constexpr (T1 != T1_FIX) {
    if (tid < No) {                      // dbh partials
      float s = 0.f;
      for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
      part_w[gblk * Mw + H + No * H + tid] = s;
    }
  }
  if constexpr (T1 == T1_PLAIN) {        // the loss at dfold[b][3][0]
    const float bsum = block_sum(per, sm.scratch);
    float* pf = part_fold + gblk * FROWS * H + 3 * H;
    for (int i = tid; i < H; i += NT) pf[i] = i == 0 ? -bsum : 0.f;
  }
  __syncthreads();                       // the dh1q tile is complete
  tile_to_feature_major<WIDE>(sm.q, q_ws + size_t(bl) * Kp * HWp, p0, HWp,
                              Kp, sm.as);

  // da0 = dh1q . W1q^T on the tensor cores; dh0 with the exact a0
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    int acc[MTILES][NTILES][4];
    tile_gemm_s8<WIDE>(sm.q, sm.ring, w1q, Kp, acc, sm.as, n0);
    const float scale = __fmul_rn(sg, *sw);
    const float* f = fold + size_t(b) * 4 * H;
    float s0[NTILES][2], s1[NTILES][2], s2[NTILES][2];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) s0[nt][j] = s1[nt][j] = s2[nt][j] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = n0 + frag_col(warp, t, nt, c);
        if (i >= H) continue;
        const float w0 = f[i], w1 = f[H + i], cb = f[2 * H + i];
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const int pix = p0 + frag_row(g, mt, c);
          if (pix >= HW) continue;
          float x0 = coords[2 * pix], x1 = coords[2 * pix + 1];
          const float a0 = tanhf(first_h0(x0, x1, w0, w1, cb));
          const float da0 = T1 == T1_FIX
                                ? float(acc[mt][nt][c])
                                : __fmul_rn(float(acc[mt][nt][c]), scale);
          float dh0 = __fmul_rn(da0, __fsub_rn(1.f, __fmul_rn(a0, a0)));
          if constexpr (T1 == T1_PLAIN) {
            dh0 = rb(dh0);
            x0 = rb(x0);
            x1 = rb(x1);
          }
          s0[nt][c & 1] += x0 * dh0;
          s1[nt][c & 1] += x1 * dh0;
          s2[nt][c & 1] += dh0;
        }
      }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float r0 = sum_over_g(s0[nt][j]);
        const float r1 = sum_over_g(s1[nt][j]);
        const float r2 = sum_over_g(s2[nt][j]);
        const int i = n0 + frag_col(warp, t, nt, j);
        float* pf = part_fold + gblk * FROWS * H;
        if (g == 0 && i < H) {
          pf[i] = r0;
          pf[H + i] = r1;
          pf[2 * H + i] = r2;
        }
      }
  }
}

}  // namespace
