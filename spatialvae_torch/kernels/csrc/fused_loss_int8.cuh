// The fused int8 loss-and-gradient kernel for Hopper (sm_90a): K3, its
// kernels (the entry points are in fused_loss_int8.cu).
//
// Replaces the Pallas TPU kernel spatialvae_tpu/kernels/fused_loss_int8.py
// `_kernel` (:718, its phases `_Phases` :316, through `_lossgrad_pallas`
// :910 and the custom VJP `fused_decoder_bce_int8` :1117) in its three
// likelihood families (the loss phase `p3_bce` :387): Bernoulli, Gaussian
// and colored, with or without a pixel mask, over a tile-aligned pixel
// count (a padded image arrives padded, with a mask that is 0 on the pad),
// at every numerics setting the JAX kernel takes (the `Mode` bits below:
// the tile scale, the f32 epilogue, stochastic rounding, and the
// measurement levers, the Pade tanh, the int8 a1, db1 from the rounded tile
// and the phase cut; the forward and gradient levels and the host's weights
// select the gradient mode), and, as modes of the same two passes, the
// feature-major kernel K8 (spatialvae_tpu/kernels/fused_loss_int8_t.py
// `_kernel_t` :184: the tile scale, db1 from the rounded tile, 4-bit a0 as
// dW1's operand in its i4 mode).  At the default numerics (4-bit forward
// and gradient tiles in int8 containers, the analytic-bound gradient scale,
// a bf16 epilogue, round to nearest even), per quantisation group (one
// image x Pt pixels, 1024 at 64x64, 256 at 65x65 padded to 4352), with the
// host's W1f/h1s (per-column 4-bit w1), W1r/s4 (per-row 4-bit w1) and gb =
// max_j sum_i |wht[i, j]| + 1e-30, for the Bernoulli family:
//
//   aq  = clip(round(7 * tanh(x0*w0 + x1*w1 + c)), -7, 7)
//   a1c = cast(tanh((aq @ W1f) * h1s + b1));  s = sigmoid(a1c . wht^T + bht)
//   bce = -sum m*(y*max(log s, -100) + (1-y)*max(log1p(-s), -100))
//   dz2 = m*(s - y), 0 where s*(1-s) == 0
//   sg  = gb*mdz/7, mdz = max|dz2| + 1e-30
//   q   = (cast(dz2)^T . wht) * (1 - a1c^2, weight dtype) * 7/(gb*mdz)
//   db1 += sum q * sg;  qi = clip(round(q), -7, 7);  dW1 += (aq^T . qi) sg/7
//   dh0 = bf16(qi . W1r^T) * (1 - a0d^2), a0d = bf16(aq)*bf16(1/7), bf16
//   dfold[b] += (bf16(x0, x1, 1)^T . dh0) * sg*s4;  dfold[b,3,0] += bce
//   dWh^T += cast(dz2) . a1c;  dbh += sum dz2
//
// The other families change the loss and dz2 alone:
//   gaussian: d = m*(s - y);  loss = 0.5 * sum m*(s - y)^2
//             dz2 = d * (s*(1 - s))
//   colored (No = 2, coords chunk-permuted by the host so that a group's
//   first Pt/2 rows are its pixels' mean rows and the last Pt/2 their
//   log-variance rows; targets (B, 2, HW/2) and mask (2, HW/2) pre-paired):
//             mu = sigmoid(z2[:, u]);  lv = sigmoid(z2[:, Pt/2 + u])
//             d = mu - y;  w = d * exp(-lv);  loss = 0.5 * sum m*(d*w + lv)
//             dz2[:, u] = m * w * (mu*(1 - mu))
//             dz2[:, Pt/2 + u] = m * (0.5*(1 - d*w)) * (lv*(1 - lv))
//
// What bounds it on this card: int8 tensor-core work, 2*HW*H^2 = 2.05 G ops
// per image for each of the forward GEMM, da0 and dW1: 614 G at the galaxy
// shape B=100, 0.31 ms at the 1,979 TOP/s int8 peak, against tens of MB of
// inputs and outputs.  The TPU kernel keeps a whole 1024-pixel group on
// chip and carries dW1, db1, dWh^T, dbh and dfold across its sequential
// grid; a CUDA block owns 64 pixels and blocks run in no order.  So:
//   - `loss_fwd` (one block per 64 pixels) runs the forward, the loss and
//     dz2, and writes dz2 (B, No, HW), each block's loss and max |dz2|.  In
//     the colored family a mean row and its log-variance partner lie Pt/2
//     rows apart, in two 64-pixel tiles of one group: one block runs both
//     tiles, one after the other (half as many blocks, the same work), so a
//     thread holds both head outputs of its pair in registers and no z2
//     goes through global memory.  Each dz2 entry counts toward the maximum
//     of the 64-pixel block that holds its row, so the group's maximum is
//     the TPU's, taken over the whole (2, Pt) tile;
//   - `loss_grad` takes each group's mdz from its blocks' maxima (the TPU's
//     grouping exactly: another group size would change the numbers),
//     rebuilds the forward (one more int8 GEMM, cheaper than writing and
//     reading a (B, HW, H) a1), quantises q, runs da0 = qi . W1r^T on the
//     tensor cores, and writes per-block partials of dfold, db1, dWh^T and
//     dbh and the int8 aq and qi to feature-major workspaces;
//   - `grouped_dw` (fused_decoder_int8.cu) computes dW1 group by group: each
//     group's exact int32 product is scaled by its own sg/7 before the next
//     group is added;
//   - svt_sum_rows adds every partial in a fixed order: no atomics, the
//     gradients are bit-identical from run to run.
// The tile scale needs the group's max |dh1| before any rounding: the
// forward pass, which holds a1 and the block's complete dz2, writes each
// block's max |dh1| where the bound writes max |dz2| (the colored block
// holds the log-variance tile's a1 when its pairs' dz2 are complete, and
// runs the mean tile's forward once more for the mean rows).  Stochastic
// rounding draws Philox4x32-10 words keyed by b1[0]'s bits (int8_tile.cuh):
// the forward site's words in both passes, so the gradient pass rebuilds
// the forward's aq exactly.
// The [-7, 7] values ride int8 mma.sync m16n8k32.  ptxas takes s4
// mma.sync (m16n8k64) for sm_90a, but on an H100 it compiles each one to a
// call of a routine that unpacks the nibbles and runs two s8 IMMAs, 15x
// slower than the s8 instruction on the same values
// (spatialvae_torch/tools/probe_int4.py, the ":s4" runs); wgmma, TMA and a
// fused dW are later work.  Above H = 512 the `WIDE`
// instantiations keep the block's int8 tiles in a workspace in global
// memory and run both passes in 512-column chunks (int8_tile.cuh): the
// groups, the blocks and so the numbers stay the same.

#pragma once

#include "int8_tile.cuh"

namespace svt8 {

// The launch arguments of the two passes (the kernels' parameters below).
struct LossFwdArgs {
  const float* fold;
  const float* coords;
  const int8_t* w1fT;
  const float* h1s;
  const float* b1;
  const float* wht;
  const float* bht;
  const void* yt;
  const float* mask;
  float* dz2;
  float* part_max;
  float* part_bce;
  int8_t* ws;
  int HW, H, No, blocks, Pt, yt_i8, family;
  float lf, swht;
  int mode;
  unsigned grid;
};

struct LossGradArgs {
  const float* fold;
  const float* coords;
  const int8_t* w1fT;
  const int8_t* w1r;
  const float* h1s;
  const float* s4;
  const float* gb;
  const float* b1;
  const float* wht;
  const float* dz2;
  const float* part_max;
  float* gscale;
  int8_t* aq_ws;
  int8_t* q_ws;
  float* part_fold;
  float* part_w;
  int8_t* ws;
  int b0, HW, H, No, Pt, blocks;
  float lf, lv;
  int mode;
  float dbk, swht;
  int cut;
  unsigned grid;
};

// The launches of each instantiation set, one translation unit each so
// that nvcc builds them in parallel: the default kernels (H <= 512, no
// lever) in fused_loss_int8.cu, the levers' (H <= 512) in
// fused_loss_int8_levers.cu, the wide ones (levers read at run time) in
// fused_loss_int8_wide.cu.
// `pb`: the first pixel's row in the call whose pixel slice the launch runs
// (a pixel shard's), where SR's counters start; nothing else reads it.
cudaError_t loss_fwd_default(const LossFwdArgs& a, int pb, bool bf16,
                             bool colored, bool tile, cudaStream_t st);
cudaError_t loss_fwd_levers(const LossFwdArgs& a, int pb, bool bf16,
                            bool colored, bool tile, cudaStream_t st);
cudaError_t loss_fwd_wide(const LossFwdArgs& a, int b0, int pb, bool bf16,
                          bool colored, bool tile, cudaStream_t st);
cudaError_t loss_grad_default(const LossGradArgs& a, int pb, bool bf16,
                              bool sr, cudaStream_t st);
cudaError_t loss_grad_levers(const LossGradArgs& a, int pb, bool bf16,
                             bool sr, cudaStream_t st);
cudaError_t loss_grad_wide(const LossGradArgs& a, int pb, bool bf16, bool sr,
                           cudaStream_t st);
// The cluster passes of fused_loss_int8_sm90.cu (the default numerics at
// H <= 512, every family, pixel counts and groups multiples of 256; wider
// below): `grid`
// counts the 64-pixel blocks of the launch; and of fused_loss_int8_sm90_sr.cu
// (the same with stochastic rounding, the SR mode bit alone), with the
// clusters their kernels hold at once (0 forward bf16, 1 forward f32, 2
// gradient bf16, 3 gradient f32, 4 colored forward bf16, 5 colored f32).
cudaError_t loss_fwd_sm90(const LossFwdArgs& a, bool bf16, cudaStream_t st);
cudaError_t loss_grad_sm90(const LossGradArgs& a, bool bf16,
                           cudaStream_t st);
// SR's forward takes the first image of the launch in the call (b0: its
// counters take the absolute image) and the dW1 operand's workspace, where
// it leaves aq for the gradient pass; both SR passes take the first pixel's
// row in the call (pb: the counters take the absolute row).
cudaError_t loss_fwd_sm90_sr(const LossFwdArgs& a, int b0, int pb,
                             int8_t* aq_ws, bool bf16, cudaStream_t st);
cudaError_t loss_grad_sm90_sr(const LossGradArgs& a, int pb, bool bf16,
                              cudaStream_t st);
int loss90_sr_max_clusters(int which);
// The cluster passes past H = 512 (fused_loss_int8_sm90_wide.cu, the
// default numerics alone): the forward leaves aq in the dW1 operand's
// workspace `aq_ws`; `ws` holds each block's a1c stash of every 512-column
// chunk and the gradient pass's K-major copy of qi (svt_loss90_ws_block);
// their dW1 kernel over the R-row workspaces (svt_loss90_dw takes it past
// H = 512), and the clusters their kernels hold at once (0 forward bf16,
// 1 forward f32, 2 gradient bf16, 3 gradient f32, 4 colored forward bf16,
// 5 colored f32, 6 dW1).
cudaError_t loss_fwd_sm90_wide(const LossFwdArgs& a, int8_t* aq_ws,
                               bool bf16, cudaStream_t st);
cudaError_t loss_grad_sm90_wide(const LossGradArgs& a, bool bf16,
                                cudaStream_t st);
cudaError_t loss90_dw_wide(const int8_t* aq_ws, const int8_t* q_ws,
                           const float* gscale, float* part, int nimg, int HW,
                           int H, int Pt, int splits, cudaStream_t stream);
int loss90_wide_max_clusters(int which);

}  // namespace svt8

namespace {

using namespace svt8;

// a1 = tanh((tile @ W1f) * h1s + b1) of columns n0 .. n0+511 in the
// accumulator layout, zero for n >= H, cast to the weight dtype unless
// `keep` (the f32 epilogue keeps the f32 activation for its tanh' chain; the
// head and dWh^T then cast at use).  sm.tile holds aq.  `pade`: the Pade
// tanh; `a1q`: a1 quantised at the static tanh scale, clip(round(127 a1)),
// held as an integer-valued float.
template <bool BF16, bool WIDE>
__device__ __forceinline__ void loss_a1c(const Smem& sm,
                                         const int8_t* __restrict__ w1fT,
                                         const float* __restrict__ h1s,
                                         const float* __restrict__ b1, int H,
                                         bool keep, int n0,
                                         float (&a1c)[MTILES][NTILES][4],
                                         bool pade = false,
                                         bool a1q = false) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  int acc[MTILES][NTILES][4];
  tile_gemm_s8<WIDE>(sm.tile, sm.ring, w1fT, padded_k(H), acc, sm.as, n0);
#if SVT_A1Q_TILE_SCALE
  // the copy that places A1Q's limits: a1 at the block's own scale
  float a1s = 127.f;
  if (a1q) {
    float m = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
        if (n >= H) continue;
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const float x =
              __fadd_rn(__fmul_rn(float(acc[mt][nt][c]), h1s[n]), b1[n]);
          m = fmaxf(m, fabsf(pade ? tanh_pade(x) : tanhf(x)));
        }
      }
    m = block_max(m, sm.scratch);
    float* bc = reinterpret_cast<float*>(sm.ring);   // free until the next
    if (threadIdx.x == 0) bc[0] = m;                 // GEMM or head sum
    __syncthreads();
    a1s = __fdiv_rn(127.f, fmaxf(bc[0], 1e-30f));
    __syncthreads();
  }
#else
  constexpr float a1s = 127.f;
#endif
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + frag_col(warp, t, nt, c);
      const bool on = n < H;
      const float sc = on ? h1s[n] : 0.f, bn = on ? b1[n] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const float x = __fadd_rn(__fmul_rn(float(acc[mt][nt][c]), sc), bn);
        const float a = pade ? tanh_pade(x) : tanhf(x);
        a1c[mt][nt][c] =
            !on ? 0.f
            : a1q ? fminf(fmaxf(qround(__fmul_rn(a, a1s)), -127.f), 127.f)
            : keep ? a : operand<BF16>(a);
      }
    }
}

// The head's integer product under A1Q: sum_n whtq[o][n] * a1q[p][n] over
// columns n0 .. n0+511, with v and wht holding integers as floats, exact in
// int32 (the TPU's s8 x s8 -> s32): per-thread partials, a shuffle over the
// t lanes, the 16 warps' partials through `red` in warp order.  Returns the
// sum for tid < No*PT; the caller syncs before reusing `red`.
__device__ __forceinline__ int head_dot_int(
    const float (&v)[MTILES][NTILES][4], const float* __restrict__ wht,
    int H, int No, float* red_f, int n0) {
  int* red = reinterpret_cast<int*>(red_f);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int o = 0; o < No; ++o) {
    int part[MTILES][2];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt) part[mt][0] = part[mt][1] = 0;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
        const int w =
            n < H ? __float2int_rn(__ldg(wht + size_t(o) * H + n)) : 0;
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
          part[mt][c >> 1] += w * __float2int_rn(v[mt][nt][c]);
      }
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int s = part[mt][hf];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[(warp * MAX_NO + o) * PT + mt * 16 + g + 8 * hf] = s;
      }
  }
  __syncthreads();
  int z = 0;
  if (tid < No * PT) {
    const int o = tid / PT, p = tid % PT;
    for (int w = 0; w < WARPS; ++w) z += red[(w * MAX_NO + o) * PT + p];
  }
  return z;
}

// The head's pre-activation z (without bias) of the block's tile (sm.tile
// holds its aq): a1c and the head's partial sums chunk by chunk.  Leaves
// the last chunk's a1c in the registers: the whole layer without WIDE.
// `a1q`: the integer head (wht holds whtq), z = float(sum) * c.
template <bool BF16, bool WIDE>
__device__ __forceinline__ float tile_head(const Smem& sm,
                                           const int8_t* __restrict__ w1fT,
                                           const float* __restrict__ h1s,
                                           const float* __restrict__ b1,
                                           const float* __restrict__ wht,
                                           int H, int No, bool keep,
                                           float (&a1c)[MTILES][NTILES][4],
                                           bool pade = false,
                                           bool a1q = false, float c = 0.f) {
  float* red = reinterpret_cast<float*>(sm.ring);
  float z = 0.f;
  int zi = 0;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    loss_a1c<BF16, WIDE>(sm, w1fT, h1s, b1, H, keep, n0, a1c, pade, a1q);
    // the next chunk's GEMM starts with a barrier, after every read of red
    if (a1q) {
      zi += head_dot_int(a1c, wht, H, No, red, n0);
    } else {
      const float zc = head_dot<BF16>(a1c, wht, H, No, red, n0);
      z = WIDE ? __fadd_rn(z, zc) : zc;
    }
  }
  return a1q ? __fmul_rn(float(zi), c) : z;
}

enum Family { BERNOULLI = 0, GAUSSIAN = 1, COLORED = 2 };

// The numerics modes (kernels/config.py), bits of `mode`:
//   TILE     the gradient scale is the group's max |dh1| (else the bound)
//   EPI_F32  the tanh' and dh0 chains in f32 (else the bf16 epilogue)
//   SR       both quantisation sites round stochastically (else to nearest)
//   AQ4_WS   the dW1 workspace gets 4-bit a0 (the feature-major kernel, i4)
//   DB1_QI   db1 sums the rounded gradient tile (the feature-major kernel,
//            and the row layout's SPATIALVAE_DB1=qi with dbk = 1)
// and the measurement levers, which the `LEV` instantiations read (the
// default instantiations compile without them):
//   PADE     the Pade tanh at a0 and a1 (SPATIALVAE_TANH=pade)
//   A1Q      int8 a1, head and dz2 (SPATIALVAE_A1Q; bound scale only)
//   CUT      the gradient pass stops after phase `cut` (SPATIALVAE_PHASE_CUT)
enum Mode {
  TILE = 1, EPI_F32 = 2, SR = 4, AQ4_WS = 8, DB1_QI = 16,
  PADE = 32, A1Q = 64, CUT = 128
};
constexpr int LEVERS = PADE | A1Q | CUT;

// A test build pairs each 64-row mean tile with the tile right after it
// instead of the one half a group further (-DSVT_COLORED_PAIR_ADJACENT=1):
// the copy that places the colored family's error limits.  Two more place
// the stochastic rounding's: -DSVT_SR_SAME_SITE=1 draws the gradient site's
// words from the forward site's stream, -DSVT_SR_FLOOR=1 takes u = 0.
#ifndef SVT_COLORED_PAIR_ADJACENT
#define SVT_COLORED_PAIR_ADJACENT 0
#endif
#ifndef SVT_SR_SAME_SITE
#define SVT_SR_SAME_SITE 0
#endif
#ifndef SVT_SR_FLOOR
#define SVT_SR_FLOOR 0
#endif
// The feature-major kernel's db1 from the pre-round q instead of the rounded
// tile (-DSVT_T_DB1_PREROUND=1): the copy that places its db1 limit.
#ifndef SVT_T_DB1_PREROUND
#define SVT_T_DB1_PREROUND 0
#endif
// dh0's (1 - a0^2) from the pixel 8 rows on in the block (-DSVT_K3_DH0_ROW=1),
// every other output the sound passes': the copy that places dh0's limit
// (dfold's rows 0-2 on their own scale) in the knob modes and K8.
#ifndef SVT_K3_DH0_ROW
#define SVT_K3_DH0_ROW 0
#endif

__device__ __forceinline__ uint32_t grad_site() {
  return SVT_SR_SAME_SITE ? SITE_FWD : SITE_GRAD;
}

__device__ __forceinline__ float sr_q(float q, uint32_t bits, float lv) {
  return SVT_SR_FLOOR ? fminf(fmaxf(floorf(q), -lv), lv)
                      : sr_round(q, bits, lv);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float load_target(const void* __restrict__ yt,
                                             size_t at, bool i8) {
  return i8 ? __fmul_rn(__fadd_rn(float(static_cast<const int8_t*>(yt)[at]),
                                  128.f),
                        1.f / 255.f)
            : static_cast<const float*>(yt)[at];
}

// da1[p][n] = sum_o dzc[o][p] * wht[o][n], each product and sum rounded in
// order (the plain version's order, so q is bit for bit its q).
__device__ __forceinline__ float da1_at(const float* dzc,
                                        const float* __restrict__ wht, int p,
                                        int n, int H, int No) {
  float da1 = 0.f;
  for (int o = 0; o < No; ++o)
    da1 = __fadd_rn(da1, __fmul_rn(dzc[o * PT + p], __ldg(wht + size_t(o) * H + n)));
  return da1;
}

// The tile scale's dh1 from da1 and the a1 register: f32 epilogue (a = the
// f32 activation) da1 * (1 - a*a); bf16 epilogue (a = the weight-dtype
// activation) bf16(da1) * (1 - a*a in the weight dtype), rounded to bf16
// with bf16 weights.
template <bool BF16>
__device__ __forceinline__ float dh1_tile(float da1, float a, bool f32epi) {
  if (f32epi) return __fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(a, a)));
  const float sq = __fmul_rn(a, a);
  const float tf = BF16 ? rb(__fsub_rn(1.f, rb(sq))) : __fsub_rn(1.f, sq);
  const float v = __fmul_rn(rb(da1), tf);
  return BF16 ? rb(v) : v;
}

// The largest |dh1| of this thread's values of columns n0 .. n0+511, in
// the tile mode: dzc (No, PT) in shared memory (the caller syncs after
// writing it), a1 in the accumulator layout.
template <bool BF16>
__device__ __forceinline__ float thread_dh1_max(
    const float (&a1)[MTILES][NTILES][4], const float* dzc,
    const float* __restrict__ wht, int H, int No, bool f32epi, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float m = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + frag_col(warp, t, nt, c);
      if (n >= H) continue;
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const float da1 = da1_at(dzc, wht, frag_row(g, mt, c), n, H, No);
        m = fmaxf(m, fabsf(dh1_tile<BF16>(da1, a1[mt][nt][c], f32epi)));
      }
    }
  return m;
}

// The largest |dh1| of the block's (PT, H) values (every thread calls it;
// thread 0 gets the result).  Without WIDE a1c holds the whole layer of
// the tile in sm.tile; WIDE rebuilds a1c chunk by chunk from sm.tile.
template <bool BF16, bool WIDE>
__device__ __forceinline__ float tile_dh1_max(
    const Smem& sm, const int8_t* __restrict__ w1fT,
    const float* __restrict__ h1s, const float* __restrict__ b1,
    const float* __restrict__ wht, int H, int No, bool f32epi,
    float (&a1c)[MTILES][NTILES][4], bool pade = false) {
  float m = 0.f;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    if (WIDE)
      loss_a1c<BF16, true>(sm, w1fT, h1s, b1, H, f32epi, n0, a1c, pade);
    m = fmaxf(m, thread_dh1_max<BF16>(a1c, sm.dzc, wht, H, No, f32epi, n0));
  }
  return block_max(m, sm.scratch);
}

// ---- pass 1: forward, loss, dz2, each block's loss and the largest value
// of the scale's source (|dz2| for the bound, |dh1| for the tile mode).
// One block per 64 pixels; COLORED: one block per 64 mean rows, which also
// runs their 64 log-variance rows (grid B * HW/128).  Every sum of products
// is spelled op by op: the plain version rounds each.  The tile scale is a
// template parameter: its max |dh1| keeps a1 live past the loss, which
// would otherwise cost the bound instantiation registers.  WIDE (H > 512):
// the tile lies in the block's workspace slice and the head sums 512-column
// chunks; the tile scale rebuilds each chunk's a1 for its max |dh1|.  LEV:
// the measurement levers PADE and A1Q (swht: the int8 head's scale).
template <bool BF16, bool COLORED, bool TILE_, bool WIDE, bool LEV>
__global__ void __launch_bounds__(NT, 1)
loss_fwd_kernel(const float* __restrict__ fold,
                const float* __restrict__ coords,
                const int8_t* __restrict__ w1fT,
                const float* __restrict__ h1s, const float* __restrict__ b1,
                const float* __restrict__ wht, const float* __restrict__ bht,
                const void* __restrict__ yt, const float* __restrict__ mask,
                float* __restrict__ dz2, float* __restrict__ part_max,
                float* __restrict__ part_bce, int8_t* __restrict__ ws,
                int HW, int H, int No, int blocks, int Pt, int yt_i8,
                int family, float lf, float swht, int mode, int b0, int pb) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  const int tid = threadIdx.x;
  // SR's counters take the call's image: WIDE launches run a workspace
  // chunk of the call's images at a time, from image b0
  const int i0 = WIDE ? b0 : 0;
  const bool tile = TILE_, f32epi = mode & EPI_F32, sr = mode & SR;
  const bool pade = LEV && (mode & PADE), a1q = LEV && (mode & A1Q);
  const float hc = __fmul_rn(swht, 1.f / 127.f);   // the int8 head's step
  const uint32_t seed = __float_as_uint(b1[0]);
  float a1c[MTILES][NTILES][4];

  if (COLORED) {
    const int per_image = blocks / 2;
    const int b = blockIdx.x / per_image;
    const int i = blockIdx.x % per_image;      // which 64 mean rows
    const int half = SVT_COLORED_PAIR_ADJACENT ? PT : Pt / 2;
    const int hb = half / PT;
    const int p0 = (i / hb) * 2 * half + (i % hb) * PT;   // the mean tile
    const int p1 = p0 + half;                  // its log-variance tile
    first_layer_qx<WIDE>(fold, coords, b, i0 + b, p0, HW, H, lf, sr, seed,
                         sm.tile, nullptr, sm.as, pade, pb);
    const float zm = tile_head<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No,
                                           f32epi, a1c, pade, a1q, hc);
    // the next GEMM starts with a barrier, after every read of `red`
    first_layer_qx<WIDE>(fold, coords, b, i0 + b, p1, HW, H, lf, sr, seed,
                         sm.tile, nullptr, sm.as, pade, pb);
    const float zl = tile_head<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No,
                                           f32epi, a1c, pade, a1q, hc);
    float per = 0.f, dmu = 0.f, dlv = 0.f;
    if (tid < 2 * PT) {
      const int o = tid / PT, u = tid % PT;
      const size_t pair = size_t(i) * PT + u;  // index into (.., HW/2)
      const float mu = sigmoidf(__fadd_rn(zm, bht[o]));
      const float lv = sigmoidf(__fadd_rn(zl, bht[o]));
      const float y =
          load_target(yt, (size_t(b) * 2 + o) * (HW / 2) + pair, yt_i8);
      const float d = __fsub_rn(mu, y);
      const float w = __fmul_rn(d, expf(-lv));
      const float dw = __fmul_rn(d, w);
      per = __fadd_rn(dw, lv);
      dmu = __fmul_rn(w, __fmul_rn(mu, __fsub_rn(1.f, mu)));
      dlv = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.f, dw)),
                      __fmul_rn(lv, __fsub_rn(1.f, lv)));
      if (mask != nullptr) {
        const float m = mask[size_t(o) * (HW / 2) + pair];
        per = __fmul_rn(per, m);
        dmu = __fmul_rn(dmu, m);
        dlv = __fmul_rn(dlv, m);
      }
      float* row = dz2 + (size_t(b) * 2 + o) * HW;
      row[p0 + u] = dmu;
      row[p1 + u] = dlv;
    }
    const float bsum = block_sum(per, sm.scratch);
    float mmax, lmax;
    if (tile) {
      // the registers (WIDE: sm.tile) hold the log-variance tile: its
      // |dh1| first, then the mean tile's forward once more for the mean
      // rows' |dh1|
      if (tid < 2 * PT) sm.dzc[tid] = operand<BF16>(dlv);
      __syncthreads();
      lmax = tile_dh1_max<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No, f32epi,
                                      a1c, pade);
      first_layer_qx<WIDE>(fold, coords, b, i0 + b, p0, HW, H, lf, sr, seed,
                           sm.tile, nullptr, sm.as, pade, pb);
      if (!WIDE)
        loss_a1c<BF16, false>(sm, w1fT, h1s, b1, H, f32epi, 0, a1c, pade);
      if (tid < 2 * PT) sm.dzc[tid] = operand<BF16>(dmu);
      __syncthreads();
      mmax = tile_dh1_max<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No, f32epi,
                                      a1c, pade);
    } else {
      mmax = block_max(fabsf(dmu), sm.scratch);
      lmax = block_max(fabsf(dlv), sm.scratch);
    }
    if (tid == 0) {
      const size_t at = size_t(b) * blocks;
      part_bce[at + p0 / PT] = __fmul_rn(0.5f, bsum);
      part_bce[at + p1 / PT] = 0.f;
      part_max[at + p0 / PT] = mmax;
      part_max[at + p1 / PT] = lmax;
    }
    return;
  }

  const int b = blockIdx.x / blocks;
  const int p0 = (blockIdx.x % blocks) * PT;
  first_layer_qx<WIDE>(fold, coords, b, i0 + b, p0, HW, H, lf, sr, seed,
                       sm.tile, nullptr, sm.as, pade, pb);
  const float z = tile_head<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No, f32epi,
                                        a1c, pade, a1q, hc);
  float per = 0.f, d = 0.f;
  if (tid < No * PT) {
    const int o = tid / PT, pix = p0 + tid % PT;
    const size_t at = (size_t(b) * No + o) * HW + pix;
    const float s = sigmoidf(__fadd_rn(z, bht[o]));
    const float y = load_target(yt, at, yt_i8);
    const float m = mask != nullptr ? mask[pix] : 1.f;
    if (family == GAUSSIAN) {
      d = __fsub_rn(s, y);
      per = __fmul_rn(d, d);
      if (mask != nullptr) {
        per = __fmul_rn(per, m);
        d = __fmul_rn(d, m);
      }
      d = __fmul_rn(d, __fmul_rn(s, __fsub_rn(1.f, s)));
    } else {
      const float ls = fmaxf(logf(s), -100.f);
      const float l1 = fmaxf(log1pf(-s), -100.f);
      per = __fadd_rn(__fmul_rn(y, ls), __fmul_rn(__fsub_rn(1.f, y), l1));
      d = __fmul_rn(s, __fsub_rn(1.f, s)) == 0.f ? 0.f : __fsub_rn(s, y);
      if (mask != nullptr) {
        per = __fmul_rn(per, m);
        d = __fmul_rn(d, m);
      }
    }
    dz2[at] = d;
    if (tile) sm.dzc[tid] = operand<BF16>(d);
  }
  const float bsum = block_sum(per, sm.scratch);
  const float bmax =
      tile ? tile_dh1_max<BF16, WIDE>(sm, w1fT, h1s, b1, wht, H, No, f32epi,
                                      a1c, pade)
           : block_max(fabsf(d), sm.scratch);
  if (tid == 0) {
    part_bce[blockIdx.x] = family == GAUSSIAN ? __fmul_rn(0.5f, bsum) : -bsum;
    part_max[blockIdx.x] = bmax;
  }
}

// ---- pass 2: quantisation with the group's scale, da0, the per-block
// partials and the workspaces, for images b0 .. b0+Bc-1 (blockIdx.x counts
// the chunk's blocks; part_*, gscale are indexed globally, the workspaces
// (Bc, Kp, HW) by the chunk's image).  lf, lv: the forward and gradient
// levels (7 or 127); dbk: DB1_QI's pad-row constant.  SR is a template
// parameter here alone: its Philox words would otherwise hold registers in
// the round-to-nearest instantiation's quantisation loop.  WIDE (H > 512):
// the tiles lie in the block's workspace slice, and the quantisation and
// da0 run in 512-column chunks.  LEV: the measurement levers (PADE; A1Q with
// swht the int8 head's scale, wht holding whtq and gb the bound over it;
// CUT, stopping after phase `cut`: 4 dWh^T, 5 q, db1 and dbh, 6-7 the dW1
// workspaces, 8 da0 and dfold).
template <bool BF16, bool SR_, bool WIDE, bool LEV>
__global__ void __launch_bounds__(NT, 1)
loss_grad_kernel(const float* __restrict__ fold,
                 const float* __restrict__ coords,
                 const int8_t* __restrict__ w1fT,
                 const int8_t* __restrict__ w1r,
                 const float* __restrict__ h1s, const float* __restrict__ s4,
                 const float* __restrict__ gb, const float* __restrict__ b1,
                 const float* __restrict__ wht,
                 const float* __restrict__ dz2,
                 const float* __restrict__ part_max,
                 float* __restrict__ gscale, int8_t* __restrict__ aq_ws,
                 int8_t* __restrict__ q_ws, float* __restrict__ part_fold,
                 float* __restrict__ part_w, int8_t* __restrict__ ws, int b0,
                 int HW, int H, int No, int Pt, int blocks, float lf,
                 float lv, int mode, float dbk, float swht, int cut,
                 int pb) {
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
  const size_t gblk = size_t(b) * blocks + blk;
  const int Mw = H + No * H + No;
  const bool tile = mode & TILE, f32epi = mode & EPI_F32, sr = SR_;
  const bool aq4 = mode & AQ4_WS, db1_qi = mode & DB1_QI;
  const bool pade = LEV && (mode & PADE), a1q = LEV && (mode & A1Q);
  const int kcut = LEV && (mode & CUT) ? cut : 8;
  const uint32_t seed = __float_as_uint(b1[0]);

  // aq (the forward's words again: the same tile as pass 1), and the dW1
  // operand to its workspace
  first_layer_qx<WIDE>(fold, coords, b, b, p0, HW, H, lf, sr, seed, sm.tile,
                       aq4 ? sm.q : nullptr, sm.as, pade, pb);
  __syncthreads();
  if (kcut >= 6)
    tile_to_feature_major<WIDE>(aq4 ? sm.q : sm.tile,
                                aq_ws + size_t(bl) * Kp * HW, p0, HW, Kp,
                                sm.as);
  float qs = 0.f, sg = 0.f, dws = 0.f;
  float* pw = part_w + gblk * Mw;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    float a1c[MTILES][NTILES][4];
    loss_a1c<BF16, WIDE>(sm, w1fT, h1s, b1, H, f32epi, n0, a1c, pade, a1q);
    if (n0 == 0) {
      // A1Q quantises dz2 by the group's max |dz2| (the bound's source)
      float gmax = 0.f;
      if (LEV) gmax = group_max(part_max, b, p0, blocks, Pt);
      const float dq = a1q ? __fdiv_rn(127.f, __fadd_rn(gmax, 1e-30f)) : 0.f;
      if (tid < No * PT) {
        const int o = tid / PT, pix = p0 + tid % PT;
        const float d = dz2[(size_t(b) * No + o) * HW + pix];
        sm.dz[tid] = d;
        sm.dzc[tid] = a1q ? fminf(fmaxf(qround(__fmul_rn(d, dq)), -127.f),
                                  127.f)
                          : operand<BF16>(d);
      }
      __syncthreads();

      // the group's scale: qs multiplies, sg dequantises
      if (!LEV) gmax = group_max(part_max, b, p0, blocks, Pt);
      if (!tile) {
        const float gm = __fmul_rn(*gb, __fadd_rn(gmax, 1e-30f));
        qs = __fdiv_rn(7.f, gm);
        sg = __fmul_rn(gm, 1.f / 7.f);
      } else if (f32epi) {
        const float maxv = __fadd_rn(gmax, 1e-30f);
        qs = __fdiv_rn(lv, maxv);
        sg = __fmul_rn(maxv, __fdiv_rn(1.f, lv));
      } else {
        qs = rb(__fdiv_rn(lv, __fadd_rn(gmax, 1e-30f)));
        sg = __fdiv_rn(1.f, qs);
      }
      if (a1q) {
        // the int8 da1's and dWh^T's dequantisation: sdz = mdz/127 folds
        // into the quantisation scale with swht (the JAX cfac)
        const float sdz = __fmul_rn(__fadd_rn(gmax, 1e-30f), 1.f / 127.f);
        qs = __fmul_rn(qs, __fmul_rn(sdz, swht));
        dws = __fmul_rn(sdz, 1.f / 127.f);
      }
      if (tid == 0 && p0 % Pt == 0)
        gscale[size_t(b) * (HW / Pt) + p0 / Pt] =
            __fmul_rn(sg, __fdiv_rn(1.f, aq4 ? 7.f : lf));
    }

    if (kcut >= 5) {          // phase 5: q, db1 and the qi tile
      // q, the column sums behind db1 and qi into the second tile; one
      // Philox call per (row, 4 columns) serves this thread's two columns
      float col[NTILES][2];
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) col[nt][0] = col[nt][1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = mt * 16 + g + 8 * hf;
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (sr)
              w = philox4x32_10(
                  make_uint4(b, pb + p0 + p,
                             (n0 + warp * WN + nt * 8) / 4 + t / 2, 0u),
                  seed, grad_site());
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * hf + e;
              const int n = n0 + frag_col(warp, t, nt, c);
              float qi = 0.f;
              if (n < H) {
                const float da1 = da1_at(sm.dzc, wht, p, n, H, No);
                const float a = a1c[mt][nt][c];
                float q, src;
                if (!tile) {
                  // A1Q: tanh' from the int8 a1, 1 - (a1q/127)^2 in f32
                  const float ad = a1q ? __fmul_rn(a, 1.f / 127.f) : a;
                  const float tf =
                      (f32epi || a1q) ? __fsub_rn(1.f, __fmul_rn(ad, ad))
                      : (BF16 ? rb(__fsub_rn(1.f, rb(__fmul_rn(a, a))))
                              : __fsub_rn(1.f, __fmul_rn(a, a)));
                  q = __fmul_rn(__fmul_rn(da1, tf), qs);
                  src = q;
                } else {
                  const float dh1 = dh1_tile<BF16>(da1, a, f32epi);
                  q = __fmul_rn(dh1, qs);
                  if (BF16 && !f32epi) q = rb(q);
                  src = dh1;
                }
                qi = sr ? sr_q(q, word_of(w, 2 * (t & 1) + e), lv)
                        : fminf(fmaxf(qround(q), -lv), lv);
                col[nt][e] += db1_qi ? (SVT_T_DB1_PREROUND ? q : qi) : src;
              }
              if (n < Kp) sm.q[p * sm.as + n] = static_cast<int8_t>(qi);
            }
          }
      // db1 partials: bound sum q * sg; tile sum dh1; DB1_QI (K * sum qi) *
      // (sg / lv), which the host multiplies by lv / K
      const float dscale = !tile ? sg
                           : db1_qi ? __fmul_rn(sg, __fdiv_rn(1.f, lv)) : 1.f;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = sum_over_g(col[nt][j]);
          if (db1_qi) s = __fmul_rn(dbk, s);
          const int n = n0 + frag_col(warp, t, nt, j);
          if (g == 0 && n < H)
            pw[n] = tile && !db1_qi ? s : __fmul_rn(s, dscale);
        }
    }
    // dWh^T partials: sum_p cast(dz2[o][p]) * a1c[p][n]
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
                                operand<BF16>(a1c[mt][nt][c]), s[nt][c & 1]);
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = sum_over_g(s[nt][j]);
          const int n = n0 + frag_col(warp, t, nt, j);
          if (g == 0 && n < H)
            pw[H + o * H + n] = a1q ? __fmul_rn(v, dws) : v;
        }
    }
  }
  if (tid < No && kcut >= 5) {             // dbh partials
    float s = 0.f;
    for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
    pw[H + No * H + tid] = s;
  }
  if (kcut < 6) return;                    // a cut before phase 6
  __syncthreads();                         // the qi tile is complete
  tile_to_feature_major<WIDE>(sm.q, q_ws + size_t(bl) * Kp * HW, p0, HW, Kp,
                              sm.as);
  if (kcut < 8) return;                    // dfold's phases 7, 8 cut

  // da0 = qi . W1r^T on the tensor cores, then the dh0 chain: bf16, or f32
  // rounded to bf16 at its end
  const float inv = __fdiv_rn(1.f, lf);
  const float cinv = rb(inv);
  float* pf = part_fold + gblk * 3 * H;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    int acc[MTILES][NTILES][4];
    tile_gemm_s8<WIDE>(sm.q, sm.ring, w1r, Kp, acc, sm.as, n0);
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
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const int p = frag_row(g, mt, c);
          const int pix = p0 + p;
          const float aqv =
              float(sm.tile[(SVT_K3_DH0_ROW ? p ^ 8 : p) * sm.as + i]);
          float dh0;
          if (f32epi) {
            const float a0d = __fmul_rn(aqv, inv);
            dh0 = rb(__fmul_rn(float(acc[mt][nt][c]),
                               __fsub_rn(1.f, __fmul_rn(a0d, a0d))));
          } else {
            const float a0d = rb(__fmul_rn(aqv, cinv));
            const float tt = rb(__fsub_rn(1.f, rb(__fmul_rn(a0d, a0d))));
            dh0 = rb(__fmul_rn(rb(float(acc[mt][nt][c])), tt));
          }
          s0[nt][c & 1] = fmaf(rb(coords[2 * pix]), dh0, s0[nt][c & 1]);
          s1[nt][c & 1] = fmaf(rb(coords[2 * pix + 1]), dh0, s1[nt][c & 1]);
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
        if (g == 0 && i < H) {
          const float dsc = __fmul_rn(sg, s4[i]);
          pf[i] = __fmul_rn(r0, dsc);
          pf[H + i] = __fmul_rn(r1, dsc);
          pf[2 * H + i] = __fmul_rn(r2, dsc);
        }
      }
  }
}

template <bool BF16, bool COLORED, bool TILE_, bool WIDE, bool LEV>
cudaError_t launch_fwd(const LossFwdArgs& a, int b0, int pb,
                       cudaStream_t st) {
  auto k = loss_fwd_kernel<BF16, COLORED, TILE_, WIDE, LEV>;
  const int smem = WIDE ? SMEM_WIDE : SMEM;
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<a.grid, NT, smem, st>>>(a.fold, a.coords, a.w1fT, a.h1s, a.b1, a.wht,
                              a.bht, a.yt, a.mask, a.dz2, a.part_max,
                              a.part_bce, a.ws, a.HW, a.H, a.No, a.blocks,
                              a.Pt, a.yt_i8, a.family, a.lf, a.swht, a.mode,
                              b0, pb);
  return cudaGetLastError();
}

template <bool WIDE, bool LEV>
cudaError_t dispatch_fwd(const LossFwdArgs& a, int b0, int pb, bool bf16,
                         bool colored, bool tile, cudaStream_t st) {
  if (bf16) {
    if (colored)
      return tile ? launch_fwd<true, true, true, WIDE, LEV>(a, b0, pb, st)
                  : launch_fwd<true, true, false, WIDE, LEV>(a, b0, pb, st);
    return tile ? launch_fwd<true, false, true, WIDE, LEV>(a, b0, pb, st)
                : launch_fwd<true, false, false, WIDE, LEV>(a, b0, pb, st);
  }
  if (colored)
    return tile ? launch_fwd<false, true, true, WIDE, LEV>(a, b0, pb, st)
                : launch_fwd<false, true, false, WIDE, LEV>(a, b0, pb, st);
  return tile ? launch_fwd<false, false, true, WIDE, LEV>(a, b0, pb, st)
              : launch_fwd<false, false, false, WIDE, LEV>(a, b0, pb, st);
}

template <bool BF16, bool SR_, bool WIDE, bool LEV>
cudaError_t launch_grad(const LossGradArgs& a, int pb, cudaStream_t st) {
  auto k = loss_grad_kernel<BF16, SR_, WIDE, LEV>;
  const int smem = WIDE ? SMEM_WIDE : SMEM;
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  k<<<a.grid, NT, smem, st>>>(a.fold, a.coords, a.w1fT, a.w1r, a.h1s, a.s4,
                              a.gb, a.b1, a.wht, a.dz2, a.part_max, a.gscale,
                              a.aq_ws, a.q_ws, a.part_fold, a.part_w, a.ws,
                              a.b0, a.HW, a.H, a.No, a.Pt, a.blocks, a.lf,
                              a.lv, a.mode, a.dbk, a.swht, a.cut, pb);
  return cudaGetLastError();
}

template <bool WIDE, bool LEV>
cudaError_t dispatch_grad(const LossGradArgs& a, int pb, bool bf16,
                          bool sr, cudaStream_t st) {
  if (bf16)
    return sr ? launch_grad<true, true, WIDE, LEV>(a, pb, st)
              : launch_grad<true, false, WIDE, LEV>(a, pb, st);
  return sr ? launch_grad<false, true, WIDE, LEV>(a, pb, st)
            : launch_grad<false, false, WIDE, LEV>(a, pb, st);
}

}  // namespace
