// The fused int8 loss-and-gradient kernel for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel spatialvae_tpu/kernels/fused_loss_int8.py
// `_kernel` (:718, its phases `_Phases` :316, through `_lossgrad_pallas`
// :910 and the custom VJP `fused_decoder_bce_int8` :1117) in its three
// likelihood families (the loss phase `p3_bce` :387): Bernoulli, Gaussian
// and colored, with or without a pixel mask, over a tile-aligned pixel
// count (a padded image arrives padded, with a mask that is 0 on the pad),
// at the default numerics (4-bit forward and gradient tiles in int8
// containers, the analytic-bound gradient scale, a bf16 epilogue, round to
// nearest even).  Per quantisation group (one image x Pt pixels, 1024 at
// 64x64, 256 at 65x65 padded to 4352), with the host's W1f/h1s (per-column
// 4-bit w1), W1r/s4 (per-row 4-bit w1) and gb = max_j sum_i |wht[i, j]| +
// 1e-30, for the Bernoulli family:
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
// The [-7, 7] values ride int8 mma.sync m16n8k32 (Hopper has no s4 MMA);
// wgmma, TMA and a fused dW are later work.

#include "int8_tile.cuh"

namespace {

using namespace svt8;

// a1c = cast(tanh((tile @ W1f) * h1s + b1)) in the accumulator layout, zero
// for n >= H.  tile holds aq.
template <bool BF16>
__device__ __forceinline__ void loss_a1c(const Smem& sm,
                                         const int8_t* __restrict__ w1fT,
                                         const float* __restrict__ h1s,
                                         const float* __restrict__ b1, int H,
                                         float (&a1c)[MTILES][NTILES][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  int acc[MTILES][NTILES][4];
  tile_gemm_s8(sm.tile, sm.ring, w1fT, padded_k(H), acc);
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = frag_col(warp, t, nt, c);
      const bool on = n < H;
      const float sc = on ? h1s[n] : 0.f, bn = on ? b1[n] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt)
        a1c[mt][nt][c] =
            on ? operand<BF16>(tanhf(__fadd_rn(
                     __fmul_rn(float(acc[mt][nt][c]), sc), bn)))
               : 0.f;
    }
}

enum Family { BERNOULLI = 0, GAUSSIAN = 1, COLORED = 2 };

// A test build pairs each 64-row mean tile with the tile right after it
// instead of the one half a group further (-DSVT_COLORED_PAIR_ADJACENT=1):
// the copy that places the colored family's error limits.
#ifndef SVT_COLORED_PAIR_ADJACENT
#define SVT_COLORED_PAIR_ADJACENT 0
#endif

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

// ---- pass 1: forward, loss, dz2, each block's loss and max |dz2|.  One
// block per 64 pixels; COLORED: one block per 64 mean rows, which also runs
// their 64 log-variance rows (grid B * HW/128).  Every sum of products is
// spelled op by op: the plain version rounds each.
template <bool BF16, bool COLORED>
__global__ void __launch_bounds__(NT, 1)
loss_fwd_kernel(const float* __restrict__ fold,
                const float* __restrict__ coords,
                const int8_t* __restrict__ w1fT,
                const float* __restrict__ h1s, const float* __restrict__ b1,
                const float* __restrict__ wht, const float* __restrict__ bht,
                const void* __restrict__ yt, const float* __restrict__ mask,
                float* __restrict__ dz2, float* __restrict__ part_max,
                float* __restrict__ part_bce, int HW, int H, int No,
                int blocks, int Pt, int yt_i8, int family) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve(smem4);
  const int tid = threadIdx.x;
  float* red = reinterpret_cast<float*>(sm.ring);
  float a1c[MTILES][NTILES][4];

  if (COLORED) {
    const int per_image = blocks / 2;
    const int b = blockIdx.x / per_image;
    const int i = blockIdx.x % per_image;      // which 64 mean rows
    const int half = SVT_COLORED_PAIR_ADJACENT ? PT : Pt / 2;
    const int hb = half / PT;
    const int p0 = (i / hb) * 2 * half + (i % hb) * PT;   // the mean tile
    const int p1 = p0 + half;                  // its log-variance tile
    first_layer_q<7>(fold, coords, b, p0, HW, H, sm.tile);
    loss_a1c<BF16>(sm, w1fT, h1s, b1, H, a1c);
    const float zm = head_dot(a1c, wht, H, No, red);
    // the next GEMM starts with a barrier, after every read of `red`
    first_layer_q<7>(fold, coords, b, p1, HW, H, sm.tile);
    loss_a1c<BF16>(sm, w1fT, h1s, b1, H, a1c);
    const float zl = head_dot(a1c, wht, H, No, red);
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
    const float mmax = block_max(fabsf(dmu), sm.scratch);
    const float lmax = block_max(fabsf(dlv), sm.scratch);
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
  first_layer_q<7>(fold, coords, b, p0, HW, H, sm.tile);
  loss_a1c<BF16>(sm, w1fT, h1s, b1, H, a1c);
  const float z = head_dot(a1c, wht, H, No, red);
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
  }
  const float bsum = block_sum(per, sm.scratch);
  const float bmax = block_max(fabsf(d), sm.scratch);
  if (tid == 0) {
    part_bce[blockIdx.x] = family == GAUSSIAN ? __fmul_rn(0.5f, bsum) : -bsum;
    part_max[blockIdx.x] = bmax;
  }
}

// ---- pass 2: quantisation with the group's scale, da0, the per-block
// partials and the workspaces, for images b0 .. b0+Bc-1 (blockIdx.x counts
// the chunk's blocks; part_*, gscale are indexed globally, the workspaces
// (Bc, Kp, HW) by the chunk's image).
template <bool BF16>
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
                 float* __restrict__ part_w, int b0, int HW, int H, int No,
                 int Pt, int blocks) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve(smem4);
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

  first_layer_q<7>(fold, coords, b, p0, HW, H, sm.tile);
  tile_to_feature_major(sm.tile, aq_ws + size_t(bl) * Kp * HW, p0, HW, Kp);
  float a1c[MTILES][NTILES][4];
  loss_a1c<BF16>(sm, w1fT, h1s, b1, H, a1c);
  if (tid < No * PT) {
    const int o = tid / PT, pix = p0 + tid % PT;
    const float d = dz2[(size_t(b) * No + o) * HW + pix];
    sm.dz[tid] = d;
    sm.dzc[tid] = operand<BF16>(d);
  }
  __syncthreads();

  const float mdz =
      __fadd_rn(group_max(part_max, b, p0, blocks, Pt), 1e-30f);
  const float gm = __fmul_rn(*gb, mdz);
  const float qs = __fdiv_rn(7.f, gm);
  const float sg = __fmul_rn(gm, 1.f / 7.f);
  if (tid == 0 && p0 % Pt == 0)
    gscale[size_t(b) * (HW / Pt) + p0 / Pt] = __fmul_rn(sg, 1.f / 7.f);

  // q, its column sums (db1) and qi into the second tile
  float col[NTILES][2];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt) col[nt][0] = col[nt][1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = frag_col(warp, t, nt, c);
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int p = frag_row(g, mt, c);
        float qi = 0.f;
        if (n < H) {
          float da1 = 0.f;
          for (int o = 0; o < No; ++o)
            da1 = fmaf(sm.dzc[o * PT + p], __ldg(wht + size_t(o) * H + n),
                       da1);
          const float a = a1c[mt][nt][c];
          const float sq = __fmul_rn(a, a);
          const float tf = BF16 ? rb(__fsub_rn(1.f, rb(sq)))
                                : __fsub_rn(1.f, sq);
          const float q = __fmul_rn(__fmul_rn(da1, tf), qs);
          col[nt][c & 1] += q;
          qi = fminf(fmaxf(qround(q), -7.f), 7.f);
        }
        if (n < Kp) sm.q[p * AS + n] = static_cast<int8_t>(qi);
      }
    }
  float* pw = part_w + gblk * Mw;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float s = sum_over_g(col[nt][j]);
      const int n = frag_col(warp, t, nt, j);
      if (g == 0 && n < H) pw[n] = __fmul_rn(s, sg);
    }
  // dWh^T partials: sum_p cast(dz2[o][p]) * a1c[p][n]; dbh partials
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
                              a1c[mt][nt][c], s[nt][c & 1]);
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = sum_over_g(s[nt][j]);
        const int n = frag_col(warp, t, nt, j);
        if (g == 0 && n < H) pw[H + o * H + n] = v;
      }
  }
  if (tid < No) {
    float s = 0.f;
    for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
    pw[H + No * H + tid] = s;
  }
  __syncthreads();                       // the qi tile is complete
  tile_to_feature_major(sm.q, q_ws + size_t(bl) * Kp * HW, p0, HW, Kp);

  // da0 = qi . W1r^T on the tensor cores, then the bf16 dh0 chain
  int acc[MTILES][NTILES][4];
  tile_gemm_s8(sm.q, sm.ring, w1r, Kp, acc);
  const float c7 = rb(1.f / 7.f);
  float s0[NTILES][2], s1[NTILES][2], s2[NTILES][2];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) s0[nt][j] = s1[nt][j] = s2[nt][j] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = frag_col(warp, t, nt, c);
      if (i >= H) continue;
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int p = frag_row(g, mt, c);
        const int pix = p0 + p;
        const float a0d = rb(__fmul_rn(float(sm.tile[p * AS + i]), c7));
        const float tt = rb(__fsub_rn(1.f, rb(__fmul_rn(a0d, a0d))));
        const float dh0 = rb(__fmul_rn(rb(float(acc[mt][nt][c])), tt));
        s0[nt][c & 1] = fmaf(rb(coords[2 * pix]), dh0, s0[nt][c & 1]);
        s1[nt][c & 1] = fmaf(rb(coords[2 * pix + 1]), dh0, s1[nt][c & 1]);
        s2[nt][c & 1] += dh0;
      }
    }
  float* pf = part_fold + gblk * 3 * H;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float r0 = sum_over_g(s0[nt][j]);
      const float r1 = sum_over_g(s1[nt][j]);
      const float r2 = sum_over_g(s2[nt][j]);
      const int i = frag_col(warp, t, nt, j);
      if (g == 0 && i < H) {
        const float dsc = __fmul_rn(sg, s4[i]);
        pf[i] = __fmul_rn(r0, dsc);
        pf[H + i] = __fmul_rn(r1, dsc);
        pf[2 * H + i] = __fmul_rn(r2, dsc);
      }
    }
}

bool bad_shape(int B, int HW, int H, int No) {
  return B < 1 || HW < PT || HW % PT || H < 1 || H > MAX_H || No < 1 ||
         No > MAX_NO || double(B) * (HW / PT) > 2147483647.0;
}

}  // namespace

extern "C" {

// Pass 1.  fold (B,4,H), coords (HW,2), h1s (H), b1 (H), wht (No,H), bht
// (No): float32; w1fT (Kp,Kp) int8, rows of W1f^T zero-padded; yt (B,No,HW)
// int8 (k-128, `yt_i8`) or float32; mask (HW) float32 or null; dz2
// (B,No,HW), part_max and part_bce (B*HW/64) float32 out.  `family`: 0
// Bernoulli, 1 Gaussian, 2 colored; colored takes No = 2, Pt a multiple of
// 128 that divides HW, coords chunk-permuted, yt (B,2,HW/2) and mask
// (2,HW/2) pre-paired.
int svt_loss_int8_fwd(const void* fold, const void* coords, const void* w1fT,
                      const void* h1s, const void* b1, const void* wht,
                      const void* bht, const void* yt, const void* mask,
                      void* dz2, void* part_max, void* part_bce, int B,
                      int HW, int H, int No, int Pt, int yt_i8, int family,
                      int bf16, void* stream) {
  if (bad_shape(B, HW, H, No) || family < BERNOULLI || family > COLORED)
    return int(cudaErrorInvalidValue);
  const bool colored = family == COLORED;
  if (colored && (No != 2 || Pt < 2 * PT || Pt % (2 * PT) || HW % Pt))
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  const unsigned grid = unsigned(B) * unsigned(colored ? blocks / 2 : blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_LFWD(B16, COL)                                                 \
  do {                                                                     \
    auto k = loss_fwd_kernel<B16, COL>;                                    \
    cudaError_t err = allow_smem(k, SMEM);                                 \
    if (err != cudaSuccess) return int(err);                               \
    k<<<grid, NT, SMEM, st>>>(                                             \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1fT), static_cast<const float*>(h1s),  \
        static_cast<const float*>(b1), static_cast<const float*>(wht),     \
        static_cast<const float*>(bht), yt,                                \
        static_cast<const float*>(mask), static_cast<float*>(dz2),         \
        static_cast<float*>(part_max), static_cast<float*>(part_bce), HW,  \
        H, No, blocks, Pt, yt_i8, family);                                 \
  } while (0)
  if (bf16) {
    if (colored) SVT_LFWD(true, true); else SVT_LFWD(true, false);
  } else {
    if (colored) SVT_LFWD(false, true); else SVT_LFWD(false, false);
  }
#undef SVT_LFWD
  return int(cudaGetLastError());
}

// Pass 2 for images b0 .. b0+Bc-1.  w1r (Kp,Kp) int8: rows of W1r
// zero-padded; s4 (H) and gb (1) float32; gscale (B*HW/Pt) gets each
// group's dW scale sg/7; aq_ws, q_ws (Bc, Kp, HW) int8; part_fold
// (B*HW/64, 3, H) and part_w (B*HW/64, H + No*H + No) float32.
int svt_loss_int8_grad(const void* fold, const void* coords, const void* w1fT,
                       const void* w1r, const void* h1s, const void* s4,
                       const void* gb, const void* b1, const void* wht,
                       const void* dz2, const void* part_max, void* gscale,
                       void* aq_ws, void* q_ws, void* part_fold,
                       void* part_w, int b0, int Bc, int HW, int H, int No,
                       int Pt, int bf16, void* stream) {
  if (bad_shape(Bc, HW, H, No) || b0 < 0 || Pt < PT || Pt % PT || HW % Pt)
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_LGRAD(B16)                                                     \
  do {                                                                     \
    auto k = loss_grad_kernel<B16>;                                        \
    cudaError_t err = allow_smem(k, SMEM);                                 \
    if (err != cudaSuccess) return int(err);                               \
    k<<<unsigned(Bc) * unsigned(blocks), NT, SMEM, st>>>(                  \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1fT), static_cast<const int8_t*>(w1r), \
        static_cast<const float*>(h1s), static_cast<const float*>(s4),     \
        static_cast<const float*>(gb), static_cast<const float*>(b1),      \
        static_cast<const float*>(wht), static_cast<const float*>(dz2),    \
        static_cast<const float*>(part_max), static_cast<float*>(gscale),  \
        static_cast<int8_t*>(aq_ws), static_cast<int8_t*>(q_ws),           \
        static_cast<float*>(part_fold), static_cast<float*>(part_w), b0,   \
        HW, H, No, Pt, blocks);                                            \
  } while (0)
  if (bf16) SVT_LGRAD(true); else SVT_LGRAD(false);
#undef SVT_LGRAD
  return int(cudaGetLastError());
}

}  // extern "C"
