// Fused spatial-decoder tail, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spatialvae_tpu/kernels/fused_decoder.py
// `_bwd_kernel` (reached through `_bwd_pallas` and the custom VJP's
// `_vjp_bwd`), in both variants: a_1..a_Lh from the forward's residual, or
// recomputed (the caller then runs the forward kernel with EMIT=1 into an
// f32 workspace first, as the TPU recompute keeps f32 activations).  Per
// (image b, pixel p), with s the forward's output and g its cotangent:
//
//   dz2  = g*s*(1-s);                dWh^T += cast(dz2) . cast(a_Lh),
//   dbh += sum dz2;                  da     = cast(dz2)^T . wht
//   for l = Lh..1:  dh_l = da*(1 - a_l^2);  dW_l += cast(a_{l-1})^T . cast(dh_l)
//                   db_l += sum dh_l;      da = cast(dh_l) . W_l^T (+ dh_l)
//   dh0 = da*(1 - a0^2);  dfold[b] = (sum x0*dh0, sum x1*dh0, sum dh0, 0)
//
// a0 is recomputed from the fold (the TPU residual holds a_1.. only), casts
// and f32 accumulation sit where the TPU kernel has them, and the tanh'
// factors use the activations as stored (bf16 residual: bf16-rounded values;
// recompute: f32).
//
// What bounds it on this card: three GEMMs of the forward's hidden-GEMM size
// per layer — the recompute's forward (recompute only), da = dh . W^T and
// dW = a^T . dh (2*H^2 FLOP per pixel each, 205 GFLOP per layer at galaxy
// B=100, HW=4096, H=500) — about 3x the forward's FLOPs with the residual
// and 4x with recompute, plus the traffic of the residual and of the dh
// workspace.  The TPU kernel carries dW, db and the dfold rows across its
// sequential grid in `+=` blocks; CUDA blocks run concurrently, and an
// (H, H) f32 dW does not fit in a block (1 MB against 227 KB of shared
// memory).  The simple design here, deterministic from run to run:
//
//   (a) `bwd_chain`: one block per (image, 64-pixel tile), the forward's
//       tile machinery (decoder_tile.cuh) run backwards: da in registers,
//       dh_l through shared memory into the tensor-core GEMM with W_l^T
//       (3-pass TF32 split for f32 weights).  It writes cast(dh_l) to a
//       workspace of the residual's size (Lh, B, HW, H) in the weight dtype
//       (819 MB at galaxy f32) and per-tile partials of dfold, db, dWh^T and
//       dbh — no atomics;
//   (b) `bwd_dw`: a split-K tensor-core GEMM dW_l = cast(a_{l-1})^T . dh_l
//       over chunks of KCHUNK pixels, one (128, 128) tile of dW_l per block
//       and per chunk, a0 recomputed from the fold as it is loaded, the
//       f32 operands split into TF32 head and tail once as a slab is
//       stored (not once per fragment read), each chunk's tile written to
//       its own partial;
//   (c) `sum_rows`: the partials summed in a fixed order (per image over
//       tiles for dfold; over all tiles, in two stages, for db, dWh^T, dbh;
//       over the chunks for dW).
// The caller bounds the workspace by running (a) and (b) over chunks of
// images.  Keeping dh on chip (a fused dW) and wgmma/TMA are later work.
//
// For H > 512, (a) is `bwd_chain_wide_kernel`: da no longer fits in
// registers, so the block keeps two (64, Hp) f32 buffers in a per-block
// workspace in global memory, A (a_L, then dh_L, the GEMM operand) and D
// (da); the elementwise steps run one column per thread over all 64 pixels
// (so a thread's reads and writes of its columns need no barrier), and the
// GEMM runs in 512-column chunks on the forward's ring (decoder_tile.cuh).
// (b) and (c) take any H as they are.

#include "decoder_tile.cuh"

namespace {

using namespace svt;

constexpr int KCHUNK = 4096;      // pixels per split-K chunk of the dW GEMM
constexpr int DW_BM = 128;        // dW tile: rows (input unit i)
constexpr int DW_BN = 128;        // dW tile: columns (output unit j)
constexpr int DW_BK = 16;         // pixels per slab
constexpr int DW_NT = 256;        // threads: 8 warps as 2 (i) x 4 (j)
constexpr int DW_S = DW_BM + 8;   // slab row stride: conflict-free fragments
constexpr int DW_MT = 4;          // m16 tiles per warp (64 rows)
constexpr int DW_NTL = 4;         // n8 tiles per warp (32 columns)
constexpr int DW_LOADS = DW_BK * DW_BM / DW_NT;
static_assert(DW_BM == DW_BN, "one load pattern for both slabs");

// Sum of v over the 8 lanes that share t (the g lanes of a column).
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// (a) The backward chain of one (image, 64-pixel tile).
//   fold (Bc,4,H), y and g (Bc,No,HW), part_fold (Bc*tiles,3,H) and
//   part_w (Bc*tiles, Mw) with Mw = (Lh+No)*H + No holding [db_1..db_Lh |
//   dWh^T | dbh], all at this chunk's first image; acts: a_l at
//   (l-1)*act_ls + (b*HW + p)*H + n, f32 or bf16 (ACT_BF16); whidT
//   (Lh,Hp,Hp) holds W_l^T padded; dh_ws (Lh,Bc,HW,H) in the weight dtype.
template <bool BF16, bool RESID, bool ACT_BF16>
__global__ void __launch_bounds__(NT, 1)
bwd_chain_kernel(const float* __restrict__ fold,
                 const float* __restrict__ coords,
                 const float* __restrict__ whidT,
                 const float* __restrict__ wht,
                 const void* __restrict__ acts, long long act_ls,
                 const float* __restrict__ y, const float* __restrict__ gy,
                 void* __restrict__ dh_ws, float* __restrict__ part_fold,
                 float* __restrict__ part_w, int Bc, int HW, int H, int Lh,
                 int No, int tiles) {
  extern __shared__ float4 smem4[];
  float* dsm = reinterpret_cast<float*>(smem4);   // (PT, AS): dh_l operand
  float* ring = dsm + PT * AS;                    // W^T slabs; head first
  float* wsm = ring;                              // (MAX_NO, MAX_H) wht
  float* dz = wsm + MAX_NO * MAX_H;               // (MAX_NO, PT) dz2
  float* dzc = dz + MAX_NO * PT;                  // (MAX_NO, PT) cast(dz2)
  const int Hp = padded_hidden(H);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * PT;
  const int Mw = (Lh + No) * H + No;
  float* pw = part_w + size_t(blockIdx.x) * Mw;
  const size_t act_row = size_t(b) * HW;          // pixel rows of image b

  // ---- head: dz2 = g*s*(1-s), zero on pixels past HW
  for (int i = tid; i < No * MAX_H; i += NT) {
    const int o = i / MAX_H, k = i % MAX_H;
    wsm[i] = k < H ? wht[size_t(o) * H + k] : 0.f;
  }
  for (int i = tid; i < No * PT; i += NT) {
    const int o = i / PT, pix = p0 + i % PT;
    float d = 0.f;
    if (pix < HW) {
      const size_t at = (size_t(b) * No + o) * HW + pix;
      const float s = y[at];
      d = gy[at] * s * (1.f - s);
    }
    dz[i] = d;
    dzc[i] = operand<BF16>(d);
  }
  __syncthreads();
  if (tid < No) {                       // dbh partial: sum of the un-cast dz2
    float s = 0.f;
    for (int p = 0; p < PT; ++p) s += dz[tid * PT + p];
    pw[(Lh + No) * H + tid] = s;
  }

  // ---- da = cast(dz2)^T . wht (K = No) in the accumulator layout
  float da[MTILES][NTILES][4];
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = frag_col(warp, t, nt, c);
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int p = frag_row(g, mt, c);
        float s = 0.f;
        if (n < H)
          for (int o = 0; o < No; ++o)
            s = fmaf(dzc[o * PT + p], wsm[o * MAX_H + n], s);
        da[mt][nt][c] = s;
      }
    }

  // ---- hidden layers, last to first.  Each layer stages a_L's tile in
  // dsm with coalesced row reads; every thread then reads and overwrites
  // only its own accumulator elements with dh, so no barrier separates
  // the two.
  const int np = min(PT, HW - p0);      // pixels of the tile inside HW
  for (int L = Lh; L >= 1; --L) {
    const size_t abase = size_t(L - 1) * act_ls + (act_row + p0) * H;
#pragma unroll 8
    for (int p = 0; p < PT; ++p)        // thread tid owns column tid
      dsm[p * AS + tid] = (tid < H && p < np)
          ? load_elem<ACT_BF16>(acts, abase + size_t(p) * H + tid) : 0.f;
    __syncthreads();
    if (L == Lh) {
      // dWh^T[o, k] partial = sum_p cast(dz2[o, p]) * cast(a_Lh[p, k])
      if (tid < H) {
        float acc[MAX_NO];
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o) acc[o] = 0.f;
        for (int p = 0; p < np; ++p) {
          const float a = operand<BF16>(dsm[p * AS + tid]);
#pragma unroll
          for (int o = 0; o < MAX_NO; ++o)
            if (o < No) acc[o] = fmaf(dzc[o * PT + p], a, acc[o]);
        }
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o)
          if (o < No) pw[Lh * H + o * H + tid] = acc[o];
      }
      __syncthreads();                  // dsm reads done before dh lands
    }
    // dh = da * (1 - a_L^2), masked, into dsm; db's partial
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
          const float a = dsm[p * AS + n];
          const float dh = (n < H && p < np)
              ? da[mt][nt][c] * (1.f - a * a) : 0.f;
          col[nt][c & 1] += dh;
          dsm[p * AS + n] = stored<BF16, RESID>(dh);
        }
      }
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s = sum_over_g(col[nt][j]);
        const int n = frag_col(warp, t, nt, j);
        if (g == 0 && n < H) pw[(L - 1) * H + n] = s;
      }
    // da = cast(dh) . W^T (+ dh): tile_gemm's barriers order dsm
    float acc[MTILES][NTILES][4];
    tile_gemm<BF16, RESID>(dsm, ring, whidT + size_t(L - 1) * Hp * Hp, Hp,
                           acc);
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = frag_col(warp, t, nt, c);
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          float v = acc[mt][nt][c];
          // with the residual add, dsm holds the f32 dh (stored<>)
          if (RESID) v += dsm[frag_row(g, mt, c) * AS + n];
          da[mt][nt][c] = v;
        }
      }
    // cast(dh) to the workspace in coalesced rows
    const size_t wbase = ((size_t(L - 1) * Bc + b) * HW + p0) * H;
    if (tid < H)
      for (int p = 0; p < np; ++p)
        store_elem<BF16>(dh_ws, wbase + size_t(p) * H + tid,
                         dsm[p * AS + tid]);
    __syncthreads();          // dsm reads done before the next layer writes
  }

  // ---- dh0 = da * (1 - a0^2), a0 from the fold; dfold partial rows
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
      const int n = frag_col(warp, t, nt, c);
      if (n >= H) continue;
      const float w0 = f[n], w1 = f[H + n], cb = f[2 * H + n];
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int pix = p0 + frag_row(g, mt, c);
        if (pix >= HW) continue;
        const float x0 = coords[2 * pix], x1 = coords[2 * pix + 1];
        const float a0 = tanhf(x0 * w0 + x1 * w1 + cb);
        const float dh0 = da[mt][nt][c] * (1.f - a0 * a0);
        s0[nt][c & 1] += x0 * dh0;
        s1[nt][c & 1] += x1 * dh0;
        s2[nt][c & 1] += dh0;
      }
    }
  float* pf = part_fold + size_t(blockIdx.x) * 3 * H;
#pragma unroll
  for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float r0 = sum_over_g(s0[nt][j]);
      const float r1 = sum_over_g(s1[nt][j]);
      const float r2 = sum_over_g(s2[nt][j]);
      const int n = frag_col(warp, t, nt, j);
      if (g == 0 && n < H) {
        pf[n] = r0;
        pf[H + n] = r1;
        pf[2 * H + n] = r2;
      }
    }
}

// (a) for H > MAX_H (see the top of the file): the same inputs and outputs,
// plus the block's workspace slice ws + blockIdx.x * wide_block_floats(Hp).
template <bool BF16, bool RESID, bool ACT_BF16>
__global__ void __launch_bounds__(NT, 1)
bwd_chain_wide_kernel(const float* __restrict__ fold,
                      const float* __restrict__ coords,
                      const float* __restrict__ whidT,
                      const float* __restrict__ wht,
                      const void* __restrict__ acts, long long act_ls,
                      const float* __restrict__ y,
                      const float* __restrict__ gy, void* __restrict__ dh_ws,
                      float* __restrict__ part_fold,
                      float* __restrict__ part_w, float* __restrict__ ws,
                      int Bc, int HW, int H, int Lh, int No, int tiles) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES x (BK, BNS)
  float* dz = ring + STAGES * BK * BNS;           // (MAX_NO, PT) dz2
  float* dzc = dz + MAX_NO * PT;                  // (MAX_NO, PT) cast(dz2)
  const int Hp = padded_hidden(H);
  const int as = Hp;
  float* A = ws + size_t(blockIdx.x) * wide_block_floats(Hp);
  float* D = A + size_t(PT) * as;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * PT;
  const int Mw = (Lh + No) * H + No;
  float* pw = part_w + size_t(blockIdx.x) * Mw;
  const size_t act_row = size_t(b) * HW;
  const int np = min(PT, HW - p0);

  // ---- head: dz2 = g*s*(1-s), zero on pixels past HW; dbh partial
  for (int i = tid; i < No * PT; i += NT) {
    const int o = i / PT, pix = p0 + i % PT;
    float d = 0.f;
    if (pix < HW) {
      const size_t at = (size_t(b) * No + o) * HW + pix;
      const float s = y[at];
      d = gy[at] * s * (1.f - s);
    }
    dz[i] = d;
    dzc[i] = operand<BF16>(d);
  }
  __syncthreads();
  if (tid < No) {
    float s = 0.f;
    for (int p = 0; p < PT; ++p) s += dz[tid * PT + p];
    pw[(Lh + No) * H + tid] = s;
  }
  // ---- da = cast(dz2)^T . wht (K = No) into D, one column per thread
  for (int n = tid; n < Hp; n += NT)
    for (int p = 0; p < PT; ++p) {
      float s = 0.f;
      if (n < H)
        for (int o = 0; o < No; ++o)
          s = fmaf(dzc[o * PT + p], __ldg(wht + size_t(o) * H + n), s);
      D[p * as + n] = s;
    }

  for (int L = Lh; L >= 1; --L) {
    const size_t abase = size_t(L - 1) * act_ls + (act_row + p0) * H;
    // a_L into A; at the top layer the dWh^T partial from it; then dh =
    // da * (1 - a_L^2) over A and db's partial, column by column
    for (int n = tid; n < Hp; n += NT) {
      for (int p = 0; p < PT; ++p)
        A[p * as + n] = (n < H && p < np)
            ? load_elem<ACT_BF16>(acts, abase + size_t(p) * H + n) : 0.f;
      if (L == Lh && n < H) {
        float acc[MAX_NO];
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o) acc[o] = 0.f;
        for (int p = 0; p < np; ++p) {
          const float a = operand<BF16>(A[p * as + n]);
#pragma unroll
          for (int o = 0; o < MAX_NO; ++o)
            if (o < No) acc[o] = fmaf(dzc[o * PT + p], a, acc[o]);
        }
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o)
          if (o < No) pw[Lh * H + o * H + n] = acc[o];
      }
      float col = 0.f;
      for (int p = 0; p < PT; ++p) {
        const float a = A[p * as + n];
        const float dh = (n < H && p < np) ? D[p * as + n] * (1.f - a * a)
                                           : 0.f;
        col += dh;
        A[p * as + n] = stored<BF16, RESID>(dh);
      }
      if (n < H) pw[(L - 1) * H + n] = col;
    }
    // da = cast(dh) . W^T (+ dh) into D, in 512-column chunks; the GEMM's
    // first barrier orders the column loops above before any read of A
    for (int n0 = 0; n0 < wide_end(Hp); n0 += MAX_H) {
      float acc[MTILES][NTILES][4];
      tile_gemm<BF16, RESID, true>(A, ring, whidT + size_t(L - 1) * Hp * Hp,
                                   Hp, acc, as, n0);
      if (n0 + warp * WN >= Hp) continue;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + frag_col(warp, t, nt, c);
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt) {
            const int p = frag_row(g, mt, c);
            float v = acc[mt][nt][c];
            if (RESID) v += A[p * as + n];
            D[p * as + n] = v;
          }
        }
    }
    // cast(dh) to the workspace, one column per thread
    const size_t wbase = ((size_t(L - 1) * Bc + b) * HW + p0) * H;
    for (int n = tid; n < H; n += NT)
      for (int p = 0; p < np; ++p)
        store_elem<BF16>(dh_ws, wbase + size_t(p) * H + n, A[p * as + n]);
    __syncthreads();          // D and the reads of A done before next layer
  }

  // ---- dh0 = da * (1 - a0^2), a0 from the fold; dfold partial rows
  const float* f = fold + size_t(b) * 4 * H;
  float* pf = part_fold + size_t(blockIdx.x) * 3 * H;
  for (int n = tid; n < H; n += NT) {
    const float w0 = f[n], w1 = f[H + n], cb = f[2 * H + n];
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < np; ++p) {
      const int pix = p0 + p;
      const float x0 = coords[2 * pix], x1 = coords[2 * pix + 1];
      const float a0 = tanhf(x0 * w0 + x1 * w1 + cb);
      const float dh0 = D[p * as + n] * (1.f - a0 * a0);
      s0 += x0 * dh0;
      s1 += x1 * dh0;
      s2 += dh0;
    }
    pf[n] = s0;
    pf[H + n] = s1;
    pf[2 * H + n] = s2;
  }
}

// (b) Split-K dW_l = cast(a_{l-1})^T . dh_l over the chunk's Bc*HW pixels.
//   blockIdx.x: (128, 128) tile of dW_l; blockIdx.y: pixel chunk s;
//   blockIdx.z: layer index l0 = l - 1.  a_0 is recomputed from the fold
//   (Bc,4,H); a_l (l >= 1) is read from acts as in (a); dh_ws as written by
//   (a).  Writes chunk s's tile to part_dw[(s*Lh + l0)*H*H + i*H + j].
template <bool BF16, bool ACT_BF16>
__global__ void __launch_bounds__(DW_NT, 2)
bwd_dw_kernel(const float* __restrict__ fold,
              const float* __restrict__ coords,
              const void* __restrict__ acts, long long act_ls,
              const void* __restrict__ dh_ws, float* __restrict__ part_dw,
              int Bc, int HW, int H, int Lh) {
  constexpr bool SPLIT = !BF16 && SVT_TF32_SPLIT;
  constexpr int PARTS = SPLIT ? 2 : 1;   // the operands' TF32 head (, tail)
  extern __shared__ float4 dw_smem4[];
  // [buffer][part][A (pixel, i) | D (pixel, j)][DW_BK][DW_S], split once
  // when stored so no warp splits a fragment again
  float* sm = reinterpret_cast<float*>(dw_smem4);
  auto slab = [&](int buf, int part, int which) {
    return sm + ((buf * PARTS + part) * 2 + which) * DW_BK * DW_S;
  };
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps
  const int tiles_j = (H + DW_BN - 1) / DW_BN;
  const int i0 = (blockIdx.x / tiles_j) * DW_BM;
  const int j0 = (blockIdx.x % tiles_j) * DW_BN;
  const int l0 = blockIdx.z;
  const int K = Bc * HW;                 // < 2^31: the caller's grid bound
  const int k0 = blockIdx.y * KCHUNK;
  const int k1 = min(K, k0 + KCHUNK);
  const int nslab = (k1 - k0 + DW_BK - 1) / DW_BK;
  const size_t dh_base = size_t(l0) * size_t(K) * H;
  const size_t a_base = l0 > 0 ? size_t(l0 - 1) * act_ls : 0;
  // a thread loads one column (i for A, j for the dh slab) of rows
  // row0, row0 + 2, ..., row0 + 14 of every slab
  const int col = tid % DW_BM, row0 = tid / DW_BM;
  const int i = i0 + col, j = j0 + col;
  const bool on_i = i < H, on_j = j < H;
  // a0 (l0 == 0): the image and pixel of the slab's row row0, advanced by
  // DW_BK per slab without a division, and the fold row of the last image
  int cur_b = k0 / HW, cur_p = k0 % HW + row0;
  while (cur_p >= HW) { cur_p -= HW; ++cur_b; }
  int fb = -1;
  float w0 = 0.f, w1 = 0.f, cb = 0.f;

  float ra[DW_LOADS], rd[DW_LOADS];
  auto load = [&](int slab) {
    const int kr = k0 + slab * DW_BK + row0;
    int bi = cur_b, pix = cur_p;
#pragma unroll
    for (int r = 0; r < DW_LOADS; ++r) {
      const int k = kr + 2 * r;
      float a = 0.f, d = 0.f;
      if (k < k1) {
        if (on_i) {
          if (l0 == 0) {
            if (bi != fb) {
              const float* f = fold + size_t(bi) * 4 * H + i;
              w0 = f[0];
              w1 = f[H];
              cb = f[2 * H];
              fb = bi;
            }
            a = tanhf(coords[2 * pix] * w0 + coords[2 * pix + 1] * w1 + cb);
          } else {
            a = load_elem<ACT_BF16>(acts, a_base + size_t(k) * H + i);
          }
          a = operand<BF16>(a);
        }
        if (on_j) d = load_elem<BF16>(dh_ws, dh_base + size_t(k) * H + j);
      }
      ra[r] = a;
      rd[r] = d;
      pix += 2;
      while (pix >= HW) { pix -= HW; ++bi; }
    }
    cur_p += DW_BK;
    while (cur_p >= HW) { cur_p -= HW; ++cur_b; }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < DW_LOADS; ++r) {
      const int at = (row0 + 2 * r) * DW_S + col;
      if (SPLIT) {
        uint32_t hi, lo;
        split(ra[r], hi, lo);
        slab(buf, 0, 0)[at] = __uint_as_float(hi);
        slab(buf, 1, 0)[at] = __uint_as_float(lo);
        split(rd[r], hi, lo);
        slab(buf, 0, 1)[at] = __uint_as_float(hi);
        slab(buf, 1, 1)[at] = __uint_as_float(lo);
      } else {
        slab(buf, 0, 0)[at] = ra[r];
        slab(buf, 0, 1)[at] = rd[r];
      }
    }
  };

  float acc[DW_MT][DW_NTL][4];
#pragma unroll
  for (int mt = 0; mt < DW_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < DW_NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < nslab; ++s) {
    const int buf = s & 1;
    if (s + 1 < nslab) load(s + 1);   // global loads in flight
#pragma unroll
    for (int kk = 0; kk < DW_BK; kk += 8) {
      const float* ah = slab(buf, 0, 0) + (kk + t) * DW_S;
      const float* al = slab(buf, PARTS - 1, 0) + (kk + t) * DW_S;
      const float* dh = slab(buf, 0, 1) + (kk + t) * DW_S;
      const float* dl = slab(buf, PARTS - 1, 1) + (kk + t) * DW_S;
      uint32_t bhi[DW_NTL][2], blo[DW_NTL][2];
#pragma unroll
      for (int nt = 0; nt < DW_NTL; ++nt) {
        const int jn = wn * 32 + nt * 8 + g;
        bhi[nt][0] = __float_as_uint(dh[jn]);
        bhi[nt][1] = __float_as_uint(dh[4 * DW_S + jn]);
        if (SPLIT) {
          blo[nt][0] = __float_as_uint(dl[jn]);
          blo[nt][1] = __float_as_uint(dl[4 * DW_S + jn]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < DW_MT; ++mt) {
        const int im = wm * 64 + mt * 16 + g;
        const uint32_t ahi[4] = {
            __float_as_uint(ah[im]), __float_as_uint(ah[im + 8]),
            __float_as_uint(ah[4 * DW_S + im]),
            __float_as_uint(ah[4 * DW_S + im + 8])};
        uint32_t alo[4] = {0u, 0u, 0u, 0u};
        if (SPLIT) {
          alo[0] = __float_as_uint(al[im]);
          alo[1] = __float_as_uint(al[im + 8]);
          alo[2] = __float_as_uint(al[4 * DW_S + im]);
          alo[3] = __float_as_uint(al[4 * DW_S + im + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < DW_NTL; ++nt) {
          if (SPLIT) {
            mma_tf32(acc[mt][nt], alo, bhi[nt][0], bhi[nt][1]);
            mma_tf32(acc[mt][nt], ahi, blo[nt][0], blo[nt][1]);
          }
          mma_tf32(acc[mt][nt], ahi, bhi[nt][0], bhi[nt][1]);
        }
      }
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < nslab) store(buf ^ 1);
    __syncthreads();
  }

  float* out = part_dw + (size_t(blockIdx.y) * Lh + l0) * H * H;
#pragma unroll
  for (int mt = 0; mt < DW_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < DW_NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * 64 + mt * 16 + g + (c >> 1) * 8;
        const int j = j0 + wn * 32 + nt * 8 + 2 * t + (c & 1);
        if (i < H && j < H) out[size_t(i) * H + j] = acc[mt][nt][c];
      }
}

// (c) out[gi*out_stride + j] = sum over r < rows_per_group (and
// gi*rows_per_group + r < total_rows) of in[(gi*rows_per_group + r)*M + j],
// summed in row order: the fixed-order cross-block reduction.
__global__ void sum_rows_kernel(const float* __restrict__ in,
                                float* __restrict__ out, int rows_per_group,
                                long long total_rows, int M,
                                long long out_stride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  const long long r0 = (long long)blockIdx.y * rows_per_group;
  const long long r1 = min(total_rows, r0 + rows_per_group);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += in[size_t(r) * M + j];
  out[size_t(blockIdx.y) * out_stride + j] = s;
}

template <bool BF16, bool RESID, bool ACT_BF16>
cudaError_t launch_chain(const float* fold, const float* coords,
                         const float* whidT, const float* wht,
                         const void* acts, long long act_ls, const float* y,
                         const float* gy, void* dh_ws, float* part_fold,
                         float* part_w, float* ws, int Bc, int HW, int H,
                         int Lh, int No, cudaStream_t stream) {
  if (H > MAX_H) {
    auto kernel = bwd_chain_wide_kernel<BF16, RESID, ACT_BF16>;
    constexpr int smem = int(RING_BYTES) + 2 * MAX_NO * PT * int(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (HW + PT - 1) / PT;
    kernel<<<unsigned(Bc) * unsigned(tiles), NT, smem, stream>>>(
        fold, coords, whidT, wht, acts, act_ls, y, gy, dh_ws, part_fold,
        part_w, ws, Bc, HW, H, Lh, No, tiles);
    return cudaGetLastError();
  }
  auto kernel = bwd_chain_kernel<BF16, RESID, ACT_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int tiles = (HW + PT - 1) / PT;
  kernel<<<unsigned(Bc) * unsigned(tiles), NT, SMEM_BYTES, stream>>>(
      fold, coords, whidT, wht, acts, act_ls, y, gy, dh_ws, part_fold,
      part_w, Bc, HW, H, Lh, No, tiles);
  return cudaGetLastError();
}

template <bool BF16, bool ACT_BF16>
cudaError_t launch_dw(const float* fold, const float* coords,
                      const void* acts, long long act_ls, const void* dh_ws,
                      float* part_dw, int Bc, int HW, int H, int Lh,
                      cudaStream_t stream) {
  const int tiles = (H + DW_BM - 1) / DW_BM;
  const long long chunks = ((long long)Bc * HW + KCHUNK - 1) / KCHUNK;
  const dim3 grid(unsigned(tiles * tiles), unsigned(chunks), unsigned(Lh));
  constexpr int parts = (!BF16 && SVT_TF32_SPLIT) ? 2 : 1;
  constexpr int smem = 2 * parts * 2 * DW_BK * DW_S * int(sizeof(float));
  auto kernel = bwd_dw_kernel<BF16, ACT_BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DW_NT, smem, stream>>>(
      fold, coords, acts, act_ls, dh_ws, part_dw, Bc, HW, H, Lh);
  return cudaGetLastError();
}

bool bad_shape(int Bc, int HW, int H, int Lh) {
  return Bc < 1 || HW < 1 || H < 1 || Lh < 1 || Lh > MAX_LH ||
         double(Bc) * ((HW + PT - 1) / PT) > 2147483647.0 ||
         double(Bc) * HW > double(KCHUNK) * 65535.0;
}

}  // namespace

extern "C" {

// Pixels per split-K chunk of the dW GEMM: part_dw holds
// ceil(Bc*HW / KCHUNK) chunks per call.
int svt_fused_decoder_bwd_kchunk() { return KCHUNK; }

// (a) for a chunk of Bc images; pointers at the chunk's first image (see
// bwd_chain_kernel).  whidT (Lh,Hp,Hp) f32; wht (No,H) f32; `bf16`: the
// weights hold bf16 values; `act_bf16`: acts is bf16 (else f32).  For
// H > 512, `ws` holds Bc*ceil(HW/64) * svt_fused_decoder_ws_block(H) floats.
int svt_fused_decoder_bwd_chain(const void* fold, const void* coords,
                                const void* whidT, const void* wht,
                                const void* acts, long long act_ls,
                                const void* y, const void* gy, void* dh_ws,
                                void* part_fold, void* part_w, void* ws,
                                int Bc, int HW, int H, int Lh, int No,
                                int resid, int bf16, int act_bf16,
                                void* stream) {
  if (bad_shape(Bc, HW, H, Lh) || No < 1 || No > MAX_NO ||
      (act_bf16 && !bf16) || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  auto* wsf = static_cast<float*>(ws);
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const float*>(whidT);
  const auto* h = static_cast<const float*>(wht);
  const auto* yy = static_cast<const float*>(y);
  const auto* gg = static_cast<const float*>(gy);
  auto* pf = static_cast<float*>(part_fold);
  auto* pw = static_cast<float*>(part_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_CHAIN(B16, R, A16)                                               \
  launch_chain<B16, R, A16>(f, c, w, h, acts, act_ls, yy, gg, dh_ws, pf, pw, \
                            wsf, Bc, HW, H, Lh, No, st)
  cudaError_t err;
  if (!bf16)
    err = resid ? SVT_CHAIN(false, true, false) : SVT_CHAIN(false, false, false);
  else if (act_bf16)
    err = resid ? SVT_CHAIN(true, true, true) : SVT_CHAIN(true, false, true);
  else
    err = resid ? SVT_CHAIN(true, true, false) : SVT_CHAIN(true, false, false);
#undef SVT_CHAIN
  return int(err);
}

// (b) for the same chunk: part_dw at the chunk's first split-K partial.
int svt_fused_decoder_bwd_dw(const void* fold, const void* coords,
                             const void* acts, long long act_ls,
                             const void* dh_ws, void* part_dw, int Bc, int HW,
                             int H, int Lh, int bf16, int act_bf16,
                             void* stream) {
  if (bad_shape(Bc, HW, H, Lh) || (act_bf16 && !bf16))
    return int(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  auto* out = static_cast<float*>(part_dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16)
    err = launch_dw<false, false>(f, c, acts, act_ls, dh_ws, out, Bc, HW, H,
                                  Lh, st);
  else if (act_bf16)
    err = launch_dw<true, true>(f, c, acts, act_ls, dh_ws, out, Bc, HW, H,
                                Lh, st);
  else
    err = launch_dw<true, false>(f, c, acts, act_ls, dh_ws, out, Bc, HW, H,
                                 Lh, st);
  return int(err);
}

// (c) groups = ceil(total_rows / rows_per_group) output rows of M floats.
int svt_sum_rows(const void* in, void* out, int rows_per_group,
                 long long total_rows, int M, long long out_stride,
                 void* stream) {
  if (rows_per_group < 1 || total_rows < 1 || M < 1)
    return int(cudaErrorInvalidValue);
  const long long groups = (total_rows + rows_per_group - 1) / rows_per_group;
  if (groups > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((M + 255) / 256), unsigned(groups));
  sum_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out),
      rows_per_group, total_rows, M, out_stride);
  return int(cudaGetLastError());
}

}  // extern "C"
