// K3's cluster passes past H = 512 at the default numerics (no mode bit,
// both levels 7), in every family, with bf16 or f32 weights: the pieces of
// fused_loss_int8_sm90.cuh (the W1 slab ring multicast over clusters of
// four 64-pixel blocks of one quantisation group, int8 wgmma m64n128k32
// from shared memory, the threshold a0 chain, the a1c stash, the colored
// pairing across a cluster) run in output-column chunks of KW = 512, in a
// translation unit of their own, so that the H <= 512 units keep their
// code.  Replaces, with those passes, the Pallas TPU kernel
// spatialvae_tpu/kernels/fused_loss_int8.py `_kernel` (:718) at these
// widths; the formulas are fused_loss_int8.cuh's, and the numbers are the
// H <= 512 cluster passes' (aq word for word; the head's row sums carried
// across chunks in chunk order, as the block passes' WIDE instantiations
// carry them).
//
// What changes past 512 (Kp = H padded to 64, nch = Kp / 512 rounded up,
// every operand and workspace block R = 512 nch rows):
//   - W1f^T and W1r are laid out chunk by chunk (fused_loss_int8.sm90_slabs):
//     chunk c is rows 512 c .. +511 over the whole K = Kp, in Kp / 64 slabs
//     of 64 K-bytes x 512 rows, so the ring, its quarters and the multicast
//     are the H <= 512 ring's, streaming nch * Kp / 64 slabs per tile;
//   - the (64, Kp) A operands are not held whole (64 KiB each at Kp =
//     1,024, the shared memory's first limit): each product reads a ring of
//     PIECES pieces, the operand's 64 K-bytes of its slab (4 KiB), built
//     while the tensor cores run the slab before it.  The forward builds
//     aq's pieces from the fold through the thresholds (a compare, not a
//     tanh, so building them once per chunk costs little) and leaves aq in
//     the dW1 operand's workspace as it builds the first chunk; the gradient
//     pass reads aq back from there for dh0 and runs no a0 chain;
//   - da0 = qi . W1r^T needs qi over the whole K before its first output
//     chunk, and int8 wgmma takes K-major operands only, so the gradient
//     pass writes each chunk's qi tile also to a K-major copy beside the
//     block's stash (64 x R bytes, in the pieces' layout) and reads it back
//     a piece a slab;
//   - the head's No <= 8 partials per pixel are carried across chunks in
//     shared memory, one thread per slot, added in chunk order; the loss
//     epilogue, and the colored pair's exchange of z, run after the last
//     chunk;
//   - the column sums (db1, dWh^T, dfold) are reduced chunk by chunk;
//   - dW1 covers the (R / 128)^2 output tiles of the R-row workspaces on
//     the same 2 x 2 clusters, tiles past H left out by supertile.
// No float atomics, sums in a fixed order: reruns are bit-identical.
//
// Test-build switches, the faulty copies that place --limits k3's wide
// readings: -DSVT_K3W_DROP_HEAD=1 drops the last chunk's head partial,
// -DSVT_K3W_AQ_OFF=1 reads aq for dh0 from the workspace one block off
// (the chunk's next 64-pixel block), -DSVT_K3W_SKIP_SUMS=1
// writes 0 for the last chunk's column sums.

#include "fused_loss_int8_sm90.cuh"

#ifndef SVT_K3W_DROP_HEAD
#define SVT_K3W_DROP_HEAD 0
#endif
#ifndef SVT_K3W_AQ_OFF
#define SVT_K3W_AQ_OFF 0
#endif
#ifndef SVT_K3W_SKIP_SUMS
#define SVT_K3W_SKIP_SUMS 0
#endif

namespace {

constexpr int PIECE = PT * SB;           // a slab's K-range of an A operand
constexpr int PIECES = 4;
constexpr int PIECES_PER_CHUNK = KW / SB;

__host__ __device__ constexpr int wide_chunks(int H) {
  return (padded_k(H) + KW - 1) / KW;
}
// rows of every operand and workspace block: whole chunks
__host__ __device__ constexpr int wide_rows(int H) {
  return wide_chunks(H) * KW;
}
// one chunk's a1c stash of one block
__host__ __device__ constexpr size_t stash_chunk(bool bf16) {
  return size_t(NT) * (bf16 ? A1c<true>::WORDS : A1c<false>::WORDS) * 4;
}
// a block's `ws` region: every chunk's stash, then the K-major qi copy
__host__ __device__ constexpr size_t wide_block(bool bf16, int H) {
  return wide_chunks(H) * stash_chunk(bf16) + size_t(wide_rows(H)) * PT;
}

struct FwdWSmem {
  int8_t ring[FWD_STAGES][SLAB];
  int8_t piece[PIECES][PIECE];
  float red[WG * MAX_NO * PT];       // the head's partials per warpgroup
  float z[MAX_NO * PT];              // and their sums over the chunks
  float scratch[WARPS];
  float thr[8];
  uint64_t full[FWD_STAGES], empty[FWD_STAGES];
  float zx[2 * PT];                  // colored: z, read by the partner CTA
};

struct GradWSmem {
  int8_t ring[GRAD_STAGES][SLAB];
  int8_t piece[PIECES][PIECE];
  int8_t qi[TILE_B];                 // one chunk's qi tile
  float red[SLOTS][4][KW];
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  float scratch[WARPS];
  uint64_t full[GRAD_STAGES], empty[GRAD_STAGES];
};
static_assert(sizeof(FwdWSmem) <= 232448, "opt-in shared memory on sm_90");
static_assert(sizeof(GradWSmem) <= 232448, "opt-in shared memory on sm_90");

// acc = A . W_chunk^T over the `nks` slabs seq0 .. of the ring, A one piece
// a slab (piece seq % PIECES, the caller's before the first slab).  side(seq)
// runs while the tensor cores work on slab seq and builds piece seq + 1; a
// CTA barrier closes each slab, so that piece is whole before any
// warpgroup reads it, and every warpgroup's products of slab seq - 1 are
// done: a piece is rewritten PIECES - 1 slabs after its products started.
template <int S, typename Side>
__device__ __forceinline__ void piece_product(int (&acc)[64],
                                              int8_t (*pieces)[PIECE],
                                              const Ring<S>& ring, int seq0,
                                              int nks, int wg, Side side) {
  for (int s = 0; s < nks; ++s) {
    const int seq = seq0 + s;
    mma_slab(acc, pieces[seq % PIECES], 0, ring.wait(seq), wg, s == 0);
    side(seq);
    fence_proxy_async();
    wgmma_wait<1>();
    if (s > 0) ring.release(seq - 1);
    ring.refill(seq);
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  ring.release(seq0 + nks - 1);
}

// Columns 64 s .. +63 of aq for pixels p0 .. p0+63 of image b into a piece
// (64 rows of 64 swizzled bytes): chain_part's element map and arithmetic,
// through the thresholds (the default numerics have no SR).
__device__ __forceinline__ void chain_piece(const float* __restrict__ fold,
                                            const float* __restrict__ coords,
                                            int b, int p0, int H, int s,
                                            const float* thr, int8_t* piece) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int kl = (wi & 3) * 16 + (lane & 3) * 4, k0 = s * SB + kl;
  const float* f = fold + size_t(b) * 4 * H;
  float w0[4], w1[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool on = k0 + j < H;
    w0[j] = on ? f[k0 + j] : 0.f;
    w1[j] = on ? f[H + k0 + j] : 0.f;
    c[j] = on ? f[2 * H + k0 + j] : 0.f;
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int p = ((wi >> 2) + 4 * it) * 8 + (lane >> 2);
    const float x0 = coords[2 * (p0 + p)], x1 = coords[2 * (p0 + p) + 1];
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + j >= H) continue;
      const int q = q7_fast(first_h0(x0, x1, w0[j], w1[j], c[j]), thr);
      packed |= uint32_t(uint8_t(int8_t(q))) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(piece + offset_sw64(p, kl)) = packed;
  }
}

// A piece of aq (rows 64 s .. +63 of the block's dW1 operand) to its 4 KiB
// of the workspace block, `dst`: thread i writes row i / 8, positions
// 8 (i % 8) .. +7, position 16 w + 2 g + h holding pixel 16 w + g + 8 h
// (sm90_ws_layout's order).
__device__ __forceinline__ void piece_to_ws(const int8_t* piece,
                                            int8_t* dst) {
  const int n = threadIdx.x >> 3, q = threadIdx.x & 7;
  uint32_t v[2] = {0u, 0u};
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int pos = 8 * q + m;
    const int p = 16 * (pos >> 4) + ((pos >> 1) & 7) + 8 * (pos & 1);
    v[m >> 2] |= uint32_t(uint8_t(piece[offset_sw64(p, n)])) << (8 * (m & 3));
  }
  *reinterpret_cast<uint2*>(dst + offset_sw64(n, 8 * q)) =
      make_uint2(v[0], v[1]);
}

// ---- pass 1: the forward, chunk by chunk.  A tile's aq pieces are built
// once per chunk (the first chunk's also to the dW1 operand's workspace
// `aq_ws`); after each chunk's product its a1c goes to the stash and its
// head partials are added to sm.z; after the last the loss epilogue runs
// as in loss_fwd90_body (colored: the pair's z through distributed shared
// memory).
template <bool BF16, bool COLORED>
__device__ __forceinline__ void loss_fwd90w_body(const LossFwdArgs& a,
                                                 int nquads, int8_t* aq_ws) {
  extern __shared__ __align__(128) uint8_t smem90[];
  FwdWSmem& sm = *reinterpret_cast<FwdWSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int nks = padded_k(H) / SB, nch = wide_chunks(H), per = nch * nks;
  const size_t rows = wide_rows(H), wsb = wide_block(BF16, H);
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const Ring<FWD_STAGES> ring{sm.ring, sm.full, sm.empty, a.w1fT, per,
                              ntl * per, cluster_rank()};
  if (tid == 0) ring.init();
  q7_thresholds(sm.thr);
  cluster_sync();
  ring.start();
  auto block_of = [&](int k) {
    const int q = cid + k * ncl;
    return COLORED ? colored_block(q, ring.rank, a.Pt)
                   : q * CS + int(ring.rank);
  };
  // piece seq: slab (seq % per) % nks of tile seq / per
  auto build = [&](int seq) {
    const int tb = block_of(seq / per);
    chain_piece(a.fold, a.coords, tb / blocks, (tb % blocks) * PT, H,
                (seq % per) % nks, sm.thr, sm.piece[seq % PIECES]);
  };
  if (ntl > 0) {
    build(0);
    fence_proxy_async();
  }
  __syncthreads();
  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), b = tb / blocks, p0 = (tb % blocks) * PT;
    int8_t* ws_aq = aq_ws + size_t(tb) * rows * PT;
    uint32_t* stash =
        reinterpret_cast<uint32_t*>(a.ws + size_t(tb) * wsb) + tid;
    for (int c = 0; c < nch; ++c) {
      const int n0 = c * KW;             // the chunk's first column
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      piece_product(acc, sm.piece, ring, (k * nch + c) * nks, nks, wg,
                    [&](int seq) {
                      if (c == 0)
                        piece_to_ws(sm.piece[seq % PIECES],
                                    ws_aq + size_t(seq % per) * PIECE);
                      if (seq + 1 < ntl * per) build(seq + 1);
                    });
      A1c<BF16> a1c;
      a1_epilogue<BF16>(acc, a.h1s + n0, a.b1 + n0, H - n0, wg, t, a1c);
#pragma unroll
      for (int i = 0; i < A1c<BF16>::WORDS; ++i)
        stash[(c * A1c<BF16>::WORDS + i) * NT] = a1c.word(i);
      // the chunk's head row sums: this thread's 32 columns, the 4 lanes of
      // a row, then the 4 warpgroups in order, added to the chunks before
      for (int o = 0; o < No; ++o) {
        float r0 = 0.f, r1 = 0.f;
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          if (j & 2) continue;
          const int n = n0 + acc_col(wg, t, j);
          const float wv = n < H ? __ldg(a.wht + size_t(o) * H + n) : 0.f;
          r0 = fmaf(wv, a1c.get(j), r0);
          r1 = fmaf(wv, a1c.get(j + 2), r1);
        }
        r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
        r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
        r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
        if (t == 0) {
          sm.red[(wg * MAX_NO + o) * PT + 16 * w + g] = r0;
          sm.red[(wg * MAX_NO + o) * PT + 16 * w + g + 8] = r1;
        }
      }
      __syncthreads();
      // one thread per (output, pixel) slot; the next chunk's product
      // barriers come before `red` is written again
      if (tid < No * PT) {
        float zc = 0.f;
        for (int q = 0; q < WG; ++q)
          zc += sm.red[(q * MAX_NO + tid / PT) * PT + tid % PT];
        if (SVT_K3W_DROP_HEAD && c == nch - 1) zc = 0.f;
        sm.z[tid] = c == 0 ? zc : __fadd_rn(sm.z[tid], zc);
      }
    }
    float per_px = 0.f, d = 0.f;
    if constexpr (COLORED) {
      const float z = tid < 2 * PT ? sm.z[tid] : 0.f;
      if (k > 0) cluster_wait();         // the partner has read zx
      if (tid < 2 * PT) sm.zx[tid] = z;
      cluster_sync();
      const float zp = tid < 2 * PT ? ld_cluster(&sm.zx[tid], ring.rank ^ PAIR)
                                    : 0.f;
      cluster_arrive();
      const bool mean = !(ring.rank & PAIR);
      const int half = SVT_COLORED90_PAIR_ADJACENT ? PT : a.Pt / 2;
      const int pm = mean ? p0 : p0 - half;
      if (tid < 2 * PT) {
        const int o = tid / PT, u = tid % PT;
        const size_t pair = size_t(pm / (2 * half)) * half + pm % (2 * half)
                            + u;                  // index into (.., HW/2)
        const float mu = sigmoidf(__fadd_rn(mean ? z : zp, a.bht[o]));
        const float lv = sigmoidf(__fadd_rn(mean ? zp : z, a.bht[o]));
        const float y =
            load_target(a.yt, (size_t(b) * 2 + o) * (HW / 2) + pair, a.yt_i8);
        const float dd = __fsub_rn(mu, y);
        const float wd = __fmul_rn(dd, expf(-lv));
        const float dw = __fmul_rn(dd, wd);
        per_px = __fadd_rn(dw, lv);
        float dmu = __fmul_rn(wd, __fmul_rn(mu, __fsub_rn(1.f, mu)));
        float dlv = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.f, dw)),
                              __fmul_rn(lv, __fsub_rn(1.f, lv)));
        if (a.mask != nullptr) {
          const float m = a.mask[size_t(o) * (HW / 2) + pair];
          per_px = __fmul_rn(per_px, m);
          dmu = __fmul_rn(dmu, m);
          dlv = __fmul_rn(dlv, m);
        }
        d = mean ? dmu : dlv;
        a.dz2[(size_t(b) * 2 + o) * HW + p0 + u] = d;
      }
      const float bsum = mean ? block_sum(per_px, sm.scratch) : 0.f;
      const float bmax = block_max(fabsf(d), sm.scratch);
      if (tid == 0) {
        a.part_bce[tb] = __fmul_rn(0.5f, bsum);
        a.part_max[tb] = bmax;
      }
      continue;
    }
    if (tid < No * PT) {
      const int o = tid / PT, pix = p0 + tid % PT;
      const float z = sm.z[tid];
      const size_t at = (size_t(b) * No + o) * HW + pix;
      const float s = sigmoidf(__fadd_rn(z, a.bht[o]));
      const float y = load_target(a.yt, at, a.yt_i8);
      const float m = a.mask != nullptr ? a.mask[pix] : 1.f;
      if (a.family == GAUSSIAN) {
        d = __fsub_rn(s, y);
        per_px = __fmul_rn(d, d);
        if (a.mask != nullptr) {
          per_px = __fmul_rn(per_px, m);
          d = __fmul_rn(d, m);
        }
        d = __fmul_rn(d, __fmul_rn(s, __fsub_rn(1.f, s)));
      } else {
        const float ls = fmaxf(logf(s), -100.f);
        const float l1 = fmaxf(log1pf(-s), -100.f);
        per_px = __fadd_rn(__fmul_rn(y, ls),
                           __fmul_rn(__fsub_rn(1.f, y), l1));
        d = __fmul_rn(s, __fsub_rn(1.f, s)) == 0.f ? 0.f : __fsub_rn(s, y);
        if (a.mask != nullptr) {
          per_px = __fmul_rn(per_px, m);
          d = __fmul_rn(d, m);
        }
      }
      a.dz2[at] = d;
    }
    const float bsum = block_sum(per_px, sm.scratch);
    const float bmax = block_max(fabsf(d), sm.scratch);
    if (tid == 0) {
      a.part_bce[tb] = a.family == GAUSSIAN ? __fmul_rn(0.5f, bsum) : -bsum;
      a.part_max[tb] = bmax;
    }
  }
  if (COLORED && ntl > 0) cluster_wait();  // every partner's last read
  cluster_sync();
}

__device__ __forceinline__ float column_sum_w(const GradWSmem& sm, int s) {
  const int n = threadIdx.x;
  float v = sm.red[s][0][n];
  v += sm.red[s][1][n];
  v += sm.red[s][2][n];
  v += sm.red[s][3][n];
  return v;
}

// ---- pass 2: per tile the group's scale, then chunk by chunk q, qi (to the
// chunk's tile, the dW1 workspace q_ws and the K-major copy), db1's and
// dWh^T's column sums; the dbh partials; then da0 = qi . W1r^T chunk by
// chunk, its A pieces read back from the K-major copy, and the dh0 chain
// with aq read from the dW1 workspace where pass 1 left it, and the dfold
// partials.  The numbers are loss_grad90_body's, column by column.
template <bool BF16>
__device__ __forceinline__ void loss_grad90w_body(const LossGradArgs& a,
                                                  int nquads) {
  extern __shared__ __align__(128) uint8_t smem90[];
  GradWSmem& sm = *reinterpret_cast<GradWSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int Mw = H + No * H + No;
  const int nks = padded_k(H) / SB, nch = wide_chunks(H), per = nch * nks;
  const size_t rows = wide_rows(H), wsb = wide_block(BF16, H);
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const Ring<GRAD_STAGES> ring{sm.ring, sm.full, sm.empty, a.w1r, per,
                               ntl * per, cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();
  auto block_of = [&](int k) { return (cid + k * ncl) * CS + int(ring.rank); };
  const float cinv = rb(__fdiv_rn(1.f, a.lf));
  const int px0 = 16 * w + g, px1 = px0 + 8;

  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), bl = tb / blocks, blk = tb % blocks;
    const int b = a.b0 + bl, p0 = blk * PT;
    const size_t gblk = size_t(b) * blocks + blk;
    const int aq_tb = SVT_K3W_AQ_OFF ? (tb + 1) % int(a.grid) : tb;
    const int8_t* aq_ws = a.aq_ws + size_t(aq_tb) * rows * PT;
    int8_t* q_ws = a.q_ws + size_t(tb) * rows * PT;
    const uint32_t* stash =
        reinterpret_cast<const uint32_t*>(a.ws + size_t(tb) * wsb) + tid;
    int8_t* qk = a.ws + size_t(tb) * wsb + nch * stash_chunk(BF16);
    float* pw = a.part_w + gblk * Mw;

    // dz2 and the group's scale: qs multiplies, sg dequantises
    if (tid < No * PT) {
      const int o = tid / PT, pix = p0 + tid % PT;
      const float d = a.dz2[(size_t(b) * No + o) * HW + pix];
      sm.dz[tid] = d;
      sm.dzc[tid] = operand<BF16>(d);
    }
    const float gmax = group_max(a.part_max, b, p0, blocks, a.Pt);
    const float gm = __fmul_rn(*a.gb, __fadd_rn(gmax, 1e-30f));
    const float qs = __fdiv_rn(7.f, gm);
    const float sg = __fmul_rn(gm, 1.f / 7.f);
    if (tid == 0 && p0 % a.Pt == 0)
      a.gscale[size_t(b) * (HW / a.Pt) + p0 / a.Pt] =
          __fmul_rn(sg, __fdiv_rn(1.f, a.lf));
    __syncthreads();

    for (int c = 0; c < nch; ++c) {
      const int n0 = c * KW;
      const bool skip = SVT_K3W_SKIP_SUMS && c == nch - 1;
      A1c<BF16> a1c;
#pragma unroll
      for (int i = 0; i < A1c<BF16>::WORDS; ++i)
        a1c.set_word(i, stash[(c * A1c<BF16>::WORDS + i) * NT]);
      // q, qi (to the chunk's tile and the workspace) and db1's column sums
      // (slot 0), as loss_grad90_body computes them
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float da1[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) da1[i] = 0.f;
        for (int o = 0; o < No; ++o) {
          const float d0 = sm.dzc[o * PT + px0], d1 = sm.dzc[o * PT + px1];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = n0 + acc_col(wg, t, 16 * ch + i);
            const float wv = n < H ? __ldg(a.wht + size_t(o) * H + n) : 0.f;
            da1[i] = __fadd_rn(da1[i], __fmul_rn(i & 2 ? d1 : d0, wv));
          }
        }
        float col[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = 4 * ch + u;
          int8_t qv[4];
#pragma unroll
          for (int hc = 0; hc < 4; ++hc) {      // hc = 2 h + e
            const int j = 4 * nt + hc;
            const int n = n0 + acc_col(wg, t, j);
            float q = 0.f, qi = 0.f;
            if (n < H) {
              const float av = a1c.get(j);
              const float tf = BF16 ? rb(__fsub_rn(1.f, rb(__fmul_rn(av, av))))
                                    : __fsub_rn(1.f, __fmul_rn(av, av));
              q = __fmul_rn(__fmul_rn(da1[4 * u + hc], tf), qs);
              qi = fminf(fmaxf(qround(q), -a.lv), a.lv);
            }
            qv[hc] = static_cast<int8_t>(qi);
            if (hc < 2) col[2 * u + hc] = q;
            else col[2 * u + hc - 2] += q;
          }
          const int nl = acc_col(wg, t, 4 * nt);
          *reinterpret_cast<uint16_t*>(sm.qi + tile_off(px0, nl)) =
              uint16_t(uint8_t(qv[0])) | uint16_t(uint8_t(qv[1])) << 8;
          *reinterpret_cast<uint16_t*>(sm.qi + tile_off(px1, nl)) =
              uint16_t(uint8_t(qv[2])) | uint16_t(uint8_t(qv[3])) << 8;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<uint16_t*>(
                q_ws + offset_sw64(n0 + nl + e, 16 * w + 2 * g)) =
                uint16_t(uint8_t(qv[e])) | uint16_t(uint8_t(qv[2 + e])) << 8;
        }
        const float s = reduce_scatter8(col);
        sm.red[0][w][chunk_col(wg, t, g, ch)] = s;
      }
      // dWh^T's column sums in the slots after db1's; every SLOTS filled
      // slots are summed over the warps
      int used = 1, first_o = -1;               // slot 0 holds db1
      for (int o = 0; o < No; ++o) {
        const float d0 = sm.dzc[o * PT + px0], d1 = sm.dzc[o * PT + px1];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j = 4 * (4 * ch + i / 2) + (i & 1);
            v[i] = fmaf(d1, a1c.get(j + 2), fmaf(d0, a1c.get(j), 0.f));
          }
          sm.red[used][w][chunk_col(wg, t, g, ch)] = reduce_scatter8(v);
        }
        if (++used == SLOTS || o == No - 1) {
          __syncthreads();
          const int n = n0 + tid;
          if (n < H)
            for (int s = 0; s < used; ++s) {
              const int oo = first_o + s;
              const float v = skip ? 0.f : column_sum_w(sm, s);
              if (oo < 0) pw[n] = __fmul_rn(v, sg);
              else pw[H + oo * H + n] = v;
            }
          __syncthreads();
          used = 0;
          first_o = o + 1;
        }
      }
      // the chunk's qi tile (its pieces below Kp) to the K-major copy; the
      // barrier before the next chunk writes the tile again
      const int npc = min(PIECES_PER_CHUNK, nks - c * PIECES_PER_CHUNK);
      for (int i = tid; i < npc * PIECE / 16; i += NT)
        reinterpret_cast<uint4*>(qk + size_t(c) * TILE_B)[i] =
            reinterpret_cast<const uint4*>(sm.qi)[i];
      __syncthreads();
    }
    if (tid < No) {                           // dbh partials
      float s = 0.f;
      for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
      pw[H + No * H + tid] = s;
    }

    // da0 = qi . W1r^T chunk by chunk, qi's pieces from the K-major copy
    const int seq0 = k * per;
    auto load = [&](int seq) {
      if (tid < PIECE / 16)
        reinterpret_cast<uint4*>(sm.piece[seq % PIECES])[tid] =
            reinterpret_cast<const uint4*>(
                qk + size_t((seq - seq0) % nks) * PIECE)[tid];
    };
    load(seq0);
    fence_proxy_async();
    __syncthreads();
    const float x00 = rb(a.coords[2 * (p0 + px0)]);
    const float x01 = rb(a.coords[2 * (p0 + px0) + 1]);
    const float x10 = rb(a.coords[2 * (p0 + px1)]);
    const float x11 = rb(a.coords[2 * (p0 + px1) + 1]);
    for (int c = 0; c < nch; ++c) {
      const int n0 = c * KW;
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      piece_product(acc, sm.piece, ring, seq0 + c * nks, nks, wg,
                    [&](int seq) {
                      if (seq + 1 < seq0 + per) load(seq + 1);
                    });
      // the dh0 chain (bf16) and the dfold partials, aq from its workspace
      // (a uint16 holds rows g and g + 8 of one column)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float s0[8], s1[8], s2[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = 4 * ch + u;
          const int ng = n0 + acc_col(wg, t, 4 * nt);
          const uint16_t v0 = *reinterpret_cast<const uint16_t*>(
              aq_ws + offset_sw64(ng, 16 * w + 2 * g));
          const uint16_t v1 = *reinterpret_cast<const uint16_t*>(
              aq_ws + offset_sw64(ng + 1, 16 * w + 2 * g));
          const uint16_t r0 = uint16_t((v0 & 0xFF) | ((v1 & 0xFF) << 8));
          const uint16_t r1 = uint16_t((v0 >> 8) | (v1 & 0xFF00));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = ng + e;
              float dh0 = 0.f;
              if (i < H) {
                const float aqv =
                    float(int8_t(((h ? r1 : r0) >> (8 * e)) & 0xFF));
                const float a0d = rb(__fmul_rn(aqv, cinv));
                const float tt = rb(__fsub_rn(1.f, rb(__fmul_rn(a0d, a0d))));
                dh0 = rb(__fmul_rn(rb(float(acc[4 * nt + 2 * h + e])), tt));
              }
              const int iv = 2 * u + e;
              if (h == 0) {
                s0[iv] = fmaf(x00, dh0, 0.f);
                s1[iv] = fmaf(x01, dh0, 0.f);
                s2[iv] = dh0;
              } else {
                s0[iv] = fmaf(x10, dh0, s0[iv]);
                s1[iv] = fmaf(x11, dh0, s1[iv]);
                s2[iv] += dh0;
              }
            }
          }
        }
        const int n = chunk_col(wg, t, g, ch);
        sm.red[0][w][n] = reduce_scatter8(s0);
        sm.red[1][w][n] = reduce_scatter8(s1);
        sm.red[2][w][n] = reduce_scatter8(s2);
      }
      __syncthreads();
      const int n = n0 + tid;
      if (n < H) {
        const float dsc = SVT_K3W_SKIP_SUMS && c == nch - 1
                              ? 0.f : __fmul_rn(sg, a.s4[n]);
        float* pf = a.part_fold + gblk * 3 * H;
        pf[n] = __fmul_rn(column_sum_w(sm, 0), dsc);
        pf[H + n] = __fmul_rn(column_sum_w(sm, 1), dsc);
        pf[2 * H + n] = __fmul_rn(column_sum_w(sm, 2), dsc);
      }
      __syncthreads();
    }
  }
  cluster_sync();
}

template <bool BF16, bool COLORED>
__global__ void __launch_bounds__(NT, 1)
loss_fwd90w_kernel(const LossFwdArgs a, int nquads, int8_t* aq_ws) {
  loss_fwd90w_body<BF16, COLORED>(a, nquads, aq_ws);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 1)
loss_grad90w_kernel(const LossGradArgs a, int nquads) {
  loss_grad90w_body<BF16>(a, nquads);
}

// ---- dW1 from the R-row workspaces: grouped_dw90_kernel's clusters of
// 2 x 2 output tiles of (128, 128), over st x st supertiles of 256 x 256
// (blockIdx.x / 4 = sup: its i-tiles 2 (sup / st) + r % 2, its j-tiles
// 2 (sup % st) + r / 2), st the supertiles H needs; the same stages, the
// same multicast and each group's exact product scaled before the next.
__global__ void __launch_bounds__(DW_NT, 1)
grouped_dw90w_kernel(const int8_t* __restrict__ aq_ws,
                     const int8_t* __restrict__ q_ws,
                     const float* __restrict__ gscale,
                     float* __restrict__ part, int nimg, int blocks, int H,
                     int Pt, int gpi, int gps, int rows, int st) {
  extern __shared__ __align__(128) uint8_t smem90[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int ci = rank & 1, cj = rank >> 1;
  const int sup = blockIdx.x / CS;
  const int i0 = (2 * (sup / st) + ci) * 128, j0 = (2 * (sup % st) + cj) * 128;
  const int G = nimg * gpi;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(G, g0 + gps);
  const int bpg = Pt / PT;
  const int total = max(0, g1 - g0) * bpg / DW_BLK;
  const uint16_t mask_a = uint16_t((1u << ci) | (1u << (ci + 2)));
  const uint16_t mask_b = uint16_t(3u << (2 * cj));
  const size_t wsb = size_t(rows) * PT;

  auto fetch = [&](int idx) {
    const int s = idx % DW_STAGES;
    if (idx >= DW_STAGES)
      mbar_wait(&sm.empty[s], uint32_t(idx / DW_STAGES - 1) & 1u);
    mbar_expect_tx(&sm.full[s], DW_STAGE);
    for (int q = 0; q < DW_BLK; ++q) {
      const int kb = DW_BLK * idx + q;
      const int gi = g0 + kb / bpg;
      const size_t base =
          (size_t(gi / gpi) * blocks + (gi % gpi) * bpg + kb % bpg) * wsb;
      int8_t* dst = sm.ring[s] + q * DW_OP;
      bulk_multicast(dst + cj * (DW_OP / 2),
                     aq_ws + base + i0 * PT + cj * (DW_OP / 2),
                     DW_OP / 2, &sm.full[s], mask_a);
      bulk_multicast(dst + DW_BLK * DW_OP + ci * (DW_OP / 2),
                     q_ws + base + j0 * PT + ci * (DW_OP / 2),
                     DW_OP / 2, &sm.full[s], mask_b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], DW_WARPS * CS);
    }
    fence_mbar_init();
  }
  cluster_sync();
  if (tid == 0)
    for (int s = 0; s < DW_STAGES && s < total; ++s) fetch(s);

  int acc[64];
  float facc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0;
    facc[j] = 0.f;
  }
  for (int idx = 0; idx < total; ++idx) {
    const int s = idx % DW_STAGES;
    mbar_wait(&sm.full[s], uint32_t(idx / DW_STAGES) & 1u);
    const bool first = (DW_BLK * idx) % bpg == 0;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < DW_BLK; ++q)
#pragma unroll
      for (int kk = 0; kk < PT; kk += 32) {
        const int8_t* A = sm.ring[s] + q * DW_OP + wg * (DW_OP / 2);
        const int8_t* Bm = sm.ring[s] + (DW_BLK + q) * DW_OP;
        wgmma_s8_n128(acc, gmma_desc_sw64(A + kk), gmma_desc_sw64(Bm + kk),
                      first && q == 0 && kk == 0 ? 0 : 1);
      }
    wgmma_commit();
    wgmma_wait<1>();                       // the previous stage is read
    if (idx > 0) {
      release_cluster(&sm.empty[(idx - 1) % DW_STAGES], CS);
      if (tid == 0 && idx - 1 + DW_STAGES < total) fetch(idx - 1 + DW_STAGES);
    }
    if ((DW_BLK * idx + DW_BLK - 1) % bpg == bpg - 1) {  // group complete
      wgmma_wait<0>();
      fence_operands(acc);
      const float sc = gscale[g0 + (DW_BLK * idx) / bpg];
#pragma unroll
      for (int j = 0; j < 64; ++j)
        facc[j] = __fadd_rn(facc[j], __fmul_rn(float(acc[j]), sc));
    }
  }
  float* out = part + size_t(blockIdx.y) * H * H;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int i = i0 + 64 * wg + 16 * w + g + 8 * ((j >> 1) & 1);
    const int jj = j0 + 8 * (j >> 2) + 2 * t + (j & 1);
    if (i < H && jj < H) out[size_t(i) * H + jj] = facc[j];
  }
  cluster_sync();
}

int fwdw_clusters(bool bf16, bool colored) {
  static int c[4] = {0, 0, 0, 0};
  int* at = &c[2 * colored + bf16];
  if (colored)
    return bf16 ? cached_clusters(loss_fwd90w_kernel<true, true>, NT,
                                  sizeof(FwdWSmem), at)
                : cached_clusters(loss_fwd90w_kernel<false, true>, NT,
                                  sizeof(FwdWSmem), at);
  return bf16 ? cached_clusters(loss_fwd90w_kernel<true, false>, NT,
                                sizeof(FwdWSmem), at)
              : cached_clusters(loss_fwd90w_kernel<false, false>, NT,
                                sizeof(FwdWSmem), at);
}
int gradw_clusters(bool bf16) {
  static int c[2] = {0, 0};
  return bf16 ? cached_clusters(loss_grad90w_kernel<true>, NT,
                                sizeof(GradWSmem), &c[1])
              : cached_clusters(loss_grad90w_kernel<false>, NT,
                                sizeof(GradWSmem), &c[0]);
}
int dww_clusters() {
  static int c = 0;
  return cached_clusters(grouped_dw90w_kernel, DW_NT, sizeof(DwSmem), &c);
}

}  // namespace

namespace svt8 {

cudaError_t loss_fwd_sm90_wide(const LossFwdArgs& a, int8_t* aq_ws,
                               bool bf16, cudaStream_t st) {
  // the a1c stash, and the dW1 workspace the forward leaves aq in
  if (a.ws == nullptr || aq_ws == nullptr) return cudaErrorInvalidValue;
  const bool colored = a.family == COLORED;
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, fwdw_clusters(bf16, colored));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  const unsigned grid = unsigned(ncl * CS);
  const int smem = sizeof(FwdWSmem);
  if (colored)
    return bf16 ? launch_clusters(loss_fwd90w_kernel<true, true>, grid, NT,
                                  smem, CS, st, a, nquads, aq_ws)
                : launch_clusters(loss_fwd90w_kernel<false, true>, grid, NT,
                                  smem, CS, st, a, nquads, aq_ws);
  return bf16 ? launch_clusters(loss_fwd90w_kernel<true, false>, grid, NT,
                                smem, CS, st, a, nquads, aq_ws)
              : launch_clusters(loss_fwd90w_kernel<false, false>, grid, NT,
                                smem, CS, st, a, nquads, aq_ws);
}

cudaError_t loss_grad_sm90_wide(const LossGradArgs& a, bool bf16,
                                cudaStream_t st) {
  if (a.ws == nullptr) return cudaErrorInvalidValue;     // stash, qi copy
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, gradw_clusters(bf16));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return bf16 ? launch_clusters(loss_grad90w_kernel<true>, unsigned(ncl * CS),
                                NT, sizeof(GradWSmem), CS, st, a, nquads)
              : launch_clusters(loss_grad90w_kernel<false>,
                                unsigned(ncl * CS), NT, sizeof(GradWSmem),
                                CS, st, a, nquads);
}

cudaError_t loss90_dw_wide(const int8_t* aq_ws, const int8_t* q_ws,
                           const float* gscale, float* part, int nimg, int HW,
                           int H, int Pt, int splits, cudaStream_t stream) {
  const int gpi = HW / Pt;
  const int G = nimg * gpi;
  const int gps = (G + splits - 1) / splits;
  const int st = (H + 255) / 256;
  if (dww_clusters() < 1) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_dw90w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sizeof(DwSmem)));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(CS * st * st), unsigned(splits));
  cfg.blockDim = dim3(DW_NT);
  cfg.dynamicSmemBytes = sizeof(DwSmem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grouped_dw90w_kernel, aq_ws, q_ws, gscale,
                           part, nimg, HW / PT, H, Pt, gpi, gps,
                           wide_rows(H), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int loss90_wide_max_clusters(int which) {
  switch (which) {
    case 0: return fwdw_clusters(true, false);
    case 1: return fwdw_clusters(false, false);
    case 2: return gradw_clusters(true);
    case 3: return gradw_clusters(false);
    case 4: return fwdw_clusters(true, true);
    case 5: return fwdw_clusters(false, true);
    case 6: return dww_clusters();
    default: return 0;
  }
}

}  // namespace svt8

extern "C" {

// Bytes of one 64-pixel block's `ws` region on the cluster route: the a1c
// stash (bf16 weights 64 x 512 x 2, f32 twice that) at H <= 512; past 512
// the stash of every 512-column chunk, then the K-major copy of qi (64 x R
// bytes, R the operands' rows: the chunks' 512 each).
long long svt_loss90_ws_block(int bf16, int H) {
  if (H <= KW) return (long long)stash_chunk(bf16);
  return (long long)wide_block(bf16, H);
}

}  // extern "C"
