// K3 redesigned for Hopper: the fused int8 loss-and-gradient kernel's passes
// on thread block clusters, int8 wgmma and multicast bulk copies (the pass
// bodies at H <= 512; fused_loss_int8_sm90.cu instantiates them at the
// default numerics, fused_loss_int8_sm90_sr.cu with stochastic rounding;
// fused_loss_int8_sm90_wide.cu builds its passes past H = 512, at the
// default numerics, from the pieces here).
//
// Replaces, like the passes of fused_loss_int8.cuh, the Pallas TPU kernel
// spatialvae_tpu/kernels/fused_loss_int8.py `_kernel` (:718), here at the
// default numerics (4-bit forward and gradient tiles in int8 containers, the
// analytic-bound gradient scale, a bf16 epilogue, round to nearest even) and
// with stochastic rounding at both quantisation sites instead (the SR mode
// alone: its draws `use_sr` :744-764, `_sr_int` :188), in all three
// families (Bernoulli, Gaussian, colored), with or without a
// mask, over pixel counts and quantisation groups that are multiples of 256
// (a padded image arrives padded), with bf16 or f32 weights.  It computes
// what those passes compute (the formulas are in fused_loss_int8.cuh): the
// integer products are exact, and the quantisation groups, the scales and
// every epilogue's op order are the same, so aq is word for word the same
// and only the order of the head's row sums and of the column reductions
// moves the floats (and through dz2 may flip a rounding of qi).  The
// wrapper's k3_route sends a call here by its mode and width, and
// fused_loss_int8.cu refuses a call these passes do not take; the other
// modes, and SR past H = 512, keep those passes.
//
// The colored family pairs each 64-row mean block of a group's first half
// with the log-variance block Pt/2 rows further.  The forward's quads there
// are mean blocks 2j, 2j + 1 of a group on ranks 0 and 1 and their partners
// on ranks 2 and 3, all four in one group, so rank r's partner is rank
// r ^ 2 of the same cluster.  Each CTA leaves its head outputs z in its
// shared memory and reads its partner's through distributed shared memory;
// both compute the pair's terms, and each writes its own rows' dz2, its own
// block's max |dz2| and, the mean block alone, the pair's loss.  The
// gradient pass and dW1 never read the family.
//
// What bounds it on this card: int8 tensor-core work, 2*HW*Kp^2 ops per image
// for each of the three products (the forward's aq @ W1f, da0 = qi @ W1r^T,
// dW1 = aq^T qi): 4.4 T ops each at B=2,048 (2.22 ms at the 1,979 TOP/s
// int8 peak, 6.7 ms for the three) and 8.8 T ops at B=4,096 (13.3 ms), the
// head's f32 work beside them; chip_smoke.k3_bound counts them.  The block
// passes lost their time in four places, and the design answers each:
//   - L2: a 64-pixel block streamed the whole 256 KiB W1 from L2 for every
//     product, 34 GB per product at B=2,048.  Here four CTAs of a cluster,
//     four consecutive 64-pixel blocks of one quantisation group, share one
//     stream of W1 slabs (64 K-bytes x 512 rows, 32 KiB, laid out by the
//     host in the exact order the shared memory takes them): each CTA fetches
//     a quarter of every slab and multicasts it into all four rings, so W1
//     leaves L2 once per 256 pixels.  dW1's workspaces are fetched by 2 x 2
//     clusters of output tiles, each operand half multicast to the two CTAs
//     that share its rows: half the L2 reads of the block passes' dW1
//     kernel, in stages of four 64-pixel blocks.
//   - the tensor cores: every product is wgmma m64n128k32 s8 from shared
//     memory in the 64-byte swizzled layout (sm90.cuh), one warpgroup per
//     128 output columns (dW1: per 64 rows), the next slab's products started
//     before the previous slab's are waited for; exact in int32.
//   - the a0 chain, the largest part of both block passes: clip(round(7
//     tanh(h0)), -7, 7) takes one of 15 values, so the chain compares |h0|
//     with the seven thresholds where the level steps (found at each block's
//     start by bisection on tanhf itself) instead of computing tanh; the
//     check kernel below holds it to the formula at all 2^32 inputs.  A CTA
//     walks its cluster's tiles in turn and builds the next tile's aq, one
//     slab's columns per slab, while the tensor cores run the current
//     tile's product (two aq buffers).
//   - the rebuild: the gradient pass read nothing of the forward and rebuilt
//     a1 with a fourth product and its tanh.  Here the forward leaves each
//     block's a1c (bf16, or f32 with f32 weights) in a stash, in the order
//     its registers hold it, and the gradient pass reads it back coalesced;
//     the two passes run chunk by chunk (forward, gradient, dW1), so the
//     stash and the workspaces stay within the workspace budget.
//   - registers: a warpgroup's (64, 128) int32 accumulator takes 64
//     registers a thread, as before; a1c rides two bf16 to a register; the
//     epilogues reduce columns over the 8 lanes of a column by halving
//     exchanges (28 shuffles per 32 values, not 96) in chunks of 8 values,
//     and over the 4 warps of a warpgroup through shared memory in a fixed
//     order; da1's loop over the outputs sits outside the unrolled elements.
//     No atomics on floats: reruns are bit-identical.
// The dW1 operands are written straight from the registers that hold them:
// a workspace block is (512 rows, 64 pixels) in the wgmma layout with the
// pixels of each 16-row slice in the order (g, h) of the accumulator rows
// 16w + g + 8h; dW1 sums over all pixels of a group, so the order is free.
// The build-time switches of int8_tile.cuh act here too: SVT_INT8_RTZ
// through qround (the chain's thresholds included), SVT_INT8_BLOCK_SCALE
// through group_max; those of fused_loss_int8.cuh on SR, SVT_SR_SAME_SITE
// and SVT_SR_FLOOR, through grad_site and sr_q.
//
// Stochastic rounding (the SR instantiations): both sites round
// clip(floor(x + u), -7, 7) with u from Philox4x32-10 words keyed by
// (b1[0]'s f32 bits, the site) at counter (absolute image, decoder row in
// coords order, column / 4, 0), the words of philox.site_words, so the
// integer tiles are the block passes' and the plain version's:
//   - the a0 chain: the level depends on u, so the thresholds cannot serve;
//     the lane that builds columns 4c .. 4c + 3 of a pixel draws the one
//     Philox call of those four columns and rounds f32(7 tanh(h0)) + u;
//   - the forward leaves aq in the dW1 operand's workspace (it would be
//     written there by the gradient pass anyway), and the gradient pass reads
//     it back for dh0 instead of drawing the forward site's words and its
//     tanh once more;
//   - the gradient site: a thread holds columns 2t, 2t + 1 of a four-column
//     call for rows g and g + 8; lanes t and t ^ 1 share the calls of both
//     rows, so each draws one row's call and the pair trades two words by
//     shuffle;
//   - -DSVT_SR90_WS_ROW=1 builds the copy that takes the counter's row from
//     the dW1 workspace's pixel order (16 w + 2 g + h) instead of coords
//     order: the faulty copy that places the SR route's limits.


#pragma once

#include "fused_loss_int8.cuh"
#include "sm90.cuh"

namespace {

using namespace svt8;
using namespace sm90;

constexpr int CS = 4;                // CTAs per cluster (consecutive blocks)
constexpr int KW = 512;              // the padded width of every operand
constexpr int SB = 64;               // K bytes per W1 slab
constexpr int SLAB = KW * SB;        // 32 KiB: all 512 output rows
constexpr int QUARTER = SLAB / CS;   // one CTA's share of a slab
constexpr int TILE_B = PT * KW;      // a tile, 32 KiB
constexpr int WS_BLOCK = KW * PT;    // one block's dW1 operand, 32 KiB
constexpr int FWD_STAGES = 4;
constexpr int GRAD_STAGES = 3;
constexpr int WG = 4;                // warpgroups of a loss CTA
constexpr int SLOTS = 3;             // column sums reduced at a time

// A test build pairs each colored mean block with the block right after it
// (rank r with r ^ 1) instead of the one half a group further
// (-DSVT_COLORED90_PAIR_ADJACENT=1): the copy that places the cluster
// passes' colored limits, the pairing of the block passes' own copy.
#ifndef SVT_COLORED90_PAIR_ADJACENT
#define SVT_COLORED90_PAIR_ADJACENT 0
#endif
constexpr uint32_t PAIR = SVT_COLORED90_PAIR_ADJACENT ? 1u : 2u;

#ifndef SVT_SR90_WS_ROW
#define SVT_SR90_WS_ROW 0
#endif
// Two test builds move dh0 alone, the copies that place its limit (dfold's
// rows 0-2 on their own scale) on these passes: -DSVT_K3_90_DH0_ROW=1 takes
// (1 - a0^2) for dh0 from the pixel 8 rows on in the block (rows g and
// g + 8 swapped) in the default passes, -DSVT_SR90_AQ_OFF=1 reads aq for
// dh0 from the dW1 workspace one block off in the SR passes (the twin of
// the wide passes' SVT_K3W_AQ_OFF).  aq's workspace and every other output
// are the sound passes'.
#ifndef SVT_K3_90_DH0_ROW
#define SVT_K3_90_DH0_ROW 0
#endif
#ifndef SVT_SR90_AQ_OFF
#define SVT_SR90_AQ_OFF 0
#endif

// The counter's row of tile row p (0..63) of a block: p itself (coords
// order), or in the faulty copy its place in the dW1 workspace's order.
__device__ __forceinline__ int sr_row(int p) {
  return SVT_SR90_WS_ROW ? 16 * (p >> 4) + 2 * (p & 7) + ((p >> 3) & 1) : p;
}

struct FwdSmem {
  int8_t ring[FWD_STAGES][SLAB];
  int8_t aq[2][TILE_B];
  float red[WG * MAX_NO * PT];       // the head's partials per warpgroup
  float scratch[WARPS];
  float thr[8];                      // q7_fast's thresholds
  uint64_t full[FWD_STAGES], empty[FWD_STAGES];
  float zx[2 * PT];                  // colored: z, read by the partner CTA
};

struct GradSmem {
  int8_t ring[GRAD_STAGES][SLAB];
  int8_t aq[2][TILE_B];
  int8_t qi[TILE_B];
  float red[SLOTS][4][KW];           // column partials of a group's warps
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  float scratch[WARPS];
  float thr[8];
  uint64_t full[GRAD_STAGES], empty[GRAD_STAGES];
};
static_assert(sizeof(GradSmem) <= 232448, "opt-in shared memory on sm_90");
static_assert(sizeof(FwdSmem) <= 232448, "opt-in shared memory on sm_90");

// The dW1 kernels' stages (fused_loss_int8_sm90.cu, and past H = 512
// fused_loss_int8_sm90_wide.cu): DW_BLK 64-pixel blocks of both operands,
// 128 rows each, a stage.
constexpr int DW_NT = 256;                 // two warpgroups of 64 rows
constexpr int DW_STAGES = 3;
constexpr int DW_BLK = 4;                  // blocks per stage
constexpr int DW_OP = 128 * PT;            // one operand of one block: 8 KiB
constexpr int DW_STAGE = 2 * DW_BLK * DW_OP;   // DW_BLK aq, then DW_BLK qi
constexpr int DW_WARPS = DW_NT / 32;

struct DwSmem {
  int8_t ring[DW_STAGES][DW_STAGE];
  uint64_t full[DW_STAGES], empty[DW_STAGES];
};
static_assert(sizeof(DwSmem) <= 232448, "opt-in shared memory on sm_90");

// The ring of W1 slabs of one CTA: its stream is the slabs of `w` (one
// weight's slab stream) once for every tile it runs, each slab multicast to
// the cluster's four rings in quarters, one per CTA.  Every warp of every CTA
// releases each slab it has read; thread 0 refills a stage once its slab is
// released cluster-wide, one slab behind the consumption, so S - 1 slabs are
// in flight.
template <int S>
struct Ring {
  int8_t (*buf)[SLAB];
  uint64_t* full;
  uint64_t* empty;
  const int8_t* w;
  int nslab, total;
  uint32_t rank;

  __device__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS * CS);
    }
    fence_mbar_init();
  }
  // thread 0: slab `seq` of the stream into its stage, once every CTA of
  // the cluster has released the stage's previous slab
  __device__ void fetch(int seq) const {
    const int st = seq % S;
    if (seq >= S) mbar_wait(&empty[st], uint32_t(seq / S - 1) & 1u);
    mbar_expect_tx(&full[st], SLAB);
    const int8_t* src = w + size_t(seq % nslab) * SLAB + rank * QUARTER;
    bulk_multicast(buf[st] + rank * QUARTER, src, QUARTER, &full[st],
                   uint16_t((1u << CS) - 1));
  }
  __device__ void start() const {
    if (threadIdx.x == 0)
      for (int s = 0; s < S && s < total; ++s) fetch(s);
  }
  __device__ const int8_t* wait(int seq) const {
    mbar_wait(&full[seq % S], uint32_t(seq / S) & 1u);
    return buf[seq % S];
  }
  // every warp, once its products on slab `seq` are complete
  __device__ void release(int seq) const {
    release_cluster(&empty[seq % S], CS);
  }
  // thread 0, after its warp released slab seq - 1: refill that stage
  __device__ void refill(int seq) const {
    if (threadIdx.x == 0 && seq >= 1 && seq - 1 + S < total)
      fetch(seq - 1 + S);
  }
};

// Byte offset of (pixel p, column k) in a (64, 512) tile: eight swizzled
// column blocks of 64 K-bytes, 4 KiB each.
__device__ __forceinline__ int tile_off(int p, int k) {
  return (k >> 6) * (PT * SB) + offset_sw64(p, k & 63);
}

// The warpgroup's products of one slab: acc (+)= tile[:, 64 s .. +63] .
// slab[128 wg .. +127, :]^T, committed as one group.
__device__ __forceinline__ void mma_slab(int (&acc)[64], const int8_t* tile,
                                         int s, const int8_t* slab, int wg,
                                         bool first) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SB; kk += 32) {
    const uint64_t da = gmma_desc_sw64(tile + s * (PT * SB) + kk);
    const uint64_t db = gmma_desc_sw64(slab + 128 * wg * SB + kk);
    wgmma_s8_n128(acc, da, db, first && kk == 0 ? 0 : 1);
  }
  wgmma_commit();
}

// acc = tile (64, Kp) . W^T over the `nslab` slabs seq0 .. of the ring, one
// slab's products in flight behind the next one's start; side(s) runs while
// the tensor cores work on slab s (and s - 1).
template <int S, typename Side>
__device__ __forceinline__ void ring_product(int (&acc)[64],
                                             const int8_t* tile,
                                             const Ring<S>& ring, int seq0,
                                             int nslab, int wg, Side side) {
  for (int s = 0; s < nslab; ++s) {
    const int seq = seq0 + s;
    mma_slab(acc, tile, s, ring.wait(seq), wg, s == 0);
    side(s);
    wgmma_wait<1>();                   // slab seq - 1's products are done
    if (s > 0) ring.release(seq - 1);
    ring.refill(seq);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  ring.release(seq0 + nslab - 1);
}

// aq's quantisation, as first_layer_qx computes it: clip(round(7 tanh(h0)),
// -7, 7) (round as qround: to nearest even, or toward zero in the copy that
// places the limits).
__device__ __forceinline__ float q7(float h0) {
  return fminf(fmaxf(qround(__fmul_rn(tanhf(h0), 7.f)), -7.f), 7.f);
}

// The smallest x >= 0 with q7(x) >= k (1 <= k <= 7), by bisection over the
// float bit patterns between q7(+0) = 0 and q7(+inf) = 7.
__device__ __forceinline__ float q7_threshold(int k) {
  uint32_t lo = 0u, hi = 0x7F800000u;
  while (hi - lo > 1u) {
    const uint32_t mid = lo + (hi - lo) / 2u;
    if (q7(__uint_as_float(mid)) >= float(k)) hi = mid;
    else lo = mid;
  }
  return __uint_as_float(hi);
}

// q7 from the thresholds thr[k - 1] = q7_threshold(k): the level counts
// the thresholds |h0| reaches, with h0's sign; NaN gives -7, as q7's
// fmaxf does.  Equal to q7 at every one of the 2^32 inputs where q7 is
// monotone in |h0| and odd (svt_loss90_chain_check counts the inputs where
// they differ; the card tests and chip_smoke.py hold it to 0), at 7
// compares in place of tanhf: the a0 chain was the passes' largest part.
__device__ __forceinline__ int q7_fast(float h0, const float* thr) {
  const float ax = fabsf(h0);
  int q = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) q += ax >= thr[k];
  q = h0 < 0.f ? -q : q;
  return h0 != h0 ? -7 : q;
}

// Threads 0..6 of the block write the thresholds; the caller syncs.
__device__ __forceinline__ void q7_thresholds(float* thr) {
  if (threadIdx.x < 7) thr[threadIdx.x] = q7_threshold(threadIdx.x + 1);
}

// Columns 64 s .. +63 of aq for pixels p0 .. p0+63 of image b into `tile`:
// q = clip(round(7 tanh(x0*w0 + x1*w1 + c)), -7, 7), 0 past H, as
// first_layer_qx computes it, through q7_fast; with SR clip(floor(f32(7
// tanh(h0)) + u), -7, 7), u from the forward site's words of Philox call
// (img, pb + the pixel's row, column / 4, 0) under key (seed, SITE_FWD), as
// first_layer_qx_quad draws them (pb: the call's first row, where coords is
// a pixel shard's slice of it).  Warp wi takes 16 columns (wi % 4) of the
// pixel groups wi / 4 and wi / 4 + 4; lane 4r + c the columns 4c .. +3 of
// pixel 8 * group + r (one Philox call): one 32-bit store, 32 banks per
// warp.
template <bool SR>
__device__ __forceinline__ void chain_part(const float* __restrict__ fold,
                                           const float* __restrict__ coords,
                                           int b, int p0, int H, int s,
                                           const float* thr, int8_t* tile,
                                           int img, uint32_t seed,
                                           int pb = 0) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int k0 = s * SB + (wi & 3) * 16 + (lane & 3) * 4;
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
    const int pix = p0 + p;
    const float x0 = coords[2 * pix], x1 = coords[2 * pix + 1];
    uint4 wd = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (SR)
      if (k0 < H)
        wd = philox4x32_10(
            make_uint4(uint32_t(img), uint32_t(pb + p0 + sr_row(p)),
                       uint32_t(k0 / 4), 0u),
            seed, SITE_FWD);
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + j >= H) continue;
      const float h0 = first_h0(x0, x1, w0[j], w1[j], c[j]);
      int q;
      if constexpr (SR)
        q = int(sr_round(__fmul_rn(tanhf(h0), 7.f), word_of(wd, j), 7.f));
      else
        q = q7_fast(h0, thr);
      packed |= uint32_t(uint8_t(int8_t(q))) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(tile + tile_off(p, k0)) = packed;
  }
}

template <bool SR>
__device__ __forceinline__ void chain_tile(const float* __restrict__ fold,
                                           const float* __restrict__ coords,
                                           int b, int p0, int H, int from,
                                           const float* thr, int8_t* tile,
                                           int img, uint32_t seed,
                                           int pb = 0) {
  for (int s = from; s < KW / SB; ++s)
    chain_part<SR>(fold, coords, b, p0, H, s, thr, tile, img, seed, pb);
}

// The block's aq tile (its rows p, the accumulator rows 16 w + g + 8 h) to
// the dW1 operand's workspace block: column n's bytes of rows g and g + 8 at
// 16 w + 2 g and + 1 of workspace row n, this thread's 32 columns.
__device__ __forceinline__ void aq_to_ws(const int8_t* aq, int8_t* aq_ws,
                                         int wg, int w, int g, int t) {
  const int px0 = 16 * w + g, px1 = px0 + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int n0 = acc_col(wg, t, 4 * nt);
    const uint16_t r0 =
        *reinterpret_cast<const uint16_t*>(aq + tile_off(px0, n0));
    const uint16_t r1 =
        *reinterpret_cast<const uint16_t*>(aq + tile_off(px1, n0));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<uint16_t*>(aq_ws +
                                   offset_sw64(n0 + e, 16 * w + 2 * g)) =
          uint16_t((r0 >> (8 * e)) & 0xFF) |
          uint16_t(((r1 >> (8 * e)) & 0xFF) << 8);
  }
}

// The gradient site's words of this thread's elements of accumulator
// columns 8 nt + 2t, + 1 (e) and rows g + 8 h of the block at p0 of image
// img: word 2 (t & 1) + e of call (img, row, column / 4, 0).  Lanes t and
// t ^ 1 need both rows' calls; each draws the call of row t & 1 and hands
// its partner the two words the partner needs.
__device__ __forceinline__ void sr_grad_words(uint32_t (&wd)[2][2], int img,
                                              int p0, int wg, int w, int g,
                                              int t, int nt, uint32_t seed) {
  const uint32_t quad = uint32_t(32 * wg + 2 * nt + (t >> 1));
  const bool odd = t & 1;
  const uint4 c = philox4x32_10(
      make_uint4(uint32_t(img),
                 uint32_t(p0 + sr_row(16 * w + g + 8 * int(odd))), quad, 0u),
      seed, grad_site());
  // this lane's own words of its row's call, and those its partner needs
  const uint32_t own0 = odd ? c.z : c.x, own1 = odd ? c.w : c.y;
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? c.x : c.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? c.y : c.w, 1);
  wd[0][0] = odd ? got0 : own0;
  wd[0][1] = odd ? got1 : own1;
  wd[1][0] = odd ? own0 : got0;
  wd[1][1] = odd ? own1 : got1;
}

// The thread's a1c in registers, element j as the accumulator's: with bf16
// weights the values are bf16, two to a register (elements 2i, 2i+1 in the
// low and high halves), which halves what the gradient pass holds through
// its epilogue; f32 otherwise.  j must be a compile-time index.
template <bool BF16>
struct A1c {
  static constexpr int WORDS = 32;
  uint32_t v[32];
  __device__ __forceinline__ uint32_t word(int i) const { return v[i]; }
  __device__ __forceinline__ void set_word(int i, uint32_t u) { v[i] = u; }
  __device__ __forceinline__ float get(int j) const {
    return __uint_as_float((j & 1) ? (v[j >> 1] & 0xFFFF0000u)
                                   : (v[j >> 1] << 16));
  }
  __device__ __forceinline__ void set(int j, float x) {
    const uint32_t b = __float_as_uint(x) >> 16;
    v[j >> 1] = (j & 1) ? (v[j >> 1] | (b << 16)) : b;
  }
};
template <>
struct A1c<false> {
  static constexpr int WORDS = 64;
  float v[64];
  __device__ __forceinline__ uint32_t word(int i) const {
    return __float_as_uint(v[i]);
  }
  __device__ __forceinline__ void set_word(int i, uint32_t u) {
    v[i] = __uint_as_float(u);
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
  __device__ __forceinline__ void set(int j, float x) { v[j] = x; }
};

// a1c = cast(tanh(acc * h1s + b1)) in the accumulator layout, 0 past H.
template <bool BF16>
__device__ __forceinline__ void a1_epilogue(const int (&acc)[64],
                                            const float* __restrict__ h1s,
                                            const float* __restrict__ b1,
                                            int H, int wg, int t,
                                            A1c<BF16>& a1c) {
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int n = acc_col(wg, t, j);
    const bool on = n < H;
    const float sc = on ? h1s[n] : 0.f, bn = on ? b1[n] : 0.f;
    const float x = __fadd_rn(__fmul_rn(float(acc[j]), sc), bn);
    a1c.set(j, on ? operand<BF16>(tanhf(x)) : 0.f);
  }
}

// The colored family's block for CTA `rank` of quad q, the flattened
// (image, block) index: the quads of each group in turn, Pt/256 of them,
// quad j taking the group's mean blocks 2j and 2j + 1 on ranks 0 and 1 and
// their log-variance partners, Pt/128 blocks further, on ranks 2 and 3.
// At Pt = 256 this is block 4 q + rank.
__device__ __forceinline__ int colored_block(int q, uint32_t rank, int Pt) {
  const int qpg = Pt / (CS * PT);
  return q / qpg * (Pt / PT) + 2 * (q % qpg) + int(rank & 1u) +
         int(rank >> 1) * (Pt / (2 * PT));
}

// ---- pass 1 on clusters: forward, loss, dz2, each block's loss and max
// |dz2| (the bound's source), and each block's a1c to the stash `ws`
// (A1c::WORDS words a thread) for the gradient pass.  The four CTAs of a
// cluster walk the quads (4 blocks of one group) cid, cid + clusters, ...;
// CTA `rank` runs block 4 quad + rank of the flattened (image, block) grid,
// or in the colored family block colored_block(quad, rank, Pt): the pair's
// terms need both head outputs, and the partner's z comes through
// distributed shared memory (zx), behind a cluster barrier; the barrier's
// second half, before the next tile writes zx, waits for the partner's read.
// COLORED is a template parameter: the other families' kernel has no trace
// of the exchange; SR too (stochastic rounding at the forward site, the
// launch's images b0 .. and pixels pb .. of the call, aq left in the dW1
// workspace `aq_ws` for the gradient pass): the default kernels have no
// trace of it.
template <bool BF16, bool COLORED, bool SR>
__device__ __forceinline__ void loss_fwd90_body(const LossFwdArgs& a,
                                                int nquads, int b0 = 0,
                                                int8_t* aq_ws = nullptr,
                                                int pb = 0) {
  extern __shared__ __align__(128) uint8_t smem90[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const int nslab = padded_k(H) / SB;
  const Ring<FWD_STAGES> ring{sm.ring, sm.full, sm.empty, a.w1fT, nslab,
                              ntl * nslab, cluster_rank()};
  if (tid == 0) ring.init();
  uint32_t seed = 0u;
  if constexpr (SR) seed = __float_as_uint(a.b1[0]);
  else q7_thresholds(sm.thr);
  cluster_sync();
  ring.start();
  auto block_of = [&](int k) {
    const int q = cid + k * ncl;
    return COLORED ? colored_block(q, ring.rank, a.Pt)
                   : q * CS + int(ring.rank);
  };

  if (ntl > 0) {
    const int tb = block_of(0);
    chain_tile<SR>(a.fold, a.coords, tb / blocks, (tb % blocks) * PT, H, 0,
                   sm.thr, sm.aq[0], b0 + tb / blocks, seed, pb);
    fence_proxy_async();
  }
  __syncthreads();
  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), b = tb / blocks, p0 = (tb % blocks) * PT;
    const bool more = k + 1 < ntl;
    const int nb = more ? block_of(k + 1) : 0;
    int8_t* next = sm.aq[(k + 1) & 1];
    int acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    ring_product(acc, sm.aq[k & 1], ring, k * nslab, nslab, wg, [&](int s) {
      if (more)
        chain_part<SR>(a.fold, a.coords, nb / blocks, (nb % blocks) * PT, H,
                       s, sm.thr, next, b0 + nb / blocks, seed, pb);
    });
    if (more) {
      chain_tile<SR>(a.fold, a.coords, nb / blocks, (nb % blocks) * PT, H,
                     nslab, sm.thr, next, b0 + nb / blocks, seed, pb);
      fence_proxy_async();
    }
    // SR: the tile's aq to its dW1 workspace block (its rows read before
    // the epilogue's barriers, past which the tile after next overwrites it)
    if constexpr (SR)
      aq_to_ws(sm.aq[k & 1], aq_ws + size_t(tb) * WS_BLOCK, wg, w, g, t);

    A1c<BF16> a1c;
    a1_epilogue<BF16>(acc, a.h1s, a.b1, H, wg, t, a1c);
    // a1c to the stash the gradient pass reads: word i of thread tid of
    // block tb at (tb * WORDS + i) * NT + tid, coalesced both ways
    uint32_t* stash = reinterpret_cast<uint32_t*>(a.ws) +
                      size_t(tb) * A1c<BF16>::WORDS * NT + tid;
#pragma unroll
    for (int i = 0; i < A1c<BF16>::WORDS; ++i) stash[i * NT] = a1c.word(i);
    // the head's row sums: this thread's 32 columns, the 4 lanes of a row,
    // the 4 warpgroups in order
    for (int o = 0; o < No; ++o) {
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        if (j & 2) continue;
        const int n = acc_col(wg, t, j);
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
    float per = 0.f, d = 0.f;
    if constexpr (COLORED) {
      float z = 0.f;
      if (tid < 2 * PT)
        for (int q = 0; q < WG; ++q)
          z += sm.red[(q * MAX_NO + tid / PT) * PT + tid % PT];
      if (k > 0) cluster_wait();         // the partner has read zx
      if (tid < 2 * PT) sm.zx[tid] = z;
      cluster_sync();
      const float zp = tid < 2 * PT ? ld_cluster(&sm.zx[tid], ring.rank ^ PAIR)
                                    : 0.f;
      cluster_arrive();
      const bool mean = !(ring.rank & PAIR);
      // the pair's mean block, its first pixel within the image
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
        const float w = __fmul_rn(dd, expf(-lv));
        const float dw = __fmul_rn(dd, w);
        per = __fadd_rn(dw, lv);
        float dmu = __fmul_rn(w, __fmul_rn(mu, __fsub_rn(1.f, mu)));
        float dlv = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(1.f, dw)),
                              __fmul_rn(lv, __fsub_rn(1.f, lv)));
        if (a.mask != nullptr) {
          const float m = a.mask[size_t(o) * (HW / 2) + pair];
          per = __fmul_rn(per, m);
          dmu = __fmul_rn(dmu, m);
          dlv = __fmul_rn(dlv, m);
        }
        d = mean ? dmu : dlv;
        a.dz2[(size_t(b) * 2 + o) * HW + p0 + u] = d;
      }
      // the pair's loss once, on its mean block
      const float bsum = mean ? block_sum(per, sm.scratch) : 0.f;
      const float bmax = block_max(fabsf(d), sm.scratch);
      if (tid == 0) {
        a.part_bce[tb] = __fmul_rn(0.5f, bsum);
        a.part_max[tb] = bmax;
      }
      continue;
    }
    if (tid < No * PT) {
      const int o = tid / PT, pix = p0 + tid % PT;
      float z = 0.f;
      for (int q = 0; q < WG; ++q)
        z += sm.red[(q * MAX_NO + o) * PT + tid % PT];
      const size_t at = (size_t(b) * No + o) * HW + pix;
      const float s = sigmoidf(__fadd_rn(z, a.bht[o]));
      const float y = load_target(a.yt, at, a.yt_i8);
      const float m = a.mask != nullptr ? a.mask[pix] : 1.f;
      if (a.family == GAUSSIAN) {
        d = __fsub_rn(s, y);
        per = __fmul_rn(d, d);
        if (a.mask != nullptr) {
          per = __fmul_rn(per, m);
          d = __fmul_rn(d, m);
        }
        d = __fmul_rn(d, __fmul_rn(s, __fsub_rn(1.f, s)));
      } else {
        const float ls = fmaxf(logf(s), -100.f);
        const float l1 = fmaxf(log1pf(-s), -100.f);
        per = __fadd_rn(__fmul_rn(y, ls), __fmul_rn(__fsub_rn(1.f, y), l1));
        d = __fmul_rn(s, __fsub_rn(1.f, s)) == 0.f ? 0.f : __fsub_rn(s, y);
        if (a.mask != nullptr) {
          per = __fmul_rn(per, m);
          d = __fmul_rn(d, m);
        }
      }
      a.dz2[at] = d;
    }
    const float bsum = block_sum(per, sm.scratch);
    const float bmax = block_max(fabsf(d), sm.scratch);
    if (tid == 0) {
      a.part_bce[tb] = a.family == GAUSSIAN ? __fmul_rn(0.5f, bsum) : -bsum;
      a.part_max[tb] = bmax;
    }
  }
  if (COLORED && ntl > 0) cluster_wait();  // every partner's last read
  cluster_sync();
}

// Sum slot s's column partials over the 4 warps of each column's warpgroup,
// in warp order: thread tid's column n = tid.
__device__ __forceinline__ float column_sum(const GradSmem& sm, int s) {
  const int n = threadIdx.x;
  float v = sm.red[s][0][n];
  v += sm.red[s][1][n];
  v += sm.red[s][2][n];
  v += sm.red[s][3][n];
  return v;
}

// ---- pass 2 on clusters: the group's scale, q, qi, db1, dWh^T and dbh
// partials, da0 and the dfold partials, and the dW1 operands aq and qi in
// the workspaces (one WS_BLOCK per image of the chunk and block), for
// images b0 .. b0+Bc-1 (the tiles of the chunk as in pass 1, which ran on
// the same chunk and left each tile's a1c in the stash `ws`: reading it
// back costs less than the W1f product and the tanh that rebuild it).
// SR: the gradient site rounds stochastically (sr_grad_words, its counters'
// rows from the call's pixel pb on), and aq comes back from the dW1
// workspace where pass 1 left it.
template <bool BF16, bool SR>
__device__ __forceinline__ void loss_grad90_body(const LossGradArgs& a,
                                                 int nquads, int pb = 0) {
  // whether this pass builds aq itself (under SR pass 1 left it in aq_ws)
  constexpr bool CHAIN = !SR;
  extern __shared__ __align__(128) uint8_t smem90[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int Mw = H + No * H + No;
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const int nslab = padded_k(H) / SB;
  const Ring<GRAD_STAGES> ring{sm.ring, sm.full, sm.empty, a.w1r, nslab,
                               ntl * nslab, cluster_rank()};
  if (tid == 0) ring.init();
  uint32_t seed = 0u;
  if constexpr (SR) seed = __float_as_uint(a.b1[0]);
  else q7_thresholds(sm.thr);
  cluster_sync();
  ring.start();
  auto block_of = [&](int k) { return (cid + k * ncl) * CS + int(ring.rank); };
  const float cinv = rb(__fdiv_rn(1.f, a.lf));

  if (CHAIN && ntl > 0) {
    const int tb = block_of(0);
    chain_tile<SR>(a.fold, a.coords, a.b0 + tb / blocks, (tb % blocks) * PT,
                   H, 0, sm.thr, sm.aq[0], a.b0 + tb / blocks, seed);
    fence_proxy_async();
  }
  __syncthreads();
  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), bl = tb / blocks, blk = tb % blocks;
    const int b = a.b0 + bl, p0 = blk * PT;
    const size_t gblk = size_t(b) * blocks + blk;
    const bool more = k + 1 < ntl;
    const int nb = more ? block_of(k + 1) : 0;
    const int8_t* aq = sm.aq[k & 1];
    int8_t* next = sm.aq[(k + 1) & 1];
    int8_t* aq_ws = a.aq_ws + size_t(tb) * WS_BLOCK;
    int8_t* q_ws = a.q_ws + size_t(tb) * WS_BLOCK;
    float* pw = a.part_w + gblk * Mw;
    // a1c as the forward pass left it
    A1c<BF16> a1c;
    const uint32_t* stash = reinterpret_cast<const uint32_t*>(a.ws) +
                            size_t(tb) * A1c<BF16>::WORDS * NT + tid;
#pragma unroll
    for (int i = 0; i < A1c<BF16>::WORDS; ++i) a1c.set_word(i, stash[i * NT]);

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

    // q, qi (to the tile and the workspace) and db1's column sums (slot 0)
    const int px0 = 16 * w + g, px1 = px0 + 8;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      // da1 = sum_o cast(dz2[o][p]) * wht[o][n], each product and sum
      // rounded in order (da1_at's order), the outputs outside the unrolled
      // chunk of 16 elements
      float da1[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) da1[i] = 0.f;
      for (int o = 0; o < No; ++o) {
        const float d0 = sm.dzc[o * PT + px0], d1 = sm.dzc[o * PT + px1];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = acc_col(wg, t, 16 * ch + i);
          const float wv = n < H ? __ldg(a.wht + size_t(o) * H + n) : 0.f;
          da1[i] = __fadd_rn(da1[i], __fmul_rn(i & 2 ? d1 : d0, wv));
        }
      }
      float col[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nt = 4 * ch + u;
        uint32_t wd[2][2];
        if constexpr (SR)
          sr_grad_words(wd, b, pb + p0, wg, w, g, t, nt, seed);
        int8_t qv[4];
#pragma unroll
        for (int hc = 0; hc < 4; ++hc) {      // hc = 2 h + e
          const int j = 4 * nt + hc;
          const int n = acc_col(wg, t, j);
          float q = 0.f, qi = 0.f;
          if (n < H) {
            const float av = a1c.get(j);
            const float tf = BF16 ? rb(__fsub_rn(1.f, rb(__fmul_rn(av, av))))
                                  : __fsub_rn(1.f, __fmul_rn(av, av));
            q = __fmul_rn(__fmul_rn(da1[4 * u + hc], tf), qs);
            if constexpr (SR) qi = sr_q(q, wd[hc >> 1][hc & 1], a.lv);
            else qi = fminf(fmaxf(qround(q), -a.lv), a.lv);
          }
          qv[hc] = static_cast<int8_t>(qi);
          if (hc < 2) col[2 * u + hc] = q;
          else col[2 * u + hc - 2] += q;
        }
        const int n0 = acc_col(wg, t, 4 * nt);
        // the tile: (pixel, 2 columns); the workspace: (column, 2 pixels)
        *reinterpret_cast<uint16_t*>(sm.qi + tile_off(px0, n0)) =
            uint16_t(uint8_t(qv[0])) | uint16_t(uint8_t(qv[1])) << 8;
        *reinterpret_cast<uint16_t*>(sm.qi + tile_off(px1, n0)) =
            uint16_t(uint8_t(qv[2])) | uint16_t(uint8_t(qv[3])) << 8;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<uint16_t*>(
              q_ws + offset_sw64(n0 + e, 16 * w + 2 * g)) =
              uint16_t(uint8_t(qv[e])) | uint16_t(uint8_t(qv[2 + e])) << 8;
      }
      const float s = reduce_scatter8(col);
      sm.red[0][w][chunk_col(wg, t, g, ch)] = s;
    }
    // dWh^T's column sums, sum_p cast(dz2[o][p]) * a1c[p][n], in the slots
    // after db1's; every SLOTS filled slots are summed over the warps
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
        const int n = tid;
        if (n < H)
          for (int s = 0; s < used; ++s) {
            const int oo = first_o + s;
            const float v = column_sum(sm, s);
            if (oo < 0) pw[n] = __fmul_rn(v, sg);
            else pw[H + oo * H + n] = v;
          }
        __syncthreads();
        used = 0;
        first_o = o + 1;
      }
    }
    if (tid < No) {                           // dbh partials
      float s = 0.f;
      for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
      pw[H + No * H + tid] = s;
    }
    fence_proxy_async();
    __syncthreads();                          // the qi tile is complete

    // da0 = qi . W1r^T; the next tile's aq beside it
    int acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    ring_product(acc, sm.qi, ring, k * nslab, nslab, wg, [&](int s) {
      if (CHAIN && more)
        chain_part<SR>(a.fold, a.coords, a.b0 + nb / blocks,
                       (nb % blocks) * PT, H, s, sm.thr, next,
                       a.b0 + nb / blocks, seed);
    });
    if (CHAIN && more) {
      chain_tile<SR>(a.fold, a.coords, a.b0 + nb / blocks, (nb % blocks) * PT,
                     H, nslab, sm.thr, next, a.b0 + nb / blocks, seed);
      fence_proxy_async();
    }
    // the dh0 chain (bf16) and the dfold partials, aq to its workspace (or,
    // where pass 1 left it there, from it: a uint16 holds rows g and g + 8
    // of one column)
    const float x00 = rb(a.coords[2 * (p0 + px0)]);
    const float x01 = rb(a.coords[2 * (p0 + px0) + 1]);
    const float x10 = rb(a.coords[2 * (p0 + px1)]);
    const float x11 = rb(a.coords[2 * (p0 + px1) + 1]);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      float s0[8], s1[8], s2[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nt = 4 * ch + u;
        const int n0 = acc_col(wg, t, 4 * nt);
        uint16_t r0, r1;
        if constexpr (CHAIN) {
          r0 = *reinterpret_cast<const uint16_t*>(aq + tile_off(px0, n0));
          r1 = *reinterpret_cast<const uint16_t*>(aq + tile_off(px1, n0));
        } else {
          const int8_t* src =
              SVT_SR90_AQ_OFF
                  ? a.aq_ws + size_t((tb + 1) % int(a.grid)) * WS_BLOCK
                  : aq_ws;
          const uint16_t v0 = *reinterpret_cast<const uint16_t*>(
              src + offset_sw64(n0, 16 * w + 2 * g));
          const uint16_t v1 = *reinterpret_cast<const uint16_t*>(
              src + offset_sw64(n0 + 1, 16 * w + 2 * g));
          r0 = uint16_t((v0 & 0xFF) | ((v1 & 0xFF) << 8));
          r1 = uint16_t((v0 >> 8) | (v1 & 0xFF00));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (CHAIN)
            *reinterpret_cast<uint16_t*>(
                aq_ws + offset_sw64(n0 + e, 16 * w + 2 * g)) =
                uint16_t((r0 >> (8 * e)) & 0xFF) |
                uint16_t(((r1 >> (8 * e)) & 0xFF) << 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = n0 + e;
            float dh0 = 0.f;
            if (i < H) {
              const bool hr = CHAIN && SVT_K3_90_DH0_ROW ? !h : h;
              const float aqv =
                  float(int8_t(((hr ? r1 : r0) >> (8 * e)) & 0xFF));
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
    if (tid < H) {
      const float dsc = __fmul_rn(sg, a.s4[tid]);
      float* pf = a.part_fold + gblk * 3 * H;
      pf[tid] = __fmul_rn(column_sum(sm, 0), dsc);
      pf[H + tid] = __fmul_rn(column_sum(sm, 1), dsc);
      pf[2 * H + tid] = __fmul_rn(column_sum(sm, 2), dsc);
    }
    __syncthreads();
  }
  cluster_sync();
}

template <typename K>
int cached_clusters(K k, int threads, int smem, int* cache) {
  if (*cache <= 0) *cache = max_clusters(k, threads, smem, CS);
  return *cache;
}

}  // namespace
