// K4 and K5 redesigned for Hopper: the int8 decoder tail's passes at H <= 512
// on thread block clusters, int8 wgmma and multicast bulk copies.  Included by
// fused_decoder_int8_sm90.cu (the passes the wrappers launch and their entry
// points).
//
// Replaces, like the block passes of fused_decoder_int8.cu, the Pallas TPU
// kernels spatialvae_tpu/kernels/fused_decoder_int8.py `_fwd_kernel` (:60)
// and `_bwd_kernel` (:95).  It computes what those passes compute (the
// formulas are in fused_decoder_int8.cu): the integer products are exact,
// W1q and sw are per tensor, a0q has 127 levels, K5's scale is taken over
// a whole pick_tile(HW) group, and every epilogue's op order is the same,
// so only the order of the head's row sums and of the column reductions
// moves the floats.  The wrapper's int8_route sends a call here at H <= 512
// (HW a multiple of 256, so four consecutive 64-pixel blocks lie in one
// quantisation group); wider decoders keep the block passes.
//
// What bounds it on this card: three int8 products of 2*HW*Kp^2 ops per
// image (forward, da0, dW1; a fourth with recompute), 4.4 T ops each at
// B=2,048, 2.2 ms at the 1,979 TOP/s int8 peak; and the CUDA-core work, 4.3e9
// exact tanhf at B=2,048 for a0 and as many for a1, with the head's and the
// gradient's f32 work beside them.  The block passes lost their time in
// five places, and the design answers each:
//   - L2: a 64-pixel block streamed the whole 256 KiB W1q from L2 for every
//     product.  Here the four CTAs of a cluster, four consecutive blocks of
//     one image, share one stream of W1q slabs laid out by the host in the
//     order shared memory takes them; each CTA fetches a quarter and
//     multicasts it, so W1q leaves L2 once per 256 pixels.
//   - the tensor cores: every product is int8 wgmma from shared memory in
//     the 64-byte swizzled layout (sm90.cuh).
//   - the serial epilogue: the forward splits each warpgroup's 128 columns
//     into two halves of 64 (m64n64k32, an accumulator of 32 registers a
//     half), and runs each half's epilogue right after its product, the
//     next tile's a0q built beside the products (two aq buffers), so one
//     accumulator is live and ptxas keeps the products asynchronous.  The
//     W1q^T stream carries half slabs (256 rows) in the order the halves
//     take them, so the bytes per tile do not change.  The ping-pong
//     schedule (PINGPONG: one half's epilogue, the head's products
//     included, beside the other half's product) holds both accumulators
//     and commits the head's products between the ring's steps; ptxas
//     serializes its wgmma (C7520 "WG.AR in divergent path", C7511/C7513
//     register pressure), and it measured slower on the H100, so only a
//     timing copy runs it (SVT_I8_90_PINGPONG below).
//   - the head: z = cast(a1) . wht^T on the tensor cores, the accumulator
//     registers of a1 the A operand of m64n8k8 TF32 products (exact for
//     bf16 weights in one product, f32 as three), where the block passes
//     spent a load and an FMA per output per element.
//   - the a0 chain: round(127 tanh(h0)) takes one of 255 values, so K3's
//     seven thresholds do not carry over.  Tables of the 127 thresholds
//     (looked up from a tanh.approx guess, or by a 7-step bisection)
//     measured no faster than exact tanhf on the H100, so the passes run
//     exact tanhf: q127 below is the formula itself.
//   - the a1 traffic: K4 stages the bf16 a1 of a block in shared memory, in
//     the packed (64, H) rows of the output, and writes it with bulk copies;
//     K5's scale pass reads it back with one bulk copy per block, and its
//     gradient pass column by column (a warp reads 64 contiguous bytes of a
//     row).  With recompute, the scale pass rebuilds a1 on the forward's
//     cluster machinery and leaves it (f32) in a stash the gradient pass
//     reads, chunk by chunk within the workspace budget.
//   - dW1: the gradient pass writes a0q and dh1q in the workspace layout of
//     K3's cluster dW1 kernel (svt_loss90_dw), which runs them.
// Every cross-block sum is a per-block partial reduced by svt_sum_rows in a
// fixed order: no float atomics, reruns are bit-identical.
//
// Build-time switches (the library the wrappers load is built with all of
// them at 0).  The faulty copies of `chip_smoke.py --limits int8_90`:
//   SVT_I8_90_WRONG_QUARTER=1  CTA 1 of a cluster multicasts its quarter of
//                              the next slab of the stream, not this one's;
//   SVT_I8_90_A1_RTZ=1         K4 emits a1 truncated to bf16, not rounded;
//   SVT_INT8_BLOCK_SCALE=1     (int8_tile.cuh) K5's scale per 64-pixel block.
// The timing copies of chip_smoke.py's `[int8_sm90_split]`, each a library
// of its own; they change the bf16 calls named and nothing else:
//   SVT_I8_90_PINGPONG=1       K4 (without and with a1) on the ping-pong
//                              schedule;
//   SVT_I8_90_CUT=1 or 2       K4 without a1 and K5's gradient pass from the
//                              residual cut to the product alone (the
//                              accumulator summed into the outputs) or to
//                              the epilogue alone (no product).

#pragma once

#include "int8_tile.cuh"
#include "sm90.cuh"

#ifndef SVT_I8_90_WRONG_QUARTER
#define SVT_I8_90_WRONG_QUARTER 0
#endif
#ifndef SVT_I8_90_A1_RTZ
#define SVT_I8_90_A1_RTZ 0
#endif
#ifndef SVT_I8_90_PINGPONG
#define SVT_I8_90_PINGPONG 0
#endif
#ifndef SVT_I8_90_CUT
#define SVT_I8_90_CUT 0
#endif

namespace {

using namespace svt8;
using namespace sm90;

constexpr int CS = 4;                // CTAs per cluster (consecutive blocks)
constexpr int KW = 512;              // the padded width of every operand
constexpr int SB = 64;               // K bytes per slab
constexpr int HSLAB = 256 * SB;      // a half slab of W1q^T: 16 KiB
constexpr int SLAB = KW * SB;        // a whole slab of W1q: 32 KiB
constexpr int TILE_B = PT * KW;      // an int8 tile, 32 KiB
constexpr int WS_BLOCK = KW * PT;    // one block's dW1 operand, 32 KiB
constexpr int GRAD_STAGES = 4;
constexpr int WG = 4;                // warpgroups of a CTA
constexpr int SLOTS = 3;             // column sums reduced at a time
constexpr int NSTEP = KW / SB;       // slabs of a full-width product

// what the forward kernel computes per tile
enum FwdMode { MODE_Y = 0, MODE_EMIT = 1, MODE_SCALE = 2 };
// its schedule: the epilogue of one half beside the other half's product,
// or after each half's product (the passes' schedule)
enum Sched { PINGPONG = 0, SERIAL = 1 };
// the split: the whole pass, the product alone (ring and wgmma, the
// accumulator summed into the output), the epilogue alone (no product)
enum Cut { WHOLE = 0, PRODUCT = 1, EPILOGUE = 2 };
// K4's schedule and the cut of the calls the timing copies change
// (SVT_I8_90_PINGPONG, SVT_I8_90_CUT); SERIAL and WHOLE in the library
constexpr int SCHED_K4 = SVT_I8_90_PINGPONG ? PINGPONG : SERIAL;
constexpr int CUT_K = SVT_I8_90_CUT;
static_assert(CUT_K >= WHOLE && CUT_K <= EPILOGUE, "SVT_I8_90_CUT: 0, 1, 2");

// ---- the ring of slabs of one CTA: the slabs of `w` (a stream of
// `per_tile` slabs of SLABB bytes) once for every tile it runs, each slab
// multicast to the cluster's four rings in quarters, one per CTA.  Every
// warp of every CTA releases each slab it has read; thread 0 refills a stage
// once its slab is released cluster-wide, right after its own warp released
// it, so S - 1 slabs are in flight.
template <int S, int SLABB>
struct Ring {
  int8_t (*buf)[SLABB];
  uint64_t* full;
  uint64_t* empty;
  const int8_t* w;
  int per_tile, total;
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
    constexpr int Q = SLABB / CS;
    const int st = seq % S;
    if (seq >= S) mbar_wait(&empty[st], uint32_t(seq / S - 1) & 1u);
    mbar_expect_tx(&full[st], SLABB);
    const int from = SVT_I8_90_WRONG_QUARTER && rank == 1 ? seq + 1 : seq;
    const int8_t* src = w + size_t(from % per_tile) * SLABB + rank * Q;
    bulk_multicast(buf[st] + rank * Q, src, Q, &full[st],
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
  // thread 0, after its warp released slab `seq`: refill its stage
  __device__ void refill(int seq) const {
    if (threadIdx.x == 0 && seq + S < total) fetch(seq + S);
  }
};

// Byte offset of (pixel p, column k) in a (64, 512) tile: eight swizzled
// column blocks of 64 K-bytes, 4 KiB each.
__device__ __forceinline__ int tile_off(int p, int k) {
  return (k >> 6) * (PT * SB) + offset_sw64(p, k & 63);
}

// ---- the a0 chain: q = clip(round(127 tanh(h0)), -127, 127), as
// first_layer_q<127> computes it
__device__ __forceinline__ float q127(float h0) {
  return fminf(fmaxf(qround(__fmul_rn(tanhf(h0), 127.f)), -127.f), 127.f);
}

// Piece `it` (0 or 1) of columns 64 s .. +63 of the a0q tile of pixels p0 ..
// p0+63 of image b: thread i takes column 64 s + i % 64 (its fold values
// loaded once) of pixels i / 64 + 8 (4 it + r), r < 4; a warp's 32 lanes
// share a pixel (coords read once for the warp) and store 32 consecutive
// bytes of its row.  Columns past H are 0.
__device__ __forceinline__ void chain_piece(const float* __restrict__ fold,
                                            const float* __restrict__ coords,
                                            int b, int p0, int H, int s,
                                            int it, int8_t* tile) {
  const int k = s * SB + (threadIdx.x & 63);
  const int pg = threadIdx.x >> 6;
  const float* f = fold + size_t(b) * 4 * H;
  const bool on = k < H;
  const float w0 = on ? f[k] : 0.f, w1 = on ? f[H + k] : 0.f;
  const float c = on ? f[2 * H + k] : 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = pg + 8 * (4 * it + r);
    const float x0 = coords[2 * (p0 + p)], x1 = coords[2 * (p0 + p) + 1];
    const int q = on ? int(q127(first_h0(x0, x1, w0, w1, c))) : 0;
    tile[tile_off(p, k)] = int8_t(q);
  }
}

// x rounded to TF32 (cvt.rna.tf32.f32: 10 mantissa bits, ties away).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// ---- the forward kernel (K4, and K5's scale pass with recompute)

struct Fwd90Args {
  const float* fold;         // (B, 4, H) from the chunk's first image
  const float* coords;       // (HW, 2)
  const int8_t* wslabs;      // W1q^T's half-slab stream
  const float* sw;           // (1,)
  const float* b1;           // (H,)
  const float* wht;          // (No, H)
  const float* bht;          // (No,)
  float* y;                  // (B, No, HW): out, or in (MODE_SCALE)
  const float* gy;           // (B, No, HW) (MODE_SCALE)
  __nv_bfloat16* a1;         // (B, HW, H) (MODE_EMIT)
  float* stash;              // (tiles, 64, 512) f32 a1 (MODE_SCALE)
  float* part_max;           // (B * blocks,), globally indexed (MODE_SCALE)
  int b0, HW, H, No, blocks;
};

// The head's B operand: wht^T as 8 rows (outputs, zero past No) by 512
// columns (zero past H), K-major in 64-byte swizzle atoms of 8 rows and 16
// columns, each 8-column group in the order 0, 2, 4, 6, 1, 3, 5, 7 that the
// registers of the tf32 A fragment take from the accumulator; TF32 hi and
// lo planes of f32 weights, the bf16 weights' values (exact) alone.
constexpr int HEAD_PLANE = MAX_NO * KW * 4;

template <int MODE>
struct FwdSmem {
  static constexpr int STAGES = MODE == MODE_EMIT ? 3 : 6;
  static constexpr int STAGE_WORDS = MODE == MODE_EMIT    ? PT * KW / 2
                                     : MODE == MODE_SCALE ? 2 * MAX_NO * PT
                                                          : 4;
  static constexpr int HEAD_BYTES = MODE == MODE_SCALE ? 16 : 2 * HEAD_PLANE;
  int8_t ring[STAGES][HSLAB];
  int8_t aq[2][TILE_B];
  int8_t hb[HEAD_BYTES];             // 512-byte aligned: after the tiles
  // MODE_EMIT: the block's a1, packed (64, H) bf16 rows; MODE_SCALE: the
  // cast dz2 of the two tiles in flight
  uint32_t stage[STAGE_WORDS];
  float red[WG][MAX_NO][PT];         // the head's partials per warpgroup
  float scratch[WARPS];
  uint64_t full[STAGES], empty[STAGES];
};
static_assert(sizeof(FwdSmem<MODE_Y>) <= 232448, "opt-in shared memory");
static_assert(sizeof(FwdSmem<MODE_EMIT>) <= 232448, "opt-in shared memory");
static_assert(sizeof(FwdSmem<MODE_SCALE>) <= 232448, "opt-in shared memory");

// Thread tid's part of the head's B operand (MODE_Y/EMIT); the caller
// fences and syncs before the products read it.
template <bool BF16, int MODE>
__device__ __forceinline__ void head_operand(const Fwd90Args& a,
                                             FwdSmem<MODE>& sm) {
  for (int i = threadIdx.x; i < MAX_NO * KW; i += NT) {
    const int o = i / KW, n = i % KW;
    const float w = o < a.No && n < a.H ? a.wht[size_t(o) * a.H + n] : 0.f;
    const int r = n & 7;
    const int nk = (n & ~7) + ((r & 1) ? 4 + (r >> 1) : (r >> 1));
    const int off = (nk >> 4) * 512 + offset_sw64(o, (nk & 15) * 4);
    const uint32_t hi = BF16 ? __float_as_uint(w) : tf32_rna(w);
    *reinterpret_cast<uint32_t*>(sm.hb + off) = hi;
    if (!BF16)
      *reinterpret_cast<uint32_t*>(sm.hb + HEAD_PLANE + off) =
          tf32_rna(w - __uint_as_float(hi));
  }
}

// One half's product over the ring: acc = tile (64, Kp) . slabs^T of the
// half (64 rows of each warpgroup); side(j), j = 0..7, runs while the
// tensor cores work on slab j.  A side that issues no product (SIDE_MMA
// false: the chain alone) leaves the loop K3's (ring_product): slab j - 1
// is released once slab j's products are issued and j - 1's complete, with
// thread 0's refill after the release; ptxas keeps that loop's wgmma
// asynchronous.  A side that issues the head's products (the ping-pong
// schedule) commits them as the group after slab j's, and slab j is
// released once all groups but that one are complete; ptxas serializes
// that loop's wgmma (C7520, the refill's wait in a divergent path).
template <int CUT, bool SIDE_MMA, typename R, typename Side>
__device__ __forceinline__ void half_product(int (&acc)[32],
                                             const int8_t* tile,
                                             const R& ring, int seq0,
                                             int nslab, int wg, Side side) {
#pragma unroll
  for (int j = 0; j < NSTEP; ++j) {
    const bool mma = CUT != EPILOGUE && j < nslab;
    if (mma) {
      const int8_t* slab = ring.wait(seq0 + j);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SB; kk += 32)
        wgmma_s8_n64(acc, gmma_desc_sw64(tile + j * (PT * SB) + kk),
                     gmma_desc_sw64(slab + wg * (64 * SB) + kk),
                     j == 0 && kk == 0 ? 0 : 1);
      wgmma_commit();
    }
    side(j);
    if constexpr (SIDE_MMA) {
      wgmma_commit();
      if (mma) {
        wgmma_wait<1>();
        ring.release(seq0 + j);
        ring.refill(seq0 + j);
      }
    } else if (mma) {
      wgmma_wait<1>();
      if (j > 0) {
        ring.release(seq0 + j - 1);
        ring.refill(seq0 + j - 1);
      }
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (!SIDE_MMA && CUT != EPILOGUE) {
    ring.release(seq0 + nslab - 1);
    ring.refill(seq0 + nslab - 1);
  }
}

// The state of a tile's epilogue that lives across its parts: the head's
// accumulator, d[2h + e] = z[16 w + g + 8 h][2 t + e] over the warpgroup's
// columns so far (MODE_Y/EMIT), or the max |dh1| (MODE_SCALE).
struct Epi {
  float d[4];
  float mx;
  __device__ __forceinline__ void reset() {
    d[0] = d[1] = d[2] = d[3] = 0.f;
    mx = 0.f;
  }
};

// Part j (nt = j) of the epilogue of half hf of tile (b, p0, tb): four
// accumulator elements, rows 16w + g + 8h, columns 128 wg + 64 hf + 8 j +
// 2 t + e.  h1 = acc * (sw/127) + b1, a1 = tanhf(h1); MODE_Y/EMIT: cast(a1)
// . wht^T on the tensor cores (its registers are the A operand of TF32
// products, one k8 step a part: one product with bf16 weights, three with
// f32; the caller commits them), and (MODE_EMIT) bf16(a1) to the stage; MODE_SCALE: a1 to the stash, dh1
// = (dzc^T . wht) * (1 - a1^2), its max.
template <bool BF16, int MODE, int CUT>
__device__ __forceinline__ void epi_part(const int (&acc)[32], int j, int hf,
                                         const Fwd90Args& a,
                                         FwdSmem<MODE>& sm, int tb, int par,
                                         float scale, Epi& ep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, No = a.No;
  if constexpr (CUT == PRODUCT) {      // read the accumulator, nothing more
#pragma unroll
    for (int i = 0; i < 4; ++i) ep.d[i] += float(acc[4 * j + i]);
    return;
  }
  const int n0 = 128 * wg + 64 * hf + 8 * j + 2 * t;
  float v[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + e;
      const float x = __fadd_rn(__fmul_rn(float(acc[4 * j + 2 * h + e]),
                                          scale),
                                n < H ? a.b1[n] : 0.f);
      v[h][e] = n < H ? tanhf(x) : 0.f;
    }
  if constexpr (MODE == MODE_SCALE) {
    const float* dzc = reinterpret_cast<const float*>(sm.stage) +
                       par * MAX_NO * PT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * w + g + 8 * h;
      *reinterpret_cast<float2*>(a.stash + (size_t(tb) * PT + p) * KW + n0) =
          make_float2(v[h][0], v[h][1]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + e;
        if (n >= H) continue;
        float da1 = 0.f;
        for (int o = 0; o < No; ++o)
          da1 = fmaf(dzc[o * PT + p], __ldg(a.wht + size_t(o) * H + n), da1);
        const float dh1 =
            __fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(v[h][e], v[h][e])));
        ep.mx = fmaxf(ep.mx, fabsf(dh1));
      }
    }
  } else {
    if constexpr (MODE == MODE_EMIT) {
      uint16_t* st = reinterpret_cast<uint16_t*>(sm.stage);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16 c[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          c[e] = SVT_I8_90_A1_RTZ ? __float2bfloat16_rz(v[h][e])
                                  : __float2bfloat16_rn(v[h][e]);
        const int at = (16 * w + g + 8 * h) * H + n0;
        if ((H & 1) == 0 && n0 + 1 < H) {
          *reinterpret_cast<uint32_t*>(st + at) =
              uint32_t(__bfloat16_as_ushort(c[0])) |
              uint32_t(__bfloat16_as_ushort(c[1])) << 16;
        } else {
          if (n0 < H) st[at] = __bfloat16_as_ushort(c[0]);
          if (n0 + 1 < H) st[at + 1] = __bfloat16_as_ushort(c[1]);
        }
      }
    }
    // the head on TF32 products, one k8 step a part; a bf16 value is exact
    // in TF32, so bf16 weights take one product of cast(a1), f32 weights
    // three (lo.hi + hi.lo + hi.hi)
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {      // a[i]: row h = i & 1, column e
      const float x = v[i & 1][i >> 1];
      hi[i] = BF16 ? __float_as_uint(rb(x)) : tf32_rna(x);
      lo[i] = BF16 ? 0u : tf32_rna(x - __uint_as_float(hi[i]));
    }
    const int m = 16 * wg + 8 * hf + j;                // the k8 step
    const int8_t* b = sm.hb + (m >> 1) * 512 + (m & 1) * 32;
    const int first = hf == 0 && j == 0 ? 0 : 1;
    fence_operands(ep.d);
    wgmma_fence();
    if constexpr (BF16) {
      wgmma_tf32_n8_ra(ep.d, hi, gmma_desc_sw64(b), first);
    } else {
      wgmma_tf32_n8_ra(ep.d, lo, gmma_desc_sw64(b), first);
      wgmma_tf32_n8_ra(ep.d, hi, gmma_desc_sw64(b + HEAD_PLANE), 1);
      wgmma_tf32_n8_ra(ep.d, hi, gmma_desc_sw64(b), 1);
    }
  }
}

// A tile's last step, once both halves' parts are done: y from the head's
// partials (the 4 warpgroups in order) and the emitted a1 to global memory
// in bulk copies (MODE_Y/EMIT); the block's max |dh1| (MODE_SCALE).  Starts
// and ends with a barrier; the stage is free after.
template <int MODE>
__device__ __forceinline__ void finish_tile(const Fwd90Args& a,
                                            FwdSmem<MODE>& sm, int tb,
                                            Epi& ep) {
  const int tid = threadIdx.x;
  const int bl = tb / a.blocks, blk = tb % a.blocks;
  const int b = a.b0 + bl, p0 = blk * PT;
  if constexpr (MODE == MODE_SCALE) {
    const float m = block_max(ep.mx, sm.scratch);
    if (tid == 0) a.part_max[size_t(b) * a.blocks + blk] = m;
    ep.mx = 0.f;
    __syncthreads();
  } else {
    const int lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    wgmma_wait<0>();
    fence_operands(ep.d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = 2 * t + (i & 1);
      if (o < a.No) sm.red[wg][o][16 * w + g + 8 * (i >> 1)] = ep.d[i];
      ep.d[i] = 0.f;
    }
    if (MODE == MODE_EMIT) fence_proxy_async();
    __syncthreads();
    if (tid < a.No * PT) {
      const int o = tid / PT, p = tid % PT;
      float z = sm.red[0][o][p];
#pragma unroll
      for (int q = 1; q < WG; ++q) z += sm.red[q][o][p];
      a.y[(size_t(b) * a.No + o) * a.HW + p0 + p] =
          1.f / (1.f + expf(-__fadd_rn(z, a.bht[o])));
    }
    if (MODE == MODE_EMIT && tid == 0) {
      // the block's rows are one contiguous run of 64 H bf16 in global
      // memory (HW is a multiple of 256): four bulk copies of 16 rows
      const uint32_t part = uint32_t(16 * a.H * 2);
      const char* src = reinterpret_cast<const char*>(sm.stage);
      char* dst = reinterpret_cast<char*>(
          a.a1 + (size_t(b) * a.HW + p0) * a.H);
      const uint64_t pol = l2_evict_first();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bulk_store(dst + i * part, src + i * part, part, pol);
      bulk_commit();
      bulk_wait_read<0>();
    }
    __syncthreads();
  }
}

// cast dz2 = g*y*(1-y) of tile (b, p0) into the stage's buffer `par`
// (MODE_SCALE); the caller syncs before it is read.
template <bool BF16>
__device__ __forceinline__ void stage_dzc(const Fwd90Args& a,
                                          FwdSmem<MODE_SCALE>& sm, int tb,
                                          int par) {
  const int tid = threadIdx.x;
  if (tid < a.No * PT) {
    const int b = a.b0 + tb / a.blocks, p0 = (tb % a.blocks) * PT;
    const int o = tid / PT;
    const size_t at = (size_t(b) * a.No + o) * a.HW + p0 + tid % PT;
    const float s = a.y[at];
    const float d = __fmul_rn(__fmul_rn(a.gy[at], s), __fsub_rn(1.f, s));
    reinterpret_cast<float*>(sm.stage)[par * MAX_NO * PT + tid] =
        operand<BF16>(d);
  }
}

// The forward on clusters.  The four CTAs of a cluster walk the quads (4
// consecutive 64-pixel blocks of the chunk's flattened (image, block) grid)
// cid, cid + clusters, ...; CTA `rank` runs block 4 quad + rank.  SERIAL,
// per tile: each half's product (beside it half of tile k+1's a0q pieces)
// and then its epilogue, one accumulator live; PINGPONG, per tile k: half
// A's product (side: the epilogue of tile k-1's half B and the first pieces
// of tile k+1's a0q), tile k-1's finish, half B's product (side: the
// epilogue of tile k's half A and the other pieces); the last tile's half B
// after the loop.
template <bool BF16, int MODE, int SCHED, int CUT>
__global__ void __launch_bounds__(NT, 1)
int8_fwd90_kernel(const Fwd90Args a, int nquads) {
  using Smem = FwdSmem<MODE>;
  extern __shared__ __align__(128) uint8_t smem90[];
  Smem& sm = *reinterpret_cast<Smem*>(smem90);
  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
  const int H = a.H, blocks = a.blocks;
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const int nslab = padded_k(H) / SB;
  const Ring<Smem::STAGES, HSLAB> ring{sm.ring, sm.full, sm.empty,
                                       a.wslabs, 2 * nslab, ntl * 2 * nslab,
                                       cluster_rank()};
  if (tid == 0) ring.init();
  if constexpr (MODE != MODE_SCALE) head_operand<BF16>(a, sm);
  cluster_sync();
  if (CUT != EPILOGUE) ring.start();
  auto block_of = [&](int k) { return (cid + k * ncl) * CS + int(ring.rank); };
  auto img = [&](int tb) { return a.b0 + tb / blocks; };
  auto pix0 = [&](int tb) { return (tb % blocks) * PT; };
  const float scale = __fmul_rn(*a.sw, 1.f / 127.f);
  constexpr bool CHAINS = CUT != PRODUCT;

  if (ntl > 0 && CHAINS) {
    const int tb = block_of(0);
    for (int s = 0; s < nslab; ++s)
      for (int it = 0; it < 2; ++it)
        chain_piece(a.fold, a.coords, img(tb), pix0(tb), H, s, it,
                    sm.aq[0]);
  }
  fence_proxy_async();
  __syncthreads();
  Epi ep;
  ep.reset();
  int accA[32], accB[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) accA[j] = accB[j] = 0;
  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), par = k & 1;
    const bool more = k + 1 < ntl;
    const int nb = more ? block_of(k + 1) : 0;
    const int8_t* tile = sm.aq[k & 1];
    int8_t* next = sm.aq[(k + 1) & 1];
    const int seq0 = k * 2 * nslab;
    const int pb = k > 0 ? block_of(k - 1) : 0;
    if constexpr (MODE == MODE_SCALE) {
      stage_dzc<BF16>(a, sm, tb, par);
      __syncthreads();
    }
    if constexpr (SCHED == SERIAL) {
      // each half's epilogue after its product: one accumulator live
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        half_product<CUT, false>(accA, tile, ring, seq0 + hf * nslab, nslab,
                                 wg, [&](int j) {
          if (CHAINS && more && j < nslab)
            chain_piece(a.fold, a.coords, img(nb), pix0(nb), H, j, hf,
                        next);
        });
        // each part's head products complete before the next part defines
        // their registers again: no non-wgmma definition of a wgmma's
        // input inside a pipeline stage, which ptxas would serialize
#pragma unroll
        for (int j = 0; j < NSTEP; ++j) {
          epi_part<BF16, MODE, CUT>(accA, j, hf, a, sm, tb, par, scale, ep);
          wgmma_commit();
          wgmma_wait<0>();
        }
      }
      finish_tile<MODE>(a, sm, tb, ep);
    } else {
      // half A; beside it the epilogue of tile k-1's half B
      half_product<CUT, true>(accA, tile, ring, seq0, nslab, wg, [&](int j) {
        if (k > 0)
          epi_part<BF16, MODE, CUT>(accB, j, 1, a, sm, pb, par ^ 1, scale,
                                    ep);
        if (CHAINS && more && j < nslab)
          chain_piece(a.fold, a.coords, img(nb), pix0(nb), H, j, 0, next);
      });
      if (k > 0) finish_tile<MODE>(a, sm, pb, ep);
      // half B; beside it the epilogue of this tile's half A
      half_product<CUT, true>(accB, tile, ring, seq0 + nslab, nslab, wg,
                              [&](int j) {
        epi_part<BF16, MODE, CUT>(accA, j, 0, a, sm, tb, par, scale, ep);
        if (CHAINS && more && j < nslab)
          chain_piece(a.fold, a.coords, img(nb), pix0(nb), H, j, 1, next);
      });
    }
    fence_proxy_async();
    __syncthreads();                   // the next tile's a0q is complete
  }
  if (SCHED == PINGPONG && ntl > 0) {
    const int tb = block_of(ntl - 1);
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) {
      epi_part<BF16, MODE, CUT>(accB, j, 1, a, sm, tb, (ntl - 1) & 1, scale,
                                ep);
      wgmma_commit();
    }
    finish_tile<MODE>(a, sm, tb, ep);
  }
  if (MODE == MODE_EMIT && tid == 0) bulk_wait<0>();
  cluster_sync();
}

// ---- K5's scale pass from the bf16 residual: one CTA per 64-pixel block,
// its a1 rows (one contiguous run of 64 H bf16) brought into shared memory
// by one bulk copy, column n read by thread n; the block's max |dh1|.
constexpr int SCALE_NT = 512;

template <bool BF16>
__global__ void __launch_bounds__(SCALE_NT)
int8_scale90_kernel(const __nv_bfloat16* __restrict__ a1,
                    const float* __restrict__ y, const float* __restrict__ gy,
                    const float* __restrict__ wht,
                    float* __restrict__ part_max, int HW, int H, int No,
                    int blocks) {
  extern __shared__ __align__(128) uint8_t smem_s[];
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem_s);
  float* dzc = reinterpret_cast<float*>(smem_s + PT * KW * 2);
  float* scratch = dzc + MAX_NO * PT;
  uint64_t* bar = reinterpret_cast<uint64_t*>(scratch + WARPS);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / blocks, p0 = (blockIdx.x % blocks) * PT;
  const uint32_t bytes = uint32_t(PT * H * 2);
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, bytes);
    bulk_load(rows, a1 + (size_t(b) * HW + p0) * H, bytes, bar,
              l2_evict_first());
  }
  if (tid < No * PT) {
    const size_t at = (size_t(b) * No + tid / PT) * HW + p0 + tid % PT;
    const float s = y[at];
    dzc[tid] = operand<BF16>(
        __fmul_rn(__fmul_rn(gy[at], s), __fsub_rn(1.f, s)));
  }
  const int n = tid;
  float wv[MAX_NO];
#pragma unroll
  for (int o = 0; o < MAX_NO; ++o)
    wv[o] = n < H && o < No ? wht[size_t(o) * H + n] : 0.f;
  __syncthreads();                     // dzc, and the barrier's init
  mbar_wait(bar, 0);
  float mx = 0.f;
  if (n < H) {
#pragma unroll 4
    for (int p = 0; p < PT; ++p) {
      const float v = __bfloat162float(rows[p * H + n]);
      float da1 = 0.f;
#pragma unroll
      for (int o = 0; o < MAX_NO; ++o)
        if (o < No) da1 = fmaf(dzc[o * PT + p], wv[o], da1);
      mx = fmaxf(mx, fabsf(__fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(v, v)))));
    }
  }
  const float m = block_max(mx, scratch);
  if (tid == 0) part_max[blockIdx.x] = m;
}

constexpr int SCALE_SMEM = PT * KW * 2 + MAX_NO * PT * 4 + WARPS * 4 + 16;

// ---- K5's gradient pass on clusters

struct Grad90Args {
  const float* fold;         // (B, 4, H), globally indexed
  const float* coords;       // (HW, 2)
  const int8_t* wslabs;      // W1q's slab stream (rows i, K = n)
  const float* sw;           // (1,)
  const float* wht;          // (No, H)
  const __nv_bfloat16* a1;   // (B, HW, H) bf16 residual, or null
  const float* stash;        // (chunk tiles, 64, 512) f32 a1, or null
  const float* y;            // (B, No, HW)
  const float* gy;           // (B, No, HW)
  const float* part_max;     // (B * blocks,)
  float* gscale;             // (B * HW / Pt,)
  int8_t* aq_ws;             // (chunk tiles, 512, 64) K3's dW1 layout
  int8_t* q_ws;
  float* part_fold;          // (B * blocks, 3, H)
  float* part_w;             // (B * blocks, H + No H + No)
  int b0, HW, H, No, Pt, blocks;
};

struct GradSmem {
  int8_t ring[GRAD_STAGES][SLAB];
  int8_t q[TILE_B];
  float red[SLOTS][4][KW];
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  float scratch[WARPS];
  uint64_t full[GRAD_STAGES], empty[GRAD_STAGES];
};
static_assert(sizeof(GradSmem) <= 232448, "opt-in shared memory on sm_90");

// The warpgroup's products of one slab: acc (+)= tile[:, 64 s .. +63] .
// slab[128 wg .. +127, :]^T, committed as one group.
__device__ __forceinline__ void mma_slab(int (&acc)[64], const int8_t* tile,
                                         int s, const int8_t* slab, int wg,
                                         bool first) {
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SB; kk += 32)
    wgmma_s8_n128(acc, gmma_desc_sw64(tile + s * (PT * SB) + kk),
                  gmma_desc_sw64(slab + 128 * wg * SB + kk),
                  first && kk == 0 ? 0 : 1);
  wgmma_commit();
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

// Per tile: dz2 and the group's scale; thread n quantises column n of dh1
// over the block's 64 pixels (a1 from the residual or the stash) into the
// dh1q tile and its workspace row, and writes the column's db1 and dWh^T
// partials; da0 = dh1q . W1q^T on the ring; a0 = tanhf(h0) exact in the
// epilogue gives dh0 and a0q (to its workspace); the dfold partials.  The
// tiles of the chunk as in the forward.
template <bool BF16, bool RESID, int CUT>
__global__ void __launch_bounds__(NT, 1)
int8_grad90_kernel(const Grad90Args a, int nquads) {
  extern __shared__ __align__(128) uint8_t smem90[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int Mw = H + No * H + No;
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const int nslab = padded_k(H) / SB;
  const Ring<GRAD_STAGES, SLAB> ring{sm.ring, sm.full, sm.empty, a.wslabs,
                                     nslab, ntl * nslab, cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  if (CUT != EPILOGUE) ring.start();
  const int n = tid;                   // the dh1 phase's column
  float wv[MAX_NO];
#pragma unroll
  for (int o = 0; o < MAX_NO; ++o)
    wv[o] = n < H && o < No ? a.wht[size_t(o) * H + n] : 0.f;

  for (int k = 0; k < ntl; ++k) {
    const int tb = (cid + k * ncl) * CS + int(ring.rank);
    const int bl = tb / blocks, blk = tb % blocks;
    const int b = a.b0 + bl, p0 = blk * PT;
    const size_t gblk = size_t(b) * blocks + blk;
    float* pw = a.part_w + gblk * Mw;
    if (tid < No * PT) {
      const size_t at = (size_t(b) * No + tid / PT) * HW + p0 + tid % PT;
      const float s = a.y[at];
      const float d = __fmul_rn(__fmul_rn(a.gy[at], s), __fsub_rn(1.f, s));
      sm.dz[tid] = d;
      sm.dzc[tid] = operand<BF16>(d);
    }
    const float sg = __fadd_rn(
        __fmul_rn(group_max(a.part_max, b, p0, blocks, a.Pt), 1.f / 127.f),
        1e-30f);
    if (tid == 0 && p0 % a.Pt == 0)
      a.gscale[size_t(b) * (HW / a.Pt) + p0 / a.Pt] =
          __fmul_rn(sg, 1.f / 127.f);
    __syncthreads();

    // the dh1 phase: column n of the block
    if constexpr (CUT != PRODUCT) {
      float db = 0.f, dw[MAX_NO];
#pragma unroll
      for (int o = 0; o < MAX_NO; ++o) dw[o] = 0.f;
      const bool on = n < H;
      int8_t* qrow = a.q_ws + size_t(tb) * WS_BLOCK;
#pragma unroll 1
      for (int c = 0; c < PT / 16; ++c) {
        uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int p = 16 * c + i;
          float v = 0.f;
          if (on)
            v = RESID ? __bfloat162float(
                            a.a1[(size_t(b) * HW + p0 + p) * H + n])
                      : a.stash[(size_t(tb) * PT + p) * KW + n];
          float q = 0.f;
          if (on) {
            float da1 = 0.f;
#pragma unroll
            for (int o = 0; o < MAX_NO; ++o)
              if (o < No) da1 = fmaf(sm.dzc[o * PT + p], wv[o], da1);
            const float dh1 =
                __fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(v, v)));
            db += dh1;
            q = fminf(fmaxf(qround(__fdiv_rn(dh1, sg)), -127.f), 127.f);
            const float vc = operand<BF16>(v);
#pragma unroll
            for (int o = 0; o < MAX_NO; ++o)
              if (o < No) dw[o] = fmaf(sm.dzc[o * PT + p], vc, dw[o]);
          }
          const uint32_t qb = uint32_t(uint8_t(int8_t(q)));
          sm.q[tile_off(p, n)] = int8_t(q);
          // pixel p = 16 c + g' + 8 h' at byte 2 g' + h' of chunk c
          const int bi = 2 * (i & 7) + (i >> 3);
          pk[bi >> 2] |= qb << (8 * (bi & 3));
        }
        *reinterpret_cast<uint4*>(qrow + offset_sw64(n, 16 * c)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
      if (on) {
        pw[n] = db;
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o)
          if (o < No) pw[H + o * H + n] = dw[o];
      }
      if (tid < No) {                  // dbh partials
        float s = 0.f;
        for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
        pw[H + No * H + tid] = s;
      }
      fence_proxy_async();
    }
    __syncthreads();                   // the dh1q tile is complete

    // da0 = dh1q . W1q^T
    int acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    if constexpr (CUT != EPILOGUE) {
      const int seq0 = k * nslab;
      for (int s = 0; s < nslab; ++s) {
        const int seq = seq0 + s;
        mma_slab(acc, sm.q, s, ring.wait(seq), wg, s == 0);
        wgmma_wait<1>();
        if (s > 0) {
          ring.release(seq - 1);
          ring.refill(seq - 1);
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      ring.release(seq0 + nslab - 1);
      ring.refill(seq0 + nslab - 1);
    }
    // dh0 = (acc * sg*sw) * (1 - a0^2) with the exact a0; a0q to its
    // workspace; the dfold partials
    int8_t* aq_ws = a.aq_ws + size_t(tb) * WS_BLOCK;
    const float dsc = __fmul_rn(sg, *a.sw);
    const int px0 = 16 * w + g, px1 = px0 + 8;
    const float x00 = a.coords[2 * (p0 + px0)];
    const float x01 = a.coords[2 * (p0 + px0) + 1];
    const float x10 = a.coords[2 * (p0 + px1)];
    const float x11 = a.coords[2 * (p0 + px1) + 1];
    const float* f = a.fold + size_t(b) * 4 * H;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      float s0[8], s1[8], s2[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nt = 4 * ch + u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = acc_col(wg, t, 4 * nt + e);
          const bool on = i < H;
          const float w0 = on ? f[i] : 0.f, w1 = on ? f[H + i] : 0.f;
          const float cb = on ? f[2 * H + i] : 0.f;
          uint16_t qq = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x0 = h ? x10 : x00, x1 = h ? x11 : x01;
            float dh0 = 0.f;
            if constexpr (CUT == PRODUCT) {
              dh0 = float(acc[4 * nt + 2 * h + e]);
            } else if (on) {
              const float a0 = tanhf(first_h0(x0, x1, w0, w1, cb));
              const float aqv =
                  fminf(fmaxf(qround(__fmul_rn(a0, 127.f)), -127.f), 127.f);
              qq |= uint16_t(uint8_t(int8_t(aqv))) << (8 * h);
              const float da0 =
                  __fmul_rn(float(acc[4 * nt + 2 * h + e]), dsc);
              dh0 = __fmul_rn(da0, __fsub_rn(1.f, __fmul_rn(a0, a0)));
            }
            const int iv = 2 * u + e;
            if (h == 0) {
              s0[iv] = __fmul_rn(x0, dh0);
              s1[iv] = __fmul_rn(x1, dh0);
              s2[iv] = dh0;
            } else {
              s0[iv] = fmaf(x0, dh0, s0[iv]);
              s1[iv] = fmaf(x1, dh0, s1[iv]);
              s2[iv] += dh0;
            }
          }
          if (CUT != PRODUCT)
            *reinterpret_cast<uint16_t*>(aq_ws +
                                         offset_sw64(i, 16 * w + 2 * g)) = qq;
        }
      }
      const int col = chunk_col(wg, t, g, ch);
      sm.red[0][w][col] = reduce_scatter8(s0);
      sm.red[1][w][col] = reduce_scatter8(s1);
      sm.red[2][w][col] = reduce_scatter8(s2);
    }
    __syncthreads();
    if (tid < H) {
      float* pf = a.part_fold + gblk * 3 * H;
      pf[tid] = column_sum(sm, 0);
      pf[H + tid] = column_sum(sm, 1);
      pf[2 * H + tid] = column_sum(sm, 2);
    }
    __syncthreads();
  }
  cluster_sync();
}

// ---- the launches

template <typename K>
int cached_clusters(K k, int threads, int smem, int* cache) {
  if (*cache <= 0) *cache = max_clusters(k, threads, smem, CS);
  return *cache;
}

template <bool BF16, int MODE, int SCHED, int CUT>
cudaError_t launch_fwd90(const Fwd90Args& a, int tiles, cudaStream_t st) {
  static int cache = 0;
  auto k = int8_fwd90_kernel<BF16, MODE, SCHED, CUT>;
  constexpr int smem = sizeof(FwdSmem<MODE>);
  const int nquads = tiles / CS;
  const int ncl = min(nquads, cached_clusters(k, NT, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT, smem, CS, st, a, nquads);
}

template <bool BF16, bool RESID, int CUT>
cudaError_t launch_grad90(const Grad90Args& a, int tiles, cudaStream_t st) {
  static int cache = 0;
  auto k = int8_grad90_kernel<BF16, RESID, CUT>;
  const int nquads = tiles / CS;
  const int ncl = min(nquads, cached_clusters(k, NT, sizeof(GradSmem),
                                              &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT, sizeof(GradSmem), CS, st,
                         a, nquads);
}

// The shapes the cluster passes take (int8_route's table): H <= 512, HW a
// multiple of 256 (so a quad lies in one image), groups of Pt pixels, a
// multiple of 256 dividing HW (so a quad lies in one group).
bool bad90(int B, int HW, int H, int No) {
  return B < 1 || H < 1 || H > KW || HW < CS * PT || HW % (CS * PT) ||
         No < 1 || No > MAX_NO || double(B) * (HW / PT) > 2147483647.0;
}

}  // namespace
