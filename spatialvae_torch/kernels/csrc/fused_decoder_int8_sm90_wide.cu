// K4 and K5 on thread block clusters past H = 512: the pieces of
// fused_decoder_int8_sm90.cuh (the W1q slab ring multicast over clusters of
// four 64-pixel blocks of one quantisation group, int8 wgmma from shared
// memory, exact tanhf) run in output-column chunks of KW = 512, in a
// translation unit of their own, so that the H <= 512 unit keeps its code.
// Replaces, with those passes, the Pallas TPU kernels
// spatialvae_tpu/kernels/fused_decoder_int8.py `_fwd_kernel` (:60) and
// `_bwd_kernel` (:95) at these widths; the formulas are
// fused_decoder_int8.cu's (per-tensor W1q and sw, a0q = round(127 tanh(h0))
// with exact tanhf, K5's scale over a whole pick_tile(HW) group, dh0 from
// the f32 a0), each epilogue in the block passes' op order, the head's row
// sums carried across chunks in chunk order as the block passes' WIDE
// instantiations carry them.
//
// What changes past 512 (Kp = H padded to 64, nch = Kp / 512 rounded up,
// R = 512 nch the rows of every operand, stash and dW1 workspace block):
//   - W1q^T (K4, the recompute scale pass) and W1q (K5's da0) are laid out
//     chunk by chunk (fused_loss_int8.sm90_slabs): chunk c is rows 512 c ..
//     +511 over the whole K = Kp, in Kp / 64 slabs of 512 rows x 64 K-bytes,
//     so the ring, its quarters and the multicast are the H <= 512 ring's,
//     streaming nch * Kp / 64 slabs a tile; every product is m64n128k32 a
//     warpgroup;
//   - the (64, Kp) A operands are not held whole: each product reads a ring
//     of PIECES pieces, the operand's 64 K-bytes of its slab (4 KiB), made
//     while the tensor cores run the slab before it;
//   - a0q is built once per tile, not once per chunk (exact tanhf is most of
//     K4's epilogue): the first chunk builds each piece from the fold and
//     keeps a copy in the CTA's slot of a global workspace (64 x Kp bytes a
//     resident CTA, in the pieces' layout), the later chunks read the piece
//     back from there.  The slot, not shared memory, holds it because the
//     whole (64, Kp) tile fits beside the ring only up to Kp = 1,024 and the
//     passes take every width;
//   - da0 = dh1q . W1q^T needs dh1q over the whole K before its first output
//     chunk, and int8 wgmma takes K-major operands only, so the gradient
//     pass writes each chunk's dh1q tile also to a K-major copy in the CTA's
//     slot and reads it back a piece a slab;
//   - the head's No <= 8 partials per pixel are carried across chunks in
//     shared memory, one thread per slot, added in chunk order; y after the
//     last chunk.  The head runs on the CUDA cores (FMA row sums), the
//     chunk's a1 (MODE_EMIT) packed in shared memory and written to its rows
//     with bulk copies (H a multiple of 8; else plain stores);
//   - the column sums (db1, dWh^T, dfold) are reduced chunk by chunk into
//     the per-block partials the fixed-order sums read;
//   - the recompute scale pass leaves a1 (f32) in a stash of R columns a
//     pixel; the scale pass from the residual reads a1 column by column;
//   - dW1 runs on K3's wide dW1 kernel (svt_loss90_dw) from the R-row
//     workspaces the gradient pass writes.
// No float atomics, sums in a fixed order: reruns are bit-identical.
//
// Test-build switches, the faulty copies of `chip_smoke.py --limits
// int8_90` (the library is built with all of them at 0):
//   SVT_I8W_DROP_HEAD=1  K4 drops the last chunk's head partial;
//   SVT_I8W_QK_OFF=1     K5's da0 reads the K-major dh1q copy one 64-column
//                        block off (piece s + 1 for piece s);
//   SVT_I8W_DH0_AQ=1     K5's dh0 takes a0q/127 in place of the f32 a0.

#include "fused_decoder_int8_sm90.cuh"

#ifndef SVT_I8W_DROP_HEAD
#define SVT_I8W_DROP_HEAD 0
#endif
#ifndef SVT_I8W_QK_OFF
#define SVT_I8W_QK_OFF 0
#endif
#ifndef SVT_I8W_DH0_AQ
#define SVT_I8W_DH0_AQ 0
#endif

namespace {

constexpr int PIECE = PT * SB;           // a slab's K-range of an A operand
constexpr int PIECES = 4;
constexpr int PIECES_PER_CHUNK = KW / SB;
constexpr int WSTAGES = 4;               // the wide passes' ring

__host__ __device__ constexpr int wchunks(int H) {
  return (padded_k(H) + KW - 1) / KW;
}
// rows of every operand, stash and workspace block: whole chunks
__host__ __device__ constexpr int wrows(int H) { return wchunks(H) * KW; }
// one resident CTA's slot: a (64, Kp) int8 operand in the pieces' layout
__host__ __device__ constexpr size_t slot_bytes(int H) {
  return size_t(PT) * padded_k(H);
}

using WRing = Ring<WSTAGES, SLAB>;

// acc = A . W_chunk^T over the `nks` slabs seq0 .. of the ring, A one piece
// a slab (piece seq % PIECES, the caller's before the first slab).
// side(seq) runs while the tensor cores work on slab seq and makes piece
// seq + 1; a CTA barrier closes each slab, so that piece is whole before
// any warpgroup reads it, and every warpgroup's products of slab seq - 1
// are done: a piece is rewritten PIECES - 1 slabs after its products
// started.  Slab seq - 1 is released once slab seq's products are issued,
// its stage refilled by thread 0 right after.
template <typename Side>
__device__ __forceinline__ void piece_product(int (&acc)[64],
                                              int8_t (*pieces)[PIECE],
                                              const WRing& ring, int seq0,
                                              int nks, int wg, Side side) {
  for (int s = 0; s < nks; ++s) {
    const int seq = seq0 + s;
    mma_slab(acc, pieces[seq % PIECES], 0, ring.wait(seq), wg, s == 0);
    side(seq);
    fence_proxy_async();
    wgmma_wait<1>();
    if (s > 0) ring.release(seq - 1);
    if (seq > 0) ring.refill(seq - 1);
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  ring.release(seq0 + nks - 1);
}

// Columns 64 s .. +63 of the a0q tile of pixels p0 .. p0+63 of image b into
// a piece (64 rows of 64 swizzled bytes) and the same bytes into `copy`:
// thread i takes four columns (its fold values loaded once) of two pixels,
// q127 of the exact tanhf; columns past H are 0.
__device__ __forceinline__ void a0q_piece(const float* __restrict__ fold,
                                          const float* __restrict__ coords,
                                          int b, int p0, int H, int s,
                                          int8_t* piece, int8_t* copy) {
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
      const int q = int(q127(first_h0(x0, x1, w0[j], w1[j], c[j])));
      packed |= uint32_t(uint8_t(int8_t(q))) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(piece + offset_sw64(p, kl)) = packed;
    *reinterpret_cast<uint32_t*>(copy + offset_sw64(p, kl)) = packed;
  }
}

// 4 KiB from global memory into a piece: threads 0 .. 255, 16 bytes each.
__device__ __forceinline__ void load_piece(int8_t* piece, const int8_t* src) {
  if (threadIdx.x < PIECE / 16)
    reinterpret_cast<uint4*>(piece)[threadIdx.x] =
        reinterpret_cast<const uint4*>(src)[threadIdx.x];
}

// ---- the forward (K4 without and with a1; K5's scale pass with recompute)

template <int MODE>
struct FwdWSmem {
  int8_t ring[WSTAGES][SLAB];
  int8_t piece[PIECES][PIECE];
  // MODE_EMIT: one chunk's a1, packed (64, w) bf16 rows (w its columns);
  // MODE_SCALE: the tile's cast dz2
  uint32_t stage[MODE == MODE_EMIT    ? PT * KW / 2
                 : MODE == MODE_SCALE ? MAX_NO * PT
                                      : 4];
  float red[WG * MAX_NO * PT];       // the head's partials per warpgroup
  float z[MAX_NO * PT];              // and their sums over the chunks
  float scratch[WARPS];
  uint64_t full[WSTAGES], empty[WSTAGES];
};
static_assert(sizeof(FwdWSmem<MODE_Y>) <= 232448, "opt-in shared memory");
static_assert(sizeof(FwdWSmem<MODE_EMIT>) <= 232448, "opt-in shared memory");
static_assert(sizeof(FwdWSmem<MODE_SCALE>) <= 232448, "opt-in shared memory");

// Per tile, chunk by chunk: acc = a0q . W1q^T_chunk on the ring, h1 = acc *
// (sw/127) + b1, a1 = tanhf(h1); MODE_Y/EMIT: the chunk's head row sums
// cast(a1) . wht^T added to sm.z in chunk order (and MODE_EMIT bf16(a1) to
// its rows), y = sigmoid(z + bht) after the last chunk; MODE_SCALE: a1 to
// the stash, dh1 = (dzc^T . wht) * (1 - a1^2), the block's max |dh1|.  The
// tiles of the chunk's (image, block) grid as in the H <= 512 forward.
template <bool BF16, int MODE>
__global__ void __launch_bounds__(NT, 1)
int8_fwd90w_kernel(const Fwd90Args a, int nquads, int8_t* slots) {
  using Smem = FwdWSmem<MODE>;
  extern __shared__ __align__(128) uint8_t smem90[];
  Smem& sm = *reinterpret_cast<Smem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int nks = padded_k(H) / SB, nch = wchunks(H), per = nch * nks;
  const size_t R = wrows(H);
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const WRing ring{sm.ring, sm.full, sm.empty, a.wslabs, per, ntl * per,
                   cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();
  int8_t* slot = slots + size_t(blockIdx.x) * slot_bytes(H);
  auto block_of = [&](int k) { return (cid + k * ncl) * CS + int(ring.rank); };
  // piece seq: slab s = (seq % per) % nks of tile seq / per; the first
  // chunk builds it (and its copy in the slot), the later ones read it back
  auto piece = [&](int seq) {
    const int r = seq % per, s = r % nks;
    if (r < nks) {
      const int tb = block_of(seq / per);
      a0q_piece(a.fold, a.coords, a.b0 + tb / blocks, (tb % blocks) * PT, H,
                s, sm.piece[seq % PIECES], slot + size_t(s) * PIECE);
    } else {
      load_piece(sm.piece[seq % PIECES], slot + size_t(s) * PIECE);
    }
  };
  const float scale = __fmul_rn(*a.sw, 1.f / 127.f);
  const bool bulk = (H & 7) == 0;
  if (ntl > 0) {
    piece(0);
    fence_proxy_async();
  }
  __syncthreads();
  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k), b = a.b0 + tb / blocks;
    const int blk = tb % blocks, p0 = blk * PT;
    float* dzc = reinterpret_cast<float*>(sm.stage);
    if constexpr (MODE == MODE_SCALE) {
      // read after the first chunk's product, whose barriers order it
      if (tid < No * PT) {
        const size_t at = (size_t(b) * No + tid / PT) * HW + p0 + tid % PT;
        const float s = a.y[at];
        dzc[tid] = operand<BF16>(
            __fmul_rn(__fmul_rn(a.gy[at], s), __fsub_rn(1.f, s)));
      }
    }
    float mx = 0.f;
    for (int c = 0; c < nch; ++c) {
      const int n0 = c * KW;
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      piece_product(acc, sm.piece, ring, (k * nch + c) * nks, nks, wg,
                    [&](int seq) {
                      if (seq + 1 < ntl * per) piece(seq + 1);
                    });
      // a1 = tanhf(h1) of accumulator element j (0 past H)
      auto a1_of = [&](int j) {
        const int n = n0 + acc_col(wg, t, j);
        const float x = __fadd_rn(__fmul_rn(float(acc[j]), scale),
                                  n < H ? a.b1[n] : 0.f);
        return n < H ? tanhf(x) : 0.f;
      };
      if constexpr (MODE == MODE_SCALE) {
        // a1 to the stash (the accumulator the only array live), then the
        // dh1 phase column by column from it: thread n takes column n0 + n
        // over the block's 64 pixels, as the gradient pass reads it
#pragma unroll
        for (int j = 0; j < 64; j += 2) {
          const int p = 16 * w + g + 8 * ((j >> 1) & 1);
          *reinterpret_cast<float2*>(a.stash + (size_t(tb) * PT + p) * R +
                                     n0 + acc_col(wg, t, j)) =
              make_float2(a1_of(j), a1_of(j + 1));
        }
        __syncthreads();
        const int n = n0 + tid;
        if (n < H) {
          float wv[MAX_NO];
#pragma unroll
          for (int o = 0; o < MAX_NO; ++o)
            wv[o] = o < No ? a.wht[size_t(o) * H + n] : 0.f;
          const float* col = a.stash + size_t(tb) * PT * R + n;
#pragma unroll 4
          for (int p = 0; p < PT; ++p) {
            const float v = col[size_t(p) * R];
            float da1 = 0.f;
#pragma unroll
            for (int o = 0; o < MAX_NO; ++o)
              if (o < No) da1 = fmaf(dzc[o * PT + p], wv[o], da1);
            mx = fmaxf(mx, fabsf(__fmul_rn(
                               da1, __fsub_rn(1.f, __fmul_rn(v, v)))));
          }
        }
        continue;
      } else {
        float v[64];
#pragma unroll
        for (int j = 0; j < 64; ++j) v[j] = a1_of(j);
        const int wc = min(KW, H - n0);          // the chunk's columns
        if constexpr (MODE == MODE_EMIT) {
          uint16_t* st = reinterpret_cast<uint16_t*>(sm.stage);
#pragma unroll
          for (int j = 0; j < 64; j += 2) {
            const int p = 16 * w + g + 8 * ((j >> 1) & 1);
            const int nl = acc_col(wg, t, j);
            const uint16_t c0 =
                __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
            const uint16_t c1 =
                __bfloat16_as_ushort(__float2bfloat16_rn(v[j + 1]));
            if (nl < wc) st[p * wc + nl] = c0;
            if (nl + 1 < wc) st[p * wc + nl + 1] = c1;
          }
        }
        // the chunk's head row sums: this thread's 32 columns, the 4 lanes
        // of a row, then the 4 warpgroups in order, added to the chunks
        // before
        for (int o = 0; o < No; ++o) {
          float r0 = 0.f, r1 = 0.f;
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            if (j & 2) continue;
            const int n = n0 + acc_col(wg, t, j);
            const float wv = n < H ? __ldg(a.wht + size_t(o) * H + n) : 0.f;
            r0 = fmaf(wv, operand<BF16>(v[j]), r0);
            r1 = fmaf(wv, operand<BF16>(v[j + 2]), r1);
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
        if (MODE == MODE_EMIT) fence_proxy_async();
        __syncthreads();
        if (tid < No * PT) {
          float zc = 0.f;
          for (int q = 0; q < WG; ++q)
            zc += sm.red[(q * MAX_NO + tid / PT) * PT + tid % PT];
          if (SVT_I8W_DROP_HEAD && c == nch - 1) zc = 0.f;
          sm.z[tid] = c == 0 ? zc : __fadd_rn(sm.z[tid], zc);
        }
        if constexpr (MODE == MODE_EMIT) {
          __nv_bfloat16* dst = a.a1 + (size_t(b) * HW + p0) * H + n0;
          const uint16_t* st = reinterpret_cast<const uint16_t*>(sm.stage);
          if (bulk) {
            // one bulk copy a pixel row, 2 wc bytes (16-byte aligned ends)
            if (tid < PT) {
              bulk_store(dst + size_t(tid) * H, st + tid * wc,
                         uint32_t(2 * wc), l2_evict_first());
              bulk_commit();
              bulk_wait_read<0>();
            }
          } else {
            for (int i = tid; i < PT * wc; i += NT)
              reinterpret_cast<uint16_t*>(dst)[size_t(i / wc) * H + i % wc] =
                  st[i];
          }
        }
        __syncthreads();                 // red and the stage are free
      }
    }
    if constexpr (MODE == MODE_SCALE) {
      const float m = block_max(mx, sm.scratch);
      if (tid == 0) a.part_max[size_t(b) * blocks + blk] = m;
      __syncthreads();                   // dzc is free
    } else {
      if (tid < No * PT) {
        const int o = tid / PT, p = tid % PT;
        a.y[(size_t(b) * No + o) * HW + p0 + p] =
            1.f / (1.f + expf(-__fadd_rn(sm.z[tid], a.bht[o])));
      }
    }
  }
  if (MODE == MODE_EMIT && bulk && tid < PT) bulk_wait<0>();
  cluster_sync();
}

// ---- K5's scale pass from the bf16 residual past 512: one CTA per 64-pixel
// block, thread n reading column n of each 512-column chunk (a warp reads
// 64 contiguous bytes of a row); the block's max |dh1|.
template <bool BF16>
__global__ void __launch_bounds__(NT)
int8_scale90w_kernel(const __nv_bfloat16* __restrict__ a1,
                     const float* __restrict__ y, const float* __restrict__ gy,
                     const float* __restrict__ wht,
                     float* __restrict__ part_max, int HW, int H, int No,
                     int blocks) {
  __shared__ float dzc[MAX_NO * PT];
  __shared__ float scratch[WARPS];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / blocks, p0 = (blockIdx.x % blocks) * PT;
  if (tid < No * PT) {
    const size_t at = (size_t(b) * No + tid / PT) * HW + p0 + tid % PT;
    const float s = y[at];
    dzc[tid] = operand<BF16>(
        __fmul_rn(__fmul_rn(gy[at], s), __fsub_rn(1.f, s)));
  }
  __syncthreads();
  float mx = 0.f;
  for (int n = tid; n < H; n += NT) {
    float wv[MAX_NO];
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o)
      wv[o] = o < No ? wht[size_t(o) * H + n] : 0.f;
    const __nv_bfloat16* col = a1 + (size_t(b) * HW + p0) * H + n;
#pragma unroll 4
    for (int p = 0; p < PT; ++p) {
      const float v = __bfloat162float(col[size_t(p) * H]);
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

// ---- K5's gradient pass past 512

struct GradWSmem {
  int8_t ring[WSTAGES][SLAB];
  int8_t piece[PIECES][PIECE];
  int8_t q[TILE_B];                  // one chunk's dh1q tile
  float red[SLOTS][4][KW];
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  float scratch[WARPS];
  uint64_t full[WSTAGES], empty[WSTAGES];
};
static_assert(sizeof(GradWSmem) <= 232448, "opt-in shared memory on sm_90");

__device__ __forceinline__ float column_sum_w(const GradWSmem& sm, int s) {
  const int n = threadIdx.x;
  float v = sm.red[s][0][n];
  v += sm.red[s][1][n];
  v += sm.red[s][2][n];
  v += sm.red[s][3][n];
  return v;
}

// Per tile: dz2 and the group's scale; chunk by chunk, thread n quantises
// column n0 + n of dh1 over the block's 64 pixels (a1 from the residual or
// the stash) into the chunk's dh1q tile, its dW1 workspace row and the db1
// and dWh^T partials, and the tile goes to the K-major copy in the CTA's
// slot; the dbh partials; then da0 = dh1q . W1q^T chunk by chunk, dh1q's
// pieces read back from the K-major copy, a0 = tanhf(h0) exact in the
// epilogue giving dh0 and a0q (to its workspace), and the dfold partials.
// The numbers are int8_grad90_kernel's, column by column.
template <bool BF16, bool RESID>
__global__ void __launch_bounds__(NT, 1)
int8_grad90w_kernel(const Grad90Args a, int nquads, int8_t* slots) {
  extern __shared__ __align__(128) uint8_t smem90[];
  GradWSmem& sm = *reinterpret_cast<GradWSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, blocks = a.blocks;
  const int Mw = H + No * H + No;
  const int nks = padded_k(H) / SB, nch = wchunks(H), per = nch * nks;
  const size_t R = wrows(H);
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const WRing ring{sm.ring, sm.full, sm.empty, a.wslabs, per, ntl * per,
                   cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();
  int8_t* qk = slots + size_t(blockIdx.x) * slot_bytes(H);
  const int px0 = 16 * w + g, px1 = px0 + 8;

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

    int8_t* qrow = a.q_ws + size_t(tb) * R * PT;
    for (int c = 0; c < nch; ++c) {
      // the dh1 phase: column n of the block
      const int n = c * KW + tid;
      const bool on = n < H;
      float wv[MAX_NO];
#pragma unroll
      for (int o = 0; o < MAX_NO; ++o)
        wv[o] = on && o < No ? a.wht[size_t(o) * H + n] : 0.f;
      float db = 0.f, dw[MAX_NO];
#pragma unroll
      for (int o = 0; o < MAX_NO; ++o) dw[o] = 0.f;
#pragma unroll 1
      for (int cc = 0; cc < PT / 16; ++cc) {
        uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int p = 16 * cc + i;
          float v = 0.f;
          if (on)
            v = RESID ? __bfloat162float(
                            a.a1[(size_t(b) * HW + p0 + p) * H + n])
                      : a.stash[(size_t(tb) * PT + p) * R + n];
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
          sm.q[tile_off(p, tid)] = int8_t(q);
          // pixel p = 16 cc + g' + 8 h' at byte 2 g' + h' of chunk cc
          const int bi = 2 * (i & 7) + (i >> 3);
          pk[bi >> 2] |= qb << (8 * (bi & 3));
        }
        *reinterpret_cast<uint4*>(qrow + offset_sw64(n, 16 * cc)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
      if (on) {
        pw[n] = db;
#pragma unroll
        for (int o = 0; o < MAX_NO; ++o)
          if (o < No) pw[H + o * H + n] = dw[o];
      }
      __syncthreads();                   // the chunk's dh1q tile is whole
      // its pieces below Kp to the K-major copy; the barrier before the next
      // chunk writes the tile again
      const int npc = min(PIECES_PER_CHUNK, nks - c * PIECES_PER_CHUNK);
      for (int i = tid; i < npc * PIECE / 16; i += NT)
        reinterpret_cast<uint4*>(qk + size_t(c) * TILE_B)[i] =
            reinterpret_cast<const uint4*>(sm.q)[i];
      __syncthreads();
    }
    if (tid < No) {                      // dbh partials
      float s = 0.f;
      for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
      pw[H + No * H + tid] = s;
    }

    // da0 = dh1q . W1q^T chunk by chunk, dh1q's pieces from the K-major copy
    const int seq0 = k * per;
    auto load = [&](int seq) {
      const int s = (seq - seq0) % nks;
      load_piece(sm.piece[seq % PIECES],
                 qk + size_t(SVT_I8W_QK_OFF ? (s + 1) % nks : s) * PIECE);
    };
    load(seq0);
    fence_proxy_async();
    __syncthreads();
    int8_t* aq_ws = a.aq_ws + size_t(tb) * R * PT;
    const float dsc = __fmul_rn(sg, *a.sw);
    const float x00 = a.coords[2 * (p0 + px0)];
    const float x01 = a.coords[2 * (p0 + px0) + 1];
    const float x10 = a.coords[2 * (p0 + px1)];
    const float x11 = a.coords[2 * (p0 + px1) + 1];
    const float* f = a.fold + size_t(b) * 4 * H;
    for (int c = 0; c < nch; ++c) {
      const int n0 = c * KW;
      int acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0;
      piece_product(acc, sm.piece, ring, seq0 + c * nks, nks, wg,
                    [&](int seq) {
                      if (seq + 1 < seq0 + per) load(seq + 1);
                    });
      // dh0 = (acc * sg*sw) * (1 - a0^2) with the exact a0; a0q to its
      // workspace; the dfold partials
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float s0[8], s1[8], s2[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int nt = 4 * ch + u;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = n0 + acc_col(wg, t, 4 * nt + e);
            const bool on = i < H;
            const float w0 = on ? f[i] : 0.f, w1 = on ? f[H + i] : 0.f;
            const float cb = on ? f[2 * H + i] : 0.f;
            uint16_t qq = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float x0 = h ? x10 : x00, x1 = h ? x11 : x01;
              float dh0 = 0.f;
              if (on) {
                const float a0 = tanhf(first_h0(x0, x1, w0, w1, cb));
                const float aqv =
                    fminf(fmaxf(qround(__fmul_rn(a0, 127.f)), -127.f), 127.f);
                qq |= uint16_t(uint8_t(int8_t(aqv))) << (8 * h);
                const float da0 =
                    __fmul_rn(float(acc[4 * nt + 2 * h + e]), dsc);
                const float ad = SVT_I8W_DH0_AQ ? aqv / 127.f : a0;
                dh0 = __fmul_rn(da0, __fsub_rn(1.f, __fmul_rn(ad, ad)));
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
      if (n0 + tid < H) {
        float* pf = a.part_fold + gblk * 3 * H + n0;
        pf[tid] = column_sum_w(sm, 0);
        pf[H + tid] = column_sum_w(sm, 1);
        pf[2 * H + tid] = column_sum_w(sm, 2);
      }
      __syncthreads();
    }
  }
  cluster_sync();
}

// ---- the launches

template <bool BF16, int MODE>
cudaError_t launch_fwd90w(const Fwd90Args& a, int tiles, int8_t* slots,
                          int nslots, cudaStream_t st) {
  static int cache = 0;
  auto k = int8_fwd90w_kernel<BF16, MODE>;
  constexpr int smem = sizeof(FwdWSmem<MODE>);
  const int nquads = tiles / CS;
  const int ncl = min(min(nquads, nslots / CS),
                      cached_clusters(k, NT, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT, smem, CS, st, a, nquads,
                         slots);
}

template <bool BF16, bool RESID>
cudaError_t launch_grad90w(const Grad90Args& a, int tiles, int8_t* slots,
                           int nslots, cudaStream_t st) {
  static int cache = 0;
  auto k = int8_grad90w_kernel<BF16, RESID>;
  const int nquads = tiles / CS;
  const int ncl = min(min(nquads, nslots / CS),
                      cached_clusters(k, NT, sizeof(GradWSmem), &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT, sizeof(GradWSmem), CS,
                         st, a, nquads, slots);
}

// The shapes the wide passes take (int8_route's table): H > 512, HW a
// multiple of 256, a slot for at least one cluster.
bool bad90w(int B, int HW, int H, int No, const void* slots, int nslots) {
  return B < 1 || H <= KW || HW < CS * PT || HW % (CS * PT) || No < 1 ||
         No > MAX_NO || slots == nullptr || nslots < CS ||
         double(B) * (HW / PT) > 2147483647.0;
}

}  // namespace

extern "C" {

// K4 past H = 512.  As svt_int8_90_fwd, with wslabs W1q^T's chunked slab
// stream (fused_loss_int8.sm90_slabs of W1q^T, Kp * R bytes) and `slots`
// nslots x svt_int8_90w_slot_bytes(H) bytes of workspace (a0q, one slot a
// resident CTA; the launch takes at most nslots CTAs).
int svt_int8_90w_fwd(const void* fold, const void* coords, const void* wslabs,
                     const void* sw, const void* b1, const void* wht,
                     const void* bht, void* y, void* a1, void* slots,
                     int nslots, int B, int HW, int H, int No, int bf16,
                     void* stream) {
  if (bad90w(B, HW, H, No, slots, nslots)) return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  const Fwd90Args a{static_cast<const float*>(fold),
                    static_cast<const float*>(coords),
                    static_cast<const int8_t*>(wslabs),
                    static_cast<const float*>(sw),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(wht),
                    static_cast<const float*>(bht),
                    static_cast<float*>(y), nullptr,
                    static_cast<__nv_bfloat16*>(a1), nullptr, nullptr,
                    0, HW, H, No, blocks};
  const int tiles = B * blocks;
  auto* sl = static_cast<int8_t*>(slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = a1 ? launch_fwd90w<true, MODE_EMIT>(a, tiles, sl, nslots, st)
             : launch_fwd90w<true, MODE_Y>(a, tiles, sl, nslots, st);
  else
    err = a1 ? launch_fwd90w<false, MODE_EMIT>(a, tiles, sl, nslots, st)
             : launch_fwd90w<false, MODE_Y>(a, tiles, sl, nslots, st);
  return int(err);
}

// K5's scale pass past H = 512 for images b0 .. b0+Bc-1, as
// svt_int8_90_scale: from the bf16 residual a1, or (a1 null) a1 rebuilt on
// the wide forward's machinery (wslabs W1q^T's chunked stream, `slots` as
// for svt_int8_90w_fwd) and left, f32, in `stash` (Bc * HW * R * 4 bytes,
// R = svt_int8_90w_rows(H)).
int svt_int8_90w_scale(const void* fold, const void* coords,
                       const void* wslabs, const void* sw, const void* b1,
                       const void* wht, const void* a1, const void* y,
                       const void* gy, void* part_max, void* stash,
                       void* slots, int nslots, int b0, int Bc, int HW,
                       int H, int No, int bf16, void* stream) {
  // from the residual the pass takes no slot
  const bool resid = a1 != nullptr;
  if (b0 < 0 || (!resid && stash == nullptr) ||
      bad90w(Bc, HW, H, No, resid ? a1 : slots, resid ? CS : nslots))
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* gf = static_cast<const float*>(gy);
  auto* pm = static_cast<float*>(part_max);
  const auto* w = static_cast<const float*>(wht);
  if (resid) {
    const size_t o = size_t(b0) * No * HW;
    const auto* r = static_cast<const __nv_bfloat16*>(a1) +
                    size_t(b0) * HW * H;
    const unsigned grid = unsigned(Bc) * unsigned(blocks);
    if (bf16)
      int8_scale90w_kernel<true><<<grid, NT, 0, st>>>(
          r, yf + o, gf + o, w, pm + size_t(b0) * blocks, HW, H, No, blocks);
    else
      int8_scale90w_kernel<false><<<grid, NT, 0, st>>>(
          r, yf + o, gf + o, w, pm + size_t(b0) * blocks, HW, H, No, blocks);
    return int(cudaGetLastError());
  }
  const Fwd90Args a{static_cast<const float*>(fold),
                    static_cast<const float*>(coords),
                    static_cast<const int8_t*>(wslabs),
                    static_cast<const float*>(sw),
                    static_cast<const float*>(b1), w, nullptr,
                    const_cast<float*>(yf), gf, nullptr,
                    static_cast<float*>(stash), pm, b0, HW, H, No, blocks};
  const int tiles = Bc * blocks;
  auto* sl = static_cast<int8_t*>(slots);
  return int(bf16 ? launch_fwd90w<true, MODE_SCALE>(a, tiles, sl, nslots, st)
                  : launch_fwd90w<false, MODE_SCALE>(a, tiles, sl, nslots,
                                                     st));
}

// K5's gradient pass past H = 512 for images b0 .. b0+Bc-1, as
// svt_int8_90_grad: wslabs W1q's chunked slab stream (fused_loss_int8.
// sm90_slabs of W1q); aq_ws, q_ws Bc * HW/64 blocks of R x 64 bytes in
// svt_loss90_dw's layout (R = svt_int8_90w_rows(H)); `stash` the scale
// pass's f32 a1 (R columns a pixel) when a1 is null; `slots` as for
// svt_int8_90w_fwd (the K-major dh1q copy).
int svt_int8_90w_grad(const void* fold, const void* coords,
                      const void* wslabs, const void* sw, const void* wht,
                      const void* a1, const void* stash, const void* y,
                      const void* gy, const void* part_max, void* gscale,
                      void* aq_ws, void* q_ws, void* part_fold, void* part_w,
                      void* slots, int nslots, int b0, int Bc, int HW, int H,
                      int No, int Pt, int bf16, void* stream) {
  if (bad90w(Bc, HW, H, No, slots, nslots) || b0 < 0 || Pt < CS * PT ||
      Pt % (CS * PT) || HW % Pt || (a1 == nullptr && stash == nullptr))
    return int(cudaErrorInvalidValue);
  const Grad90Args a{static_cast<const float*>(fold),
                     static_cast<const float*>(coords),
                     static_cast<const int8_t*>(wslabs),
                     static_cast<const float*>(sw),
                     static_cast<const float*>(wht),
                     static_cast<const __nv_bfloat16*>(a1),
                     static_cast<const float*>(stash),
                     static_cast<const float*>(y),
                     static_cast<const float*>(gy),
                     static_cast<const float*>(part_max),
                     static_cast<float*>(gscale),
                     static_cast<int8_t*>(aq_ws),
                     static_cast<int8_t*>(q_ws),
                     static_cast<float*>(part_fold),
                     static_cast<float*>(part_w), b0, HW, H, No, Pt,
                     HW / PT};
  const int tiles = Bc * (HW / PT);
  auto* sl = static_cast<int8_t*>(slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = a1 ? launch_grad90w<true, true>(a, tiles, sl, nslots, st)
             : launch_grad90w<true, false>(a, tiles, sl, nslots, st);
  else
    err = a1 ? launch_grad90w<false, true>(a, tiles, sl, nslots, st)
             : launch_grad90w<false, false>(a, tiles, sl, nslots, st);
  return int(err);
}

// Rows of the wide passes' operands, stash and dW1 workspace blocks at width
// H: whole 512-column chunks.
int svt_int8_90w_rows(int H) { return wrows(H); }

// Bytes of one slot (a resident CTA's a0q or K-major dh1q copy).
long long svt_int8_90w_slot_bytes(int H) { return (long long)slot_bytes(H); }

// Clusters of 4 CTAs that can be resident at once for each wide kernel (0
// forward bf16, 1 forward f32, 2 forward with a1, 3 the recompute scale
// pass, 4 gradient from the residual, 5 gradient from the stash; bf16
// weights but for 1); 0 if the card cannot make one resident.
int svt_int8_90w_max_clusters(int which) {
  switch (which) {
    case 0:
      return max_clusters(int8_fwd90w_kernel<true, MODE_Y>, NT,
                          sizeof(FwdWSmem<MODE_Y>), CS);
    case 1:
      return max_clusters(int8_fwd90w_kernel<false, MODE_Y>, NT,
                          sizeof(FwdWSmem<MODE_Y>), CS);
    case 2:
      return max_clusters(int8_fwd90w_kernel<true, MODE_EMIT>, NT,
                          sizeof(FwdWSmem<MODE_EMIT>), CS);
    case 3:
      return max_clusters(int8_fwd90w_kernel<true, MODE_SCALE>, NT,
                          sizeof(FwdWSmem<MODE_SCALE>), CS);
    case 4:
      return max_clusters(int8_grad90w_kernel<true, true>, NT,
                          sizeof(GradWSmem), CS);
    case 5:
      return max_clusters(int8_grad90w_kernel<true, false>, NT,
                          sizeof(GradWSmem), CS);
    default:
      return 0;
  }
}

}  // extern "C"
