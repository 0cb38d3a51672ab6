// Tile machinery shared by the int8 decoder kernels for Hopper (sm_90a):
// fused_decoder_int8.cu (K4 forward, K5 backward) and fused_loss_int8.cu
// (K3, the fused loss and gradient).
//
// A block of NT = 512 threads owns PT = 64 pixels of one image.  Its
// quantised first-layer activation (PT, Kp) int8 lives in shared memory
// (row stride AS bytes); `tile_gemm_s8` multiplies it by a (Kp, Kp) int8
// matrix given as rows of its transpose ([n][k], k contiguous) in global
// memory, streamed through a 3-stage ring of 64-byte-deep slabs (16-byte
// cp.async copies), on the tensor cores with mma.sync m16n8k32 s8 x s8 ->
// s32, which is exact.  Warp w owns output columns 32w .. 32w+31 as 4 x 4
// m16n8 tiles: one 512-column chunk.  Up to H = MAX_H = 512 that chunk is
// the whole layer and the tiles live in shared memory.  Wider layers (the
// `WIDE` instantiations) keep the block's (PT, Kp) int8 tiles in a
// per-block workspace in global memory (row stride `as` = Kp + 16, read
// through L1) and run every GEMM and epilogue in 512-column chunks; a slab
// of the ring carries only the current chunk's 512 rows of W^T, so the ring
// (122,880 B) and the register tile keep their size at every width, and
// the quantisation groups do not change.  Both the [-7, 7] values of K3 and the
// [-127, 127] values of K4/K5 ride int8: Hopper's tensor cores run no s4
// instruction (ptxas emulates s4 mma.sync with s8 IMMAs; fused_loss_int8.cuh).
// Row strides are padded so that every fragment load of a warp hits 32
// banks.
//
// The loss kernels' first layer (`first_layer_qx`) quantises four columns
// per thread, at either level, rounding to nearest or stochastically with
// Philox4x32-10 words (one call per four columns of a pixel).
//
// The quantisation rounds to nearest even (rintf), as jnp.round does.  Two
// build-time switches exist only to place the kernels' error limits against
// copies with one step removed: -DSVT_INT8_RTZ=1 rounds every quantisation
// toward zero, -DSVT_INT8_BLOCK_SCALE=1 takes each gradient scale over the
// block's own 64 pixels instead of its whole quantisation group.  Three
// more place the measurement levers' and the wide path's limits:
// -DSVT_PADE_EXACT=1 evaluates the Pade lever with the exact tanh,
// -DSVT_A1Q_TILE_SCALE=1 quantises A1Q's a1 at the block's own scale
// 127/max|a1| instead of the static 127, and -DSVT_WIDE_DROP_LAST=1 skips a
// wide layer's ragged last 512-column chunk.  The library is always built
// with all five at 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef SVT_INT8_RTZ
#define SVT_INT8_RTZ 0
#endif
#ifndef SVT_INT8_BLOCK_SCALE
#define SVT_INT8_BLOCK_SCALE 0
#endif
#ifndef SVT_PADE_EXACT
#define SVT_PADE_EXACT 0
#endif
#ifndef SVT_A1Q_TILE_SCALE
#define SVT_A1Q_TILE_SCALE 0
#endif
#ifndef SVT_WIDE_DROP_LAST
#define SVT_WIDE_DROP_LAST 0
#endif

namespace svt8 {

constexpr int PT = 64;                 // pixels per block: four m16 tiles
constexpr int NT = 512;                // threads per block: 16 warps
constexpr int WARPS = NT / 32;
constexpr int MAX_H = 512;
constexpr int WN = MAX_H / WARPS;      // output columns per warp (32)
constexpr int MTILES = PT / 16;
constexpr int NTILES = WN / 8;
constexpr int BK = 64;                 // k bytes per slab: two k32 steps
constexpr int STAGES = 3;
constexpr int SLAB_S = BK + 16;        // slab row stride (bytes)
constexpr int AS = MAX_H + 16;         // activation tile row stride (bytes)
constexpr int MAX_NO = 8;
constexpr int RING_BYTES = STAGES * MAX_H * SLAB_S;
constexpr int TILE_BYTES = PT * AS;
static_assert(NT == MAX_H, "the first layer takes one column per thread");
// The WIDE kernels' tiles: two (PT, as) int8 tiles per block in global
// memory, as = Kp + 16 (16-byte rows).
__host__ __device__ constexpr int wide_stride(int kp) { return kp + 16; }
__host__ __device__ constexpr size_t wide_block_bytes(int kp) {
  return 2 * size_t(PT) * wide_stride(kp);
}
static_assert(WARPS * MAX_NO * PT * 4 <= RING_BYTES,
              "the head's cross-warp partials fit the ring");

__host__ __device__ constexpr int padded_k(int h) { return (h + 63) / 64 * 64; }

// The end of the chunks of a kernel's layer: n0 = 0, 512, ... below Kp
// (WIDE), or the one chunk n0 = 0.
template <bool WIDE>
__device__ __forceinline__ int chunk_end(int H) {
  return WIDE ? (SVT_WIDE_DROP_LAST ? padded_k(H) / MAX_H * MAX_H
                                    : padded_k(H))
              : 1;
}

// ---- stochastic rounding: Philox4x32-10 (Salmon et al., SC'11), the same
// generator as kernels/philox.py.  A draw of the loss kernel is keyed by (the
// f32 bits of b1[0], the site) and counted by (image, decoder row, column/4,
// 0): one call serves four columns, and a word does not depend on the block,
// the chunk or the order of evaluation, so the forward site draws the same
// words in both passes and the plain version draws them too.
constexpr uint32_t SITE_FWD = 0x51A7E001u;
constexpr uint32_t SITE_GRAD = 0x51A7E002u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// clip(floor(x + u), -lv, lv), u = f32((bits & 0x7FFFFF) | 0x3F800000) - 1,
// x + u rounded once: the JAX _sr_int.  A zero stays zero.
__device__ __forceinline__ float sr_round(float x, uint32_t bits, float lv) {
  const float u = __fsub_rn(__uint_as_float((bits & 0x7FFFFFu) | 0x3F800000u),
                            1.f);
  return fminf(fmaxf(floorf(__fadd_rn(x, u)), -lv), lv);
}

// Round to bf16 and back: the cast of a product operand with bf16 weights,
// and every step of a bf16 elementwise chain (the product or difference of
// two bf16 values is exact in f32, so this is bf16 arithmetic).
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? rb(x) : x;
}

// Quantisation rounding: to nearest even, or toward zero in the copy that
// places the limits.
__device__ __forceinline__ float qround(float x) {
  return SVT_INT8_RTZ ? truncf(x) : rintf(x);
}

// The loss kernel's Pade tanh (SPATIALVAE_TANH=pade; the JAX _tanh_pade):
// x(945 + t(105 + t)) / (945 + t(420 + 15t)), t = x^2, clipped to [-1, 1],
// every op rounded in the plain version's order.  The TPU multiplies by an
// approximate reciprocal; here the division is exact (IEEE, __fdiv_rn), as
// in the plain version.
__device__ __forceinline__ float tanh_pade(float x) {
  if (SVT_PADE_EXACT) return tanhf(x);
  const float t = __fmul_rn(x, x);
  const float num =
      __fmul_rn(x, __fadd_rn(945.f, __fmul_rn(t, __fadd_rn(105.f, t))));
  const float den =
      __fadd_rn(945.f, __fmul_rn(t, __fadd_rn(420.f, __fmul_rn(15.f, t))));
  return fminf(fmaxf(__fdiv_rn(num, den), -1.f), 1.f);
}

// First-layer pre-activation with the plain version's op order and no
// contraction: (x0*w0 + x1*w1) + c.
__device__ __forceinline__ float first_h0(float x0, float x1, float w0,
                                          float w1, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1)), c);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Column and tile row of accumulator element (mt, nt, c) of this thread.
__device__ __forceinline__ int frag_col(int warp, int t, int nt, int c) {
  return warp * WN + nt * 8 + 2 * t + (c & 1);
}
__device__ __forceinline__ int frag_row(int g, int mt, int c) {
  return mt * 16 + g + (c >> 1) * 8;
}

// Sum of v over the 8 lanes that share t (the g lanes of a column), and
// over the 4 lanes that share g (the t lanes of a row).
__device__ __forceinline__ float sum_over_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}
__device__ __forceinline__ float sum_over_t(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The quantised first layer of pixels p0 .. p0+63 of one image into the
// (PT, AS) int8 tile: q = clip(round(LEVEL * tanh(h0)), -LEVEL, LEVEL),
// thread k owning column k.  Columns k >= H and pixels past HW are zero,
// so the padded K range of every GEMM adds nothing and the workspaces hold
// zeros there.
// WIDE: thread k owns columns k, k + NT, ... of a tile of row stride `as`.
template <int LEVEL, bool WIDE = false>
__device__ __forceinline__ void first_layer_q(const float* __restrict__ fold,
                                              const float* __restrict__ coords,
                                              int b, int p0, int HW, int H,
                                              int8_t* tile, int as = AS) {
  const int ast = WIDE ? as : AS;
  for (int k = threadIdx.x; k < padded_k(H); k += NT) {
    const bool on = k < H;
    const float* f = fold + size_t(b) * 4 * H;
    const float w0 = on ? f[k] : 0.f;
    const float w1 = on ? f[H + k] : 0.f;
    const float c = on ? f[2 * H + k] : 0.f;
#pragma unroll 4
    for (int p = 0; p < PT; ++p) {
      const int pix = p0 + p;
      int8_t q = 0;
      if (on && pix < HW) {
        const float a0 = tanhf(first_h0(coords[2 * pix], coords[2 * pix + 1],
                                        w0, w1, c));
        const float v = qround(__fmul_rn(a0, float(LEVEL)));
        q = static_cast<int8_t>(fminf(fmaxf(v, -float(LEVEL)), float(LEVEL)));
      }
      tile[p * ast + k] = q;
    }
    if (!WIDE) break;
  }
}

// One quad (columns 4*quad .. +3) of first_layer_qx.
__device__ __forceinline__ void first_layer_qx_quad(
    const float* __restrict__ fold, const float* __restrict__ coords, int b,
    int img, int p0, int HW, int H, float lf, bool sr, uint32_t seed, int8_t* tile,
    int8_t* tile4, int as, int quad, bool pade, int pb = 0) {
  const int k0 = 4 * quad;
  const float* f = fold + size_t(b) * 4 * H;
  float w0[4], w1[4], c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool on = k0 + j < H;
    w0[j] = on ? f[k0 + j] : 0.f;
    w1[j] = on ? f[H + k0 + j] : 0.f;
    c[j] = on ? f[2 * H + k0 + j] : 0.f;
  }
  for (int p = threadIdx.x / (MAX_H / 4); p < PT; p += NT / (MAX_H / 4)) {
    const int pix = p0 + p;
    uint32_t packed = 0, packed4 = 0;
    if (pix < HW) {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (sr)
        w = philox4x32_10(make_uint4(img, pb + pix, quad, 0u), seed,
                          SITE_FWD);
      const float x0 = coords[2 * pix], x1 = coords[2 * pix + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + j >= H) continue;
        const float h0 = first_h0(x0, x1, w0[j], w1[j], c[j]);
        const float a0 = pade ? tanh_pade(h0) : tanhf(h0);
        const float v = __fmul_rn(a0, lf);
        const float q = sr ? sr_round(v, word_of(w, j), lf)
                           : fminf(fmaxf(qround(v), -lf), lf);
        packed |= uint32_t(uint8_t(int8_t(q))) << (8 * j);
        if (tile4 != nullptr) {
          const float q4 =
              fminf(fmaxf(qround(__fmul_rn(a0, 7.f)), -7.f), 7.f);
          packed4 |= uint32_t(uint8_t(int8_t(q4))) << (8 * j);
        }
      }
    }
    *reinterpret_cast<uint32_t*>(tile + p * as + k0) = packed;
    if (tile4 != nullptr)
      *reinterpret_cast<uint32_t*>(tile4 + p * as + k0) = packed4;
  }
}

// The loss kernels' quantised first layer of pixels p0 .. p0+63 of image b
// into the (PT, AS) tile: q = clip(round(lf * a0), -lf, lf), a0 =
// tanh(x0*w0 + x1*w1 + c), or with `sr` clip(floor(lf*a0 + u), -lf, lf) with
// the forward site's words; `tile4` (if not null) gets clip(round(7 * a0),
// -7, 7) beside it (the feature-major kernel's 4-bit dW1 operand).  `img`:
// image b's index in the call, the words' counter (b itself, or b0 + b
// where `fold` starts at the call's image b0); `pb` the first pixel's row
// in the call, the words' counter row pb + p0 + p (0, or where coords is a
// pixel shard's slice of the call's).  Thread i owns columns 4*(i % 128) .. +3 of pixels i/128, i/128 + 4, ... (WIDE:
// and the same columns of every further 512-column chunk); columns past H
// and pixels past HW are zero.  `pade`: a0 through the Pade tanh.  The
// caller syncs before another thread reads the tiles.
template <bool WIDE = false>
__device__ __forceinline__ void first_layer_qx(
    const float* __restrict__ fold, const float* __restrict__ coords, int b,
    int img, int p0, int HW, int H, float lf, bool sr, uint32_t seed,
    int8_t* tile, int8_t* tile4, int as = AS, bool pade = false, int pb = 0) {
  for (int quad = threadIdx.x % (MAX_H / 4); 4 * quad < padded_k(H);
       quad += MAX_H / 4) {
    first_layer_qx_quad(fold, coords, b, img, p0, HW, H, lf, sr, seed, tile,
                        tile4, WIDE ? as : AS, quad, pade, pb);
    if (!WIDE) break;
  }
}

// acc = tile (PT, Kp) int8 @ W[:, n0 : n0+512] (columns past Kp are not
// computed), W given as rows of its transpose: Wt[n][k] (Kp, Kp) int8 in
// global memory; the tile has row stride AS (shared memory) or, WIDE, `as`.
// Without WIDE n0 is 0 and Kp <= 512.  Starts with a barrier (tile written,
// ring free) and ends with one (every read of the tile and the ring done).
template <bool WIDE = false>
__device__ __forceinline__ void tile_gemm_s8(const int8_t* tile,
                                             int8_t* ring,
                                             const int8_t* __restrict__ Wt,
                                             int Kp,
                                             int (&acc)[MTILES][NTILES][4],
                                             int as = AS, int n0 = 0) {
  const int ast = WIDE ? as : AS;
  const int r0 = WIDE ? n0 : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nslab = Kp / BK;
  const bool busy = r0 + warp * WN < Kp;   // warps past Kp own only padding
  auto fill = [&](int slab) {
    if (slab < nslab) {
      int8_t* dst = ring + (slab % STAGES) * MAX_H * SLAB_S;
      const int8_t* src = Wt + size_t(r0) * Kp + size_t(slab) * BK;
#pragma unroll
      for (int j = 0; j < MAX_H * (BK / 16) / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
        if (r0 + r < Kp)
          cp_async16(dst + r * SLAB_S + c, src + size_t(r) * Kp + c);
      }
    }
    cp_async_commit();                 // empty groups keep the count uniform
  };
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  __syncthreads();                     // tile written, ring free
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill(s);
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<STAGES - 2>();       // slab j has landed (this thread)
    __syncthreads();                   // ... for every thread; slab j-1 free
    fill(j + STAGES - 1);
    if (!busy) continue;
    const int8_t* slab = ring + (j % STAGES) * MAX_H * SLAB_S;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t bf[NTILES][2];
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const int8_t* bp = slab + (warp * WN + nt * 8 + g) * SLAB_S + kk + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const int8_t* ap = tile + (mt * 16 + g) * ast + j * BK + kk + 4 * t;
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(ap),
            *reinterpret_cast<const uint32_t*>(ap + 8 * ast),
            *reinterpret_cast<const uint32_t*>(ap + 16),
            *reinterpret_cast<const uint32_t*>(ap + 8 * ast + 16)};
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
          mma_s8(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                     // every read of tile and ring done
}

// The (PT, Kp) int8 tile to a feature-major workspace: ws[(k * HWp) + p0 +
// p] for k < Kp, p < PT, in 16-byte stores (thread k owns row k; WIDE: rows
// k, k + NT, ... of a tile of row stride `as`).
template <bool WIDE = false>
__device__ __forceinline__ void tile_to_feature_major(const int8_t* tile,
                                                      int8_t* __restrict__ ws,
                                                      int p0, int HWp,
                                                      int Kp, int as = AS) {
  const int ast = WIDE ? as : AS;
  for (int k = threadIdx.x; k < Kp; k += NT) {
    int8_t* dst = ws + size_t(k) * HWp + p0;
#pragma unroll
    for (int c = 0; c < PT / 16; ++c) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v |= uint32_t(uint8_t(tile[(c * 16 + q * 4 + e) * ast + k]))
               << (8 * e);
        w[q] = v;
      }
      *reinterpret_cast<uint4*>(dst + c * 16) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (!WIDE) break;
  }
}

// z[o][p] = sum_n wht[o][n] * v[p][n] over the block's (PT, 512) values of
// columns n0 .. n0+511 held in the accumulator layout (v zero for n >= H;
// RB: v rounded to bf16 at use), for o < No: per-thread
// partials, a shuffle over the t lanes, then the 16 warps' partials through
// `red` (WARPS * MAX_NO * PT floats) summed in warp order by thread o*PT+p.
// Returns z (without bias) for tid < No*PT; the caller syncs before reusing
// `red`.
template <bool RB = false>
__device__ __forceinline__ float head_dot(
    const float (&v)[MTILES][NTILES][4], const float* __restrict__ wht,
    int H, int No, float* red, int n0 = 0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int o = 0; o < No; ++o) {
    float part[MTILES][2];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt) part[mt][0] = part[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
        const float w = n < H ? __ldg(wht + size_t(o) * H + n) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt)
          part[mt][c >> 1] = fmaf(w, RB ? rb(v[mt][nt][c]) : v[mt][nt][c],
                                  part[mt][c >> 1]);
      }
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float s = sum_over_t(part[mt][hf]);
        if (t == 0) red[(warp * MAX_NO + o) * PT + mt * 16 + g + 8 * hf] = s;
      }
  }
  __syncthreads();
  float z = 0.f;
  if (tid < No * PT) {
    const int o = tid / PT, p = tid % PT;
    for (int w = 0; w < WARPS; ++w) z += red[(w * MAX_NO + o) * PT + p];
  }
  return z;
}

// Shared memory of every per-block kernel: the activation tile, a second
// tile (K3's qi, K5's dh1q), the weight ring, dz2 and its cast, scratch.
// The WIDE kernels keep the two tiles in the block's workspace slice and
// the rest in shared memory.
constexpr int SMEM = 2 * TILE_BYTES + RING_BYTES + 2 * MAX_NO * PT * 4 + 64;
constexpr int SMEM_WIDE = RING_BYTES + 2 * MAX_NO * PT * 4 + 64;
static_assert(SMEM <= 232448, "opt-in shared memory per block on sm_90");

struct Smem {
  int8_t* tile;
  int8_t* q;
  int8_t* ring;
  float* dz;
  float* dzc;
  float* scratch;
  int as;          // the tiles' row stride (AS, or wide_stride(Kp))
};

// WIDE: the tiles are the block's slice of `ws` (wide_block_bytes(Kp)
// bytes at blockIdx.x); else both lie in shared memory.
template <bool WIDE = false>
__device__ __forceinline__ Smem carve(void* base, int8_t* ws = nullptr,
                                      int Kp = 0) {
  Smem s;
  int8_t* p = static_cast<int8_t*>(base);
  if (WIDE) {
    s.as = wide_stride(Kp);
    s.tile = ws + size_t(blockIdx.x) * wide_block_bytes(Kp);
    s.q = s.tile + size_t(PT) * s.as;
  } else {
    s.as = AS;
    s.tile = p;
    s.q = p + TILE_BYTES;
    p += 2 * TILE_BYTES;
  }
  s.ring = p;
  s.dz = reinterpret_cast<float*>(s.ring + RING_BYTES);
  s.dzc = s.dz + MAX_NO * PT;
  s.scratch = s.dzc + MAX_NO * PT;
  return s;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Fixed-order block reductions of one value per thread (every thread of
// the block calls them): the sum and the max, through `scratch` (WARPS
// floats).  Thread 0 gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += scratch[w];
  return s;
}
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, scratch[w]);
  return m;
}

// The largest of a quantisation group's block maxima: the group of the
// block at pixel p0 spans ceil(Pt/64) blocks from its first (Pt a multiple
// of 64, or Pt = HW: one group per image).  With SVT_INT8_BLOCK_SCALE the
// block's own maximum.
__device__ __forceinline__ float group_max(const float* __restrict__ part_max,
                                           int b, int p0, int blocks, int Pt) {
  const int bpg = (Pt + PT - 1) / PT;
  const int blk = p0 / PT;
  if (SVT_INT8_BLOCK_SCALE) return part_max[size_t(b) * blocks + blk];
  const int first = (blk / bpg) * bpg;
  float m = 0.f;
  for (int i = 0; i < bpg; ++i)
    m = fmaxf(m, part_max[size_t(b) * blocks + first + i]);
  return m;
}

}  // namespace svt8
