// Tile machinery shared by the fused spatial-decoder kernels for Hopper
// (sm_90a): fused_decoder_fwd.cu (forward) and fused_decoder_bwd.cu
// (backward).
//
// A block of NT = 512 threads owns PT = 64 pixels of one image.  A (PT, H)
// operand lives in shared memory (row stride AS); `tile_gemm` multiplies it
// by an (Hp, Hp) f32 matrix streamed from global memory through a 3-stage
// ring of 16-row slabs (16-byte cp.async copies, one barrier per two
// k8-steps) on the tensor cores with mma.sync m16n8k8 TF32, and leaves the
// (64, 512) product in registers: warp w owns columns 32w .. 32w+31 as 4 x 4
// m16n8 tiles.  Up to H = MAX_H = 512 the whole layer output is one such
// chunk and the (PT, H) operand lives in shared memory.  A wider layer (the
// `WIDE` instantiations) keeps its operand in a per-block workspace in
// global memory (row stride `as`, read through L1) and is computed in
// 512-column chunks: each chunk streams its slab columns n0 .. n0+511 of W
// through the same ring, so the ring and the register tile keep their size
// at every width.
//   - f32 weights: each operand is split into a TF32 head and tail
//     (x = hi + lo) and the product is hi*hi + hi*lo + lo*hi, three passes
//     that keep about f32 accuracy;
//   - bf16 weights (widened to f32 by the caller, which is exact): a bf16
//     value is exact in TF32, so one pass computes exactly the bf16-operand,
//     f32-accumulate product.
// Row strides are padded so every fragment load of a warp hits 32 banks.
//
// Two build-time switches exist only to place the kernels' error limits:
// a copy built with -DSVT_TF32_SPLIT=0 runs one TF32 pass for f32 weights,
// one built with -DSVT_BF16_CASTS=0 drops the bf16 operand casts, and one
// built with -DSVT_WIDE_DROP_LAST=1 skips a wide layer's ragged last column
// chunk.  The library is always built with the first two at 1 and the last
// at 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef SVT_TF32_SPLIT
#define SVT_TF32_SPLIT 1
#endif
#ifndef SVT_BF16_CASTS
#define SVT_BF16_CASTS 1
#endif
#ifndef SVT_WIDE_DROP_LAST
#define SVT_WIDE_DROP_LAST 0
#endif

namespace svt {

constexpr int PT = 64;                 // pixels per block: four m16 tiles
constexpr int NT = 512;                // threads per block: 16 warps
constexpr int WARPS = NT / 32;
constexpr int MAX_H = 512;             // columns of one register chunk
constexpr int WN = MAX_H / WARPS;      // columns per warp
constexpr int MTILES = PT / 16;
constexpr int NTILES = WN / 8;
constexpr int BK = 16;                 // W rows per slab: two k8-steps
constexpr int STAGES = 3;              // slabs in flight
constexpr int BNS = MAX_H + 8;         // slab row stride: conflict-free B frags
constexpr int AS = MAX_H + 4;          // activation row stride: same for A
constexpr int MAX_NO = 8;
constexpr int MAX_LH = 4;
constexpr size_t SMEM_BYTES =
    (size_t(PT) * AS + size_t(STAGES) * BK * BNS) * sizeof(float);
static_assert(NT == MAX_H, "the first layer takes one column per thread");
static_assert(MAX_NO * MAX_H + 2 * MAX_NO * PT <= STAGES * BK * BNS,
              "head weights and head cotangents fit the ring");
static_assert(SMEM_BYTES <= 232448, "opt-in shared memory per block on sm_90");
// The WIDE kernels keep only the ring (and K2's head cotangents) in shared
// memory; each block's (PT, Hp) operands live in a workspace of
// WIDE_BLOCK_FLOATS(Hp) floats: two buffers of row stride Hp.
constexpr size_t RING_BYTES = size_t(STAGES) * BK * BNS * sizeof(float);
__host__ __device__ constexpr size_t wide_block_floats(int hp) {
  return 2 * size_t(PT) * hp;
}

__host__ __device__ constexpr int padded_hidden(int h) {
  return (h + 31) / 32 * 32;
}

// The end of a wide layer's 512-column chunks (n0 < wide_end(Hp)).
__device__ __forceinline__ int wide_end(int hp) {
  return SVT_WIDE_DROP_LAST ? hp / MAX_H * MAX_H : hp;
}

// The cast before each product (the TPU kernel's `x.astype(w.dtype)`):
// identity for f32 weights, round-to-nearest-even to bf16 for bf16 weights.
template <bool BF16>
__device__ __forceinline__ float operand(float a) {
  return (BF16 && SVT_BF16_CASTS) ? __bfloat162float(__float2bfloat16_rn(a))
                                  : a;
}

// Where the cast of a shared-memory operand happens.  With bf16 weights and
// no residual add the f32 value is never read again, so it is rounded once
// when stored; with the residual add the f32 value stays in shared memory
// for the add and is rounded at each read.  (Rounding is idempotent.)
template <bool BF16, bool RESID>
__device__ __forceinline__ float stored(float v) {
  return (BF16 && !RESID) ? operand<BF16>(v) : v;
}
template <bool BF16, bool RESID>
__device__ __forceinline__ float loaded(float v) {
  return (BF16 && !RESID) ? v : operand<BF16>(v);
}

// Element i of a float or bf16 array, as f32 (widening bf16 is exact).
template <bool IS_BF16>
__device__ __forceinline__ float load_elem(const void* p, size_t i) {
  if (IS_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}
// Store v at i of a float or bf16 array (round to nearest even for bf16).
template <bool IS_BF16>
__device__ __forceinline__ void store_elem(void* p, size_t i, float v) {
  if (IS_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32 (about 21 significant bits together)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy that bypasses registers and L1
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

// Column n and tile row p of accumulator element (mt, nt, c) of this thread.
__device__ __forceinline__ int frag_col(int warp, int t, int nt, int c) {
  return warp * WN + nt * 8 + 2 * t + (c & 1);
}
__device__ __forceinline__ int frag_row(int g, int mt, int c) {
  return mt * 16 + g + (c >> 1) * 8;
}

// acc = loaded(act) (PT, Hp) @ W[:, n0 : n0+512] (columns past Hp are not
// computed), W (Hp, Hp) row-major [k][n] in global memory, zero outside its
// leading (H, H); act has row stride AS (shared memory) or, WIDE, `as`.
// Without WIDE n0 is 0 and Hp <= 512.  Starts with a barrier (act written,
// ring free) and ends with one (every read of act and the ring done), so
// the caller may then update act in place.
template <bool BF16, bool RESID, bool WIDE = false>
__device__ __forceinline__ void tile_gemm(const float* act, float* ring,
                                          const float* __restrict__ W, int Hp,
                                          float (&acc)[MTILES][NTILES][4],
                                          int as = AS, int n0 = 0) {
  constexpr bool SPLIT = !BF16 && SVT_TF32_SPLIT;
  const int ast = WIDE ? as : AS;
  const int c0 = WIDE ? n0 : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nslab = Hp / BK;
  const bool busy = c0 + warp * WN < Hp;   // warps past Hp own only padding
  auto fill = [&](int slab) {
    if (slab < nslab) {
      float* dst = ring + (slab % STAGES) * BK * BNS;
      const float* src = W + size_t(slab) * BK * Hp + c0;
#pragma unroll
      for (int j = 0; j < BK * MAX_H / 4 / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / (MAX_H / 4), c = (i % (MAX_H / 4)) * 4;
        if (c0 + c < Hp)
          cp_async16(dst + r * BNS + c, src + size_t(r) * Hp + c);
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };
#pragma unroll
  for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  __syncthreads();                    // act written, ring free
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill(s);
  for (int j = 0; j < nslab; ++j) {
    cp_async_wait<STAGES - 2>();      // slab j has landed (this thread)
    __syncthreads();                  // ... for every thread; slab j-1 free
    fill(j + STAGES - 1);             // refills slab j-1's stage
    if (!busy) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const float* bp =
          ring + (j % STAGES) * BK * BNS + (kk + t) * BNS + warp * WN + g;
      uint32_t bhi[NTILES][2], blo[NTILES][2];
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const float v0 = bp[nt * 8], v1 = bp[4 * BNS + nt * 8];
        if (SPLIT) {
          split(v0, bhi[nt][0], blo[nt][0]);
          split(v1, bhi[nt][1], blo[nt][1]);
        } else {
          bhi[nt][0] = __float_as_uint(v0);
          bhi[nt][1] = __float_as_uint(v1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MTILES; ++mt) {
        const float* ap = act + (mt * 16 + g) * ast + j * BK + kk + t;
        const float av[4] = {ap[0], ap[8 * ast], ap[4], ap[8 * ast + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = loaded<BF16, RESID>(av[c]);
          if (SPLIT)
            split(x, ahi[c], alo[c]);
          else
            ahi[c] = __float_as_uint(x);
        }
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          if (SPLIT) {
            mma_tf32(acc[mt][nt], alo, bhi[nt][0], bhi[nt][1]);
            mma_tf32(acc[mt][nt], ahi, blo[nt][0], blo[nt][1]);
          }
          mma_tf32(acc[mt][nt], ahi, bhi[nt][0], bhi[nt][1]);
        }
      }
    }
  }
  cp_async_wait<0>();                 // drain the (empty) tail groups
  __syncthreads();                    // every read of act and ring done
}

}  // namespace svt
