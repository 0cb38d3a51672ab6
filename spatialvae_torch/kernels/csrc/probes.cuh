// The probe GEMMs' tile machinery for Hopper (sm_90a), shared by probes.cu
// (the int4 and narrow-accumulator probes) and kernel_bench.cu (the kernel
// microbenchmark's multi-product GEMMs): block configurations, operand
// tile loads (B transposed by byte permutes as it is loaded), one step's
// product of a warp on mma.sync and the block sum.  probes.cu's header
// comment describes the layouts and the build-time switches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef SVT_PROBE_DROP_LAST_K
#define SVT_PROBE_DROP_LAST_K 0
#endif
#ifndef SVT_PROBE_I16_WRAP
#define SVT_PROBE_I16_WRAP 0
#endif
#ifndef SVT_PROBE_TR_SWAP
#define SVT_PROBE_TR_SWAP 0
#endif

namespace svtp {

constexpr int NT = 256;               // threads of every probe block
constexpr int WARPS = NT / 32;
constexpr int BK = 64;                // k bytes per loop iteration: 2 mma
constexpr int MAX_SMEM = 232448;      // opt-in shared memory per block
constexpr int BUILD_PIX = 128;        // pixels per probe_build_t block
constexpr int TR_BH = 16;             // columns per probe_transpose_sum block
enum Store { NONE = 0, I32 = 1, I16 = 2, BF16 = 3, F32 = 4 };

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int KSPLIT_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_,
                       WARPS_N = WARPS_N_, KSPLIT = KSPLIT_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NTL = WN / 8;
  static_assert(WARPS_M * WARPS_N * KSPLIT == WARPS, "eight warps");
};
using Big = Cfg<128, 128, 4, 2, 1>;
using Small = Cfg<64, 32, 2, 1, 4>;

__host__ __device__ constexpr int align16(int x) { return (x + 15) / 16 * 16; }

// Shared memory of a GEMM block: the A tile (k-contiguous rows of stride
// kb + 16, or for d00 the (kb, BM) tile as loaded with row stride BM + 4),
// the B tile (BN rows of stride kb + 16), the split-k partials and the
// block reduction's words.
template <class C>
__host__ __device__ constexpr int a_bytes(int kb, bool a_tr) {
  return align16(a_tr ? kb * (C::BM + 4) : C::BM * (kb + 16));
}
template <class C>
__host__ __device__ constexpr int gemm_smem(int kb, bool a_tr) {
  return a_bytes<C>(kb, a_tr) + C::BN * (kb + 16) +
         (C::KSPLIT - 1) * C::BM * C::BN * 4 + WARPS * 4;
}

// o[j] = byte j of w[0..3], in order: a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
  if (SVT_PROBE_TR_SWAP) {
    const uint32_t x = o[1];
    o[1] = o[2];
    o[2] = x;
  }
}

template <bool S4>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if (S4)
    asm volatile(
        "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows r0 .. r0+rows of a (., kb) row-major int8 matrix into a shared
// tile of row stride kb + 16, in 16-byte copies.
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ g,
                                          int r0, int rows, int kb,
                                          int8_t* s) {
  const int per = kb / 16;
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int r = i / per, c = (i % per) * 16;
    *reinterpret_cast<uint4*>(s + r * (kb + 16) + c) =
        *reinterpret_cast<const uint4*>(g + size_t(r0 + r) * kb + c);
  }
}

// Columns c0 .. c0+cols of a (kb, ld) row-major int8 matrix into a shared
// tile [c][k] of row stride kb + 16: 4 x 4 byte blocks, transposed.
__device__ __forceinline__ void load_cols_transposed(
    const int8_t* __restrict__ g, int ld, int c0, int cols, int kb,
    int8_t* s) {
  const int per = cols / 4;
  for (int i = threadIdx.x; i < (kb / 4) * per; i += NT) {
    const int k4 = i / per, c4 = i % per;
    const int8_t* src = g + size_t(4 * k4) * ld + c0 + 4 * c4;
    uint32_t w[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = ld32(src + size_t(j) * ld);
    transpose4(w, o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(s + (4 * c4 + j) * (kb + 16) + 4 * k4) =
          o[j];
  }
}

// Four k bytes k .. k+3 of row m from a (kb, BM) tile of row stride st.
__device__ __forceinline__ uint32_t gather4(const int8_t* s, int st, int k,
                                            int m) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(s) + k * st + m;
  return uint32_t(p[0]) | (uint32_t(p[st]) << 8) |
         (uint32_t(p[2 * st]) << 16) | (uint32_t(p[3 * st]) << 24);
}

// One step's product of this warp: acc = A[wm0.., kb0..kb1) . B[wn0..].
template <class C, bool S4, bool A_TR>
__device__ __forceinline__ void step_product(
    const int8_t* sA, const int8_t* sB, int kb, int wm0, int wn0, int kb0,
    int kb1, int (&acc)[C::MT][C::NTL][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sk = kb + 16, sa = C::BM + 4;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;
  const int kend = (SVT_PROBE_DROP_LAST_K && kb1 == kb) ? kb1 - BK : kb1;
#pragma unroll 1
  for (int k0 = kb0; k0 < kend; k0 += BK) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int k = k0 + kk + 4 * t;
      uint32_t bf[C::NTL][2];
#pragma unroll
      for (int nt = 0; nt < C::NTL; ++nt) {
        const int8_t* bp = sB + (wn0 + nt * 8 + g) * sk + k;
        bf[nt][0] = ld32(bp);
        bf[nt][1] = ld32(bp + 16);
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        const int m = wm0 + mt * 16 + g;
        uint32_t af[4];
        if (A_TR) {
          af[0] = gather4(sA, sa, k, m);
          af[1] = gather4(sA, sa, k, m + 8);
          af[2] = gather4(sA, sa, k + 16, m);
          af[3] = gather4(sA, sa, k + 16, m + 8);
        } else {
          const int8_t* ap = sA + m * sk + k;
          af[0] = ld32(ap);
          af[1] = ld32(ap + 8 * sk);
          af[2] = ld32(ap + 16);
          af[3] = ld32(ap + 8 * sk + 16);
        }
#pragma unroll
        for (int nt = 0; nt < C::NTL; ++nt)
          mma<S4>(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }
}

// Sum over the block (every thread calls it); thread 0 gets the result.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

}  // namespace svtp
