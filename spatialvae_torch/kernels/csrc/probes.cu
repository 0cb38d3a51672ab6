// The int4 and narrow-accumulator probes for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of the two measurement tools:
//   tools/probe_int4.py   `make` (:88-111, pallas_call :101), `maket`
//                         (:130-156, :144), `kern_wi4` (:197-214, :205) and
//                         `make_tdw1` (:228-254, :242): one integer GEMM per
//                         grid step in each contraction pattern, int8 or
//                         cast to int4 -> `probe_gemm`;
//                         `buildT_kernel` (:169-192, :183): the feature-major
//                         first layer and its column sums -> `probe_build_t`;
//                         `kern_tr` (:265-277, :271): an in-kernel transpose
//                         consumed by a row sum -> `probe_transpose_sum`;
//   tools/probe_i16acc.py `kern` (:39-45, :47): an int4 GEMM whose
//                         accumulator is stored as int32, int16, bf16 or f32
//                         -> `probe_gemm` with a `STORE`.
//
// What each computes is the TPU kernel's function.  The TPU grid runs the
// same product at every step (its blocks never move) and every step writes
// the same output block, so the result is the last step's.  Here every step
// is computed in full too: a block of the grid (x: output column tile, y:
// output row tile, z: a group of consecutive steps) loads its operand tiles
// into shared memory once, as the TPU keeps them in VMEM, and runs its
// group's steps from there.  One block writes each output element: the
// block of the last group whose tile holds it, after the last step.  Every
// block folds every value of every step into a wrapping 32-bit sum that it
// stores in `sums` (one word per block), so no product is dead code and the
// host can hold the whole computation, not only the output rows, against
// the plain version (kernels/probes.py).
//
// `probe_gemm`: C = A . B over int8 values on the tensor cores with
// mma.sync m16n8k32 s8 x s8 -> s32 (exact), or the s4 arm: both operands
// packed two 4-bit values per byte along k (`probe_pack_s4`) and
// mma.sync m16n8k64 s4 x s4 -> s32.  Both arms read 32 bytes of k per
// instruction with the same fragment layout, so they share all code but the
// instruction.  ptxas takes the s4 instruction for sm_90a but emits no s4
// tensor-core opcode: each one becomes a call of a routine that unpacks the
// nibbles and runs two IMMA.16832.S8.S8 (the H100 runs no s4 MMA).  Layouts (the TPU's dimension numbers):
//   d10  A (M, K) rows, B (K, N): B is transposed into shared memory once,
//        as its tile is loaded (4 x 4 byte blocks through byte permutes);
//   d11  A (M, K), B (N, K): both already k-contiguous;
//   d00  A (K, M), B (K, N): A is transposed at every step (the TPU's
//        in-kernel swapaxes): its fragments are gathered byte by byte from
//        the tile as loaded; B as in d10.
// Two tile shapes: 128 x 128 (warps 4 x 2, each 32 x 64) while both
// operand tiles fit shared memory whole (k up to 768 bytes), else 64 x 32
// with the k range split over four warp groups (each 32 x 32) whose
// partial sums meet in shared memory for the output rows.  With a STORE
// (128 x 128 tiles only) each step writes its (BM, BN) accumulator tile to
// its own slice of a global workspace at the STORE's width (int16
// saturates; bf16 rounds the float32 value to nearest even), reads the tile
// back (each thread other elements than it wrote) and converts it to
// float32: the store and read that the accumulator's width decides.
//
// What bounds them on this card: the int8 tensor-core rate (the products
// are repeated from shared memory; device memory is read once per block).
// mma.sync reaches only part of that rate (wgmma is the way to all of it),
// and the d00 layout's byte gathers, the STORE's round trip and the split
// k of the small tiles cost shared-memory and memory bandwidth on top.
//
// `probe_build_t`: per (image, pixel) the column sum over h of
// round(127 * tanh((f0*x0 + f1*x1) + c)), in that op order without
// contraction, one thread per pixel, the image's fold in shared memory.
// Bound: the f32 work (the CUDA cores), no reuse to exploit.
//
// `probe_transpose_sum`: per step a (pt, 16) column slab of A is
// transposed through shared memory (4 x 4 byte blocks, byte permutes) and
// each of its 16 rows summed with dp4a.  Bound: the CUDA cores' integer
// work.
//
// Build-time switches that exist only for the faulty copies of
// `chip_smoke.py --limits probes`: -DSVT_PROBE_DROP_LAST_K=1 skips the
// last 64-byte k slab of every product, -DSVT_PROBE_I16_WRAP=1 stores the
// int16 accumulator with wrap-around instead of saturation, and
// -DSVT_PROBE_TR_SWAP=1 swaps two rows of every 4 x 4 byte transpose.  The
// library is built with all three at 0.

#include "probes.cuh"

namespace svtp {

template <int STORE>
struct StoreT;
template <> struct StoreT<I32> { using T = int; };
template <> struct StoreT<I16> { using T = int16_t; };
template <> struct StoreT<BF16> { using T = __nv_bfloat16; };
template <> struct StoreT<F32> { using T = float; };

template <int STORE>
__device__ __forceinline__ typename StoreT<STORE>::T narrow(int v) {
  if constexpr (STORE == I32) return v;
  else if constexpr (STORE == I16)
    return SVT_PROBE_I16_WRAP ? int16_t(v)
                              : int16_t(max(-32768, min(32767, v)));
  else if constexpr (STORE == BF16)
    return __float2bfloat16_rn(__int2float_rn(v));
  else return __int2float_rn(v);
}
__device__ __forceinline__ float widen(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float widen(int16_t v) { return float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }

template <class C, bool S4, bool A_TR, bool B_KN, int STORE>
__device__ __forceinline__ void gemm_body(
    const int8_t* __restrict__ A, const int8_t* __restrict__ B,
    float* __restrict__ out, int* __restrict__ sums, void* ws, int M, int N,
    int kb, int steps, int groups, int out_rows) {
  static_assert(STORE == NONE || C::KSPLIT == 1, "stores take whole tiles");
  extern __shared__ __align__(16) int8_t smem[];
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  int8_t* sA = smem;
  int8_t* sB = smem + a_bytes<C>(kb, A_TR);
  int* red = reinterpret_cast<int*>(sB + C::BN * (kb + 16));
  uint32_t* words = reinterpret_cast<uint32_t*>(
      red + (C::KSPLIT - 1) * C::BM * C::BN);
  if (A_TR) {      // the (kb, BM) column slab as it lies, row stride BM + 4
    const int per = C::BM / 4;
    for (int i = threadIdx.x; i < kb * per; i += NT) {
      const int r = i / per, c = (i % per) * 4;
      *reinterpret_cast<uint32_t*>(sA + r * (C::BM + 4) + c) =
          ld32(A + size_t(r) * M + m0 + c);
    }
  } else {
    load_rows(A, m0, C::BM, kb, sA);
  }
  if (B_KN) load_cols_transposed(B, N, n0, C::BN, kb, sB);
  else load_rows(B, n0, C::BN, kb, sB);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / (C::WARPS_M * C::WARPS_N);
  const int wmn = warp % (C::WARPS_M * C::WARPS_N);
  const int wm0 = (wmn / C::WARPS_N) * C::WM, wn0 = (wmn % C::WARPS_N) * C::WN;
  const int kq = kb / C::KSPLIT;
  const int s0 = int((long long)blockIdx.z * steps / groups);
  const int s1 = int((long long)(blockIdx.z + 1) * steps / groups);
  uint32_t chk = 0;
  int acc[C::MT][C::NTL][4];
#pragma unroll 1
  for (int s = s0; s < s1; ++s) {
    asm volatile("" ::: "memory");   // every step reads its operands anew
    step_product<C, S4, A_TR>(sA, sB, kb, wm0, wn0, wk * kq, (wk + 1) * kq,
                              acc);
    const bool write = s == steps - 1 && m0 < out_rows;
    if constexpr (STORE == NONE) {
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) chk += uint32_t(acc[mt][nt][c]);
      if (write) {      // block-uniform
        if (C::KSPLIT > 1) {
          if (wk > 0)
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int r = wm0 + mt * 16 + g + 8 * (c >> 1);
                  const int col = wn0 + nt * 8 + 2 * t + (c & 1);
                  red[((wk - 1) * C::BM + r) * C::BN + col] = acc[mt][nt][c];
                }
          __syncthreads();
        }
        if (wk == 0)
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int r = wm0 + mt * 16 + g + 8 * (c >> 1);
                const int col = wn0 + nt * 8 + 2 * t + (c & 1);
                int v = acc[mt][nt][c];
                for (int j = 0; j + 1 < C::KSPLIT; ++j)
                  v += red[(j * C::BM + r) * C::BN + col];
                if (m0 + r < out_rows)
                  out[size_t(m0 + r) * N + n0 + col] = widen(v);
              }
        if (C::KSPLIT > 1) __syncthreads();
      }
    } else {
      using T = typename StoreT<STORE>::T;
      T* slice = static_cast<T*>(ws) + size_t(s) * M * N;
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int r = m0 + wm0 + mt * 16 + g + 8 * (c >> 1);
            const int col = n0 + wn0 + nt * 8 + 2 * t + (c & 1);
            slice[size_t(r) * N + col] = narrow<STORE>(acc[mt][nt][c]);
          }
      __syncthreads();                // the tile is in the workspace
      for (int i = threadIdx.x; i < C::BM * C::BN; i += NT) {
        const int r = m0 + i / C::BN, col = n0 + i % C::BN;
        const float v = widen(slice[size_t(r) * N + col]);
        chk += uint32_t(__float2int_rn(v));
        if (write && r < out_rows) out[size_t(r) * N + col] = v;
      }
    }
  }
  const uint32_t total = block_sum(chk, words);
  if (threadIdx.x == 0)
    sums[(size_t(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
         blockIdx.x] = int(total);
}

}  // namespace svtp

// One kernel per instantiation, with C names: `chip_smoke.py` counts each
// one's IMMA instructions in the library's SASS by name.
#define SVT_PROBE_GEMM(NAME, CFG, S4, ATR, BKN, STORE)                       \
  extern "C" __global__ void __launch_bounds__(svtp::NT) NAME(               \
      const int8_t* A, const int8_t* B, float* out, int* sums, void* ws,     \
      int M, int N, int kb, int steps, int groups, int out_rows) {           \
    svtp::gemm_body<svtp::CFG, S4, ATR, BKN, svtp::STORE>(                   \
        A, B, out, sums, ws, M, N, kb, steps, groups, out_rows);             \
  }

SVT_PROBE_GEMM(probe_gemm_s8_d10_big, Big, false, false, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d11_big, Big, false, false, false, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d00_big, Big, false, true, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d10_small, Small, false, false, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d11_small, Small, false, false, false, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d00_small, Small, false, true, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d10_big, Big, true, false, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d11_big, Big, true, false, false, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d00_big, Big, true, true, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d10_small, Small, true, false, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d11_small, Small, true, false, false, NONE)
SVT_PROBE_GEMM(probe_gemm_s4_d00_small, Small, true, true, true, NONE)
SVT_PROBE_GEMM(probe_gemm_s8_d10_big_i32, Big, false, false, true, I32)
SVT_PROBE_GEMM(probe_gemm_s8_d10_big_i16, Big, false, false, true, I16)
SVT_PROBE_GEMM(probe_gemm_s8_d10_big_bf16, Big, false, false, true, BF16)
SVT_PROBE_GEMM(probe_gemm_s8_d10_big_f32, Big, false, false, true, F32)
SVT_PROBE_GEMM(probe_gemm_s4_d10_big_i32, Big, true, false, true, I32)
SVT_PROBE_GEMM(probe_gemm_s4_d10_big_i16, Big, true, false, true, I16)
SVT_PROBE_GEMM(probe_gemm_s4_d10_big_bf16, Big, true, false, true, BF16)
SVT_PROBE_GEMM(probe_gemm_s4_d10_big_f32, Big, true, false, true, F32)

// x (rows, cols) int8 -> two 4-bit values per byte along dimension kdim,
// the lower index in the low nibble (mma.sync's s4 order): kdim 1 gives
// (rows, cols/2), kdim 0 (rows/2, cols).
extern "C" __global__ void probe_pack_s4(const int8_t* __restrict__ x,
                                         uint8_t* __restrict__ out, int rows,
                                         int cols, int kdim) {
  const long long n = (long long)rows * cols / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long lo, hi;
    if (kdim == 1) {
      lo = 2 * i;
      hi = lo + 1;
    } else {
      const long long r = i / cols, c = i % cols;
      lo = 2 * r * cols + c;
      hi = lo + cols;
    }
    out[i] = uint8_t((x[lo] & 15) | ((x[hi] & 15) << 4));
  }
}

// xT (4, HW) f32 coordinates (rows 0, 1 used), foldT (B, H, 4) f32.  Block
// (pixel tile, image); `out` (pt) gets the column sums of the last image's
// last pt pixels, `sums` (B, HW / BUILD_PIX) each block's wrapping sum.
extern "C" __global__ void __launch_bounds__(svtp::BUILD_PIX)
    probe_build_t(const float* __restrict__ xT, const float* __restrict__ foldT,
                  int* __restrict__ out, int* __restrict__ sums, int B, int HW,
                  int H, int pt) {
  extern __shared__ __align__(16) float fold[];
  __shared__ uint32_t words[svtp::BUILD_PIX / 32];
  const int b = blockIdx.y, p = blockIdx.x * svtp::BUILD_PIX + threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(foldT + size_t(b) * H * 4);
  for (int h = threadIdx.x; h < H; h += svtp::BUILD_PIX)
    reinterpret_cast<float4*>(fold)[h] = src[h];
  __syncthreads();
  const float x0 = xT[p], x1 = xT[HW + p];
  int sum = 0;
  for (int h = 0; h < H; ++h) {
    const float4 f = reinterpret_cast<const float4*>(fold)[h];
    const float h0 =
        __fadd_rn(__fadd_rn(__fmul_rn(f.x, x0), __fmul_rn(f.y, x1)), f.z);
    sum += int(rintf(__fmul_rn(tanhf(h0), 127.f)));
  }
  if (b == B - 1 && p >= HW - pt) out[p - (HW - pt)] = sum;
  uint32_t v = uint32_t(sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) words[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < svtp::BUILD_PIX / 32; ++w) s += words[w];
    sums[size_t(b) * gridDim.x + blockIdx.x] = int(s);
  }
}

// A (pt, Hp) int8.  Block (column slab of TR_BH, 1, step group): per step
// the slab is transposed into `tr` (TR_BH, pt) and each row summed; `out`
// (Hp) gets the last step's sums, `sums` (groups, Hp / TR_BH) each block's
// wrapping sum over its steps.
extern "C" __global__ void __launch_bounds__(svtp::NT)
    probe_transpose_sum(const int8_t* __restrict__ A, int* __restrict__ out,
                        int* __restrict__ sums, int pt, int Hp, int steps,
                        int groups) {
  using namespace svtp;
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int SR = TR_BH + 4;        // the slab's row stride
  const int st = pt + 16;              // the transposed rows' stride
  int8_t* slab = smem;
  int8_t* tr = smem + align16(pt * SR);
  uint32_t* words = reinterpret_cast<uint32_t*>(tr + TR_BH * st);
  const int h0 = blockIdx.x * TR_BH;
  for (int i = threadIdx.x; i < pt * (TR_BH / 4); i += NT) {
    const int r = i / (TR_BH / 4), c = (i % (TR_BH / 4)) * 4;
    *reinterpret_cast<uint32_t*>(slab + r * SR + c) =
        ld32(A + size_t(r) * Hp + h0 + c);
  }
  __syncthreads();
  const int s0 = int((long long)blockIdx.z * steps / groups);
  const int s1 = int((long long)(blockIdx.z + 1) * steps / groups);
  const int row = threadIdx.x / 16, part = threadIdx.x % 16;
  uint32_t chk = 0;
#pragma unroll 1
  for (int s = s0; s < s1; ++s) {
    asm volatile("" ::: "memory");
    for (int i = threadIdx.x; i < (pt / 4) * (TR_BH / 4); i += NT) {
      const int p4 = i / (TR_BH / 4), c4 = i % (TR_BH / 4);
      uint32_t w[4], o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ld32(slab + (4 * p4 + j) * SR + 4 * c4);
      transpose4(w, o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(tr + (4 * c4 + j) * st + 4 * p4) = o[j];
    }
    __syncthreads();
    int v = 0;
    for (int j = part; j < pt / 4; j += 16)
      v = __dp4a(int(ld32(tr + row * st + 4 * j)), 0x01010101, v);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (part == 0) {
      chk += uint32_t(v);
      if (s == steps - 1) out[h0 + row] = v;
    }
    __syncthreads();                   // `tr` is rewritten next step
  }
  const uint32_t total = block_sum(chk, words);
  if (threadIdx.x == 0) sums[size_t(blockIdx.z) * gridDim.x + blockIdx.x] = int(total);
}

namespace {

using GemmFn = void (*)(const int8_t*, const int8_t*, float*, int*, void*, int,
                        int, int, int, int, int);
struct GemmEntry {
  int dims, s4, small, store;
  GemmFn fn;
  const char* name;
};
#define E(D, S4, SM, ST, NAME) {D, S4, SM, ST, NAME, #NAME}
const GemmEntry kGemms[] = {
    E(0, 0, 0, 0, probe_gemm_s8_d10_big), E(1, 0, 0, 0, probe_gemm_s8_d11_big),
    E(2, 0, 0, 0, probe_gemm_s8_d00_big),
    E(0, 0, 1, 0, probe_gemm_s8_d10_small),
    E(1, 0, 1, 0, probe_gemm_s8_d11_small),
    E(2, 0, 1, 0, probe_gemm_s8_d00_small),
    E(0, 1, 0, 0, probe_gemm_s4_d10_big), E(1, 1, 0, 0, probe_gemm_s4_d11_big),
    E(2, 1, 0, 0, probe_gemm_s4_d00_big),
    E(0, 1, 1, 0, probe_gemm_s4_d10_small),
    E(1, 1, 1, 0, probe_gemm_s4_d11_small),
    E(2, 1, 1, 0, probe_gemm_s4_d00_small),
    E(0, 0, 0, 1, probe_gemm_s8_d10_big_i32),
    E(0, 0, 0, 2, probe_gemm_s8_d10_big_i16),
    E(0, 0, 0, 3, probe_gemm_s8_d10_big_bf16),
    E(0, 0, 0, 4, probe_gemm_s8_d10_big_f32),
    E(0, 1, 0, 1, probe_gemm_s4_d10_big_i32),
    E(0, 1, 0, 2, probe_gemm_s4_d10_big_i16),
    E(0, 1, 0, 3, probe_gemm_s4_d10_big_bf16),
    E(0, 1, 0, 4, probe_gemm_s4_d10_big_f32),
};
#undef E

const GemmEntry* find_gemm(int dims, int s4, int small, int store) {
  for (const GemmEntry& e : kGemms)
    if (e.dims == dims && e.s4 == s4 && e.small == small && e.store == store)
      return &e;
  return nullptr;
}

}  // namespace

extern "C" {

// The kernel `svt_probe_gemm` launches for these arguments, or null.
const char* svt_probe_gemm_name(int dims, int s4, int small, int store) {
  const GemmEntry* e = find_gemm(dims, s4, small, store);
  return e ? e->name : nullptr;
}

// dims 0 (d10), 1 (d11), 2 (d00).  a, b int8 (packed for s4; kb is k in
// bytes): d10 a (M, kb) b (kb, N); d11 a (M, kb) b (N, kb); d00 a (kb, M)
// b (kb, N).  M, N multiples of the tile (128 x 128, or small: 64 x 32),
// kb a multiple of 64 (small: 256).  out f32 (out_rows, N); sums int32
// (groups, M / BM, N / BN); ws the store's (steps, M, N) workspace or null.
int svt_probe_gemm(const void* a, const void* b, void* out, void* sums,
                   void* ws, int M, int N, int kb, int dims, int s4,
                   int small, int store, int steps, int groups, int out_rows,
                   void* stream) {
  const GemmEntry* e = find_gemm(dims, s4, small, store);
  const int bm = small ? svtp::Small::BM : svtp::Big::BM;
  const int bn = small ? svtp::Small::BN : svtp::Big::BN;
  const int kq = small ? svtp::BK * svtp::Small::KSPLIT : svtp::BK;
  if (e == nullptr || M < bm || N < bn || M % bm || N % bn || kb < kq ||
      kb % kq || steps < 1 || groups < 1 || groups > steps ||
      groups > 65535 || out_rows < 1 || out_rows > M ||
      (store != 0) != (ws != nullptr) || a == nullptr || b == nullptr ||
      out == nullptr || sums == nullptr)
    return int(cudaErrorInvalidValue);
  const int smem = small ? svtp::gemm_smem<svtp::Small>(kb, dims == 2)
                         : svtp::gemm_smem<svtp::Big>(kb, dims == 2);
  if (smem > svtp::MAX_SMEM) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      e->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  e->fn<<<dim3(N / bn, M / bm, groups), svtp::NT, smem,
          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<float*>(out), static_cast<int*>(sums), ws, M, N, kb, steps,
      groups, out_rows);
  return int(cudaGetLastError());
}

int svt_probe_pack_s4(const void* x, void* out, int rows, int cols, int kdim,
                      void* stream) {
  if (x == nullptr || out == nullptr || rows < 1 || cols < 1 ||
      (kdim == 1 ? cols % 2 : rows % 2) || (kdim != 0 && kdim != 1))
    return int(cudaErrorInvalidValue);
  const long long n = (long long)rows * cols / 2;
  const int blocks = int(n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  probe_pack_s4<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<uint8_t*>(out), rows, cols,
      kdim);
  return int(cudaGetLastError());
}

// HW a multiple of BUILD_PIX, pt of HW's divisors no larger than HW.
int svt_probe_build_t(const void* xT, const void* foldT, void* out,
                      void* sums, int B, int HW, int H, int pt, void* stream) {
  const int smem = H * 16;
  if (xT == nullptr || foldT == nullptr || out == nullptr || sums == nullptr ||
      B < 1 || H < 1 || HW < svtp::BUILD_PIX || HW % svtp::BUILD_PIX ||
      pt < 1 || pt > HW || HW % pt || smem > svtp::MAX_SMEM)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      probe_build_t, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  probe_build_t<<<dim3(HW / svtp::BUILD_PIX, B), svtp::BUILD_PIX, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xT), static_cast<const float*>(foldT),
      static_cast<int*>(out), static_cast<int*>(sums), B, HW, H, pt);
  return int(cudaGetLastError());
}

// a (pt, Hp) int8, pt a multiple of 4, Hp of TR_BH; out int32 (Hp); sums
// int32 (groups, Hp / TR_BH).
int svt_probe_transpose_sum(const void* a, void* out, void* sums, int pt,
                            int Hp, int steps, int groups, void* stream) {
  using namespace svtp;
  const int smem =
      align16(pt * (TR_BH + 4)) + TR_BH * (pt + 16) + WARPS * 4;
  if (a == nullptr || out == nullptr || sums == nullptr || pt < 4 ||
      pt % 4 || Hp < TR_BH || Hp % TR_BH || steps < 1 || groups < 1 ||
      groups > steps || groups > 65535 || smem > MAX_SMEM)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      probe_transpose_sum, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  probe_transpose_sum<<<dim3(Hp / TR_BH, 1, groups), NT, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<int*>(out),
      static_cast<int*>(sums), pt, Hp, steps, groups);
  return int(cudaGetLastError());
}

}  // extern "C"
