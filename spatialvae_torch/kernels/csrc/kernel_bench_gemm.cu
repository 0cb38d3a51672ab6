// The int8 kernel microbenchmark's multi-product GEMMs for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of tools/kernel_bench.py that time the
// backward's and the fused loss kernel's products alone, on constant tiles:
//   `gemm2_kernel` (:156, pallas_call :166, run `gemm2`): per grid step
//     dW = a0q^T . gq (H, H) and dA = gq . W1q^T (pt, H), int32;
//   `gemm3_kernel` (:496, :510, run `gemm3`): h1 = a0q . W1q too;
// each writing the int32 sum of the products' first 8 rows as float32.
// (`gemm1_kernel`, one product, is the probe GEMM of probes.cu.)
//
// `kb_gemm_multi`: one launch runs every product of every step.  blockIdx.x
// enumerates the output tiles of all the products (each product's tiles in
// turn), blockIdx.z a group of consecutive steps, as probe_gemm's grid does;
// a block loads its product's operand tiles into shared memory once (the
// TPU's VMEM) and runs its group's steps from there with probes.cuh's
// `step_product`: h1 in the (1,0) layout (W1q transposed as its tile is
// loaded), dW in (0,0) (a0q gathered transposed at every step, the TPU's
// in-kernel transpose), dA in (1,1) (both k-contiguous).  Each product takes
// probe_gemm's tile for its k (128 x 128, or 64 x 32 with the k range split
// four ways when k passes 768 bytes: dW's k is pt).  Every block folds every
// accumulator value of every step into a wrapping 32-bit sum (`sums`), and
// the last step's blocks of row tile 0 write their product's rows 0..7 as
// int32 to `rows` (P, 8, Np); `kb_rows_sum` adds the products' rows (int32,
// wrapping, as the TPU adds them) and converts to float32.
//
// What bounds it on this card: the int8 tensor-core rate, 2 * pt * H * H
// operations per product and step (4.19e12 per product at B=2,048,
// HW=4,096, pt=2,048, H=500: 2.12 ms each); device memory is read once per
// block.

#include "probes.cuh"

namespace {

using namespace svtp;

constexpr int MAX_PRODS = 3;
constexpr int OUT_ROWS = 8;

// One product: A, B zero-padded in the layout of `code` (0: d10 A (M, kb),
// B (kb, N); 1: d11 A (M, kb), B (N, kb); 2: d00 A (kb, M), B (kb, N)), its
// tile shape (`small`), its first block, its tiles along N and its rows'
// slice of `rows` (row stride ld).
struct Prod {
  const int8_t* A;
  const int8_t* B;
  int* rows;
  int M, N, kb, code, small, first, tiles_n, ld;
};
struct Prods {
  Prod p[MAX_PRODS];
  int n;
};

template <class C, bool A_TR, bool B_KN>
__device__ __forceinline__ uint32_t multi_body(const Prod& pr, int tile,
                                               int steps, int groups,
                                               int8_t* smem) {
  const int kb = pr.kb, M = pr.M, N = pr.N;
  const int m0 = (tile / pr.tiles_n) * C::BM, n0 = (tile % pr.tiles_n) * C::BN;
  int8_t* sA = smem;
  int8_t* sB = smem + a_bytes<C>(kb, A_TR);
  int* red = reinterpret_cast<int*>(sB + C::BN * (kb + 16));
  if (A_TR) {      // the (kb, BM) column slab as it lies, row stride BM + 4
    const int per = C::BM / 4;
    for (int i = threadIdx.x; i < kb * per; i += NT) {
      const int r = i / per, c = (i % per) * 4;
      *reinterpret_cast<uint32_t*>(sA + r * (C::BM + 4) + c) =
          ld32(pr.A + size_t(r) * M + m0 + c);
    }
  } else {
    load_rows(pr.A, m0, C::BM, kb, sA);
  }
  if (B_KN) load_cols_transposed(pr.B, N, n0, C::BN, kb, sB);
  else load_rows(pr.B, n0, C::BN, kb, sB);
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
    step_product<C, false, A_TR>(sA, sB, kb, wm0, wn0, wk * kq,
                                 (wk + 1) * kq, acc);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NTL; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) chk += uint32_t(acc[mt][nt][c]);
    if (s == steps - 1 && m0 < OUT_ROWS) {      // block-uniform
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
              if (m0 + r < OUT_ROWS) pr.rows[r * pr.ld + n0 + col] = v;
            }
      if (C::KSPLIT > 1) __syncthreads();
    }
  }
  return chk;
}

__global__ void __launch_bounds__(NT)
kb_gemm_multi_kernel(const Prods ps, int* __restrict__ sums, int steps,
                     int groups) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ uint32_t words[WARPS];
  int i = 0;
  while (i + 1 < ps.n && int(blockIdx.x) >= ps.p[i + 1].first) ++i;
  const Prod& pr = ps.p[i];
  const int tile = blockIdx.x - pr.first;
  uint32_t chk;
  // code * 2 + small: the layout's operand loads and the tile
#define SVT_BODY(C, ATR, BKN) \
  multi_body<C, ATR, BKN>(pr, tile, steps, groups, smem)
  switch (pr.code * 2 + pr.small) {
    case 0: chk = SVT_BODY(Big, false, true); break;
    case 1: chk = SVT_BODY(Small, false, true); break;
    case 2: chk = SVT_BODY(Big, false, false); break;
    case 3: chk = SVT_BODY(Small, false, false); break;
    case 4: chk = SVT_BODY(Big, true, true); break;
    default: chk = SVT_BODY(Small, true, true); break;
  }
#undef SVT_BODY
  const uint32_t total = block_sum(chk, words);
  if (threadIdx.x == 0)
    sums[size_t(blockIdx.z) * gridDim.x + blockIdx.x] = int(total);
}

// out[r][c] = float(sum_p rows[p][r][c]) for r < 8, c < n_out.
__global__ void kb_rows_sum_kernel(const int* __restrict__ rows,
                                   float* __restrict__ out, int P, int Np,
                                   int n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= OUT_ROWS * n_out) return;
  const int r = i / n_out, c = i % n_out;
  uint32_t s = 0;
  for (int p = 0; p < P; ++p)
    s += uint32_t(rows[(p * OUT_ROWS + r) * Np + c]);
  out[i] = __int2float_rn(int(s));
}

}  // namespace

extern "C" {

// n products (2 or 3), each given by its padded operands a[i], b[i] (int8),
// M[i], N[i] (multiples of its tile), kb[i] (a multiple of 64, of 256 when
// small), code[i] (0 d10, 1 d11, 2 d00), small[i]; rows int32 (n, 8, Np)
// with Np >= every N[i]; sums int32 (groups, total tiles).
int svt_kb_gemm_multi(int n, const void* const* a, const void* const* b,
                      const int* M, const int* N, const int* kb,
                      const int* code, const int* small, void* rows, int Np,
                      void* sums, int steps, int groups, void* stream) {
  if (n < 1 || n > MAX_PRODS || rows == nullptr || sums == nullptr ||
      steps < 1 || groups < 1 || groups > steps || groups > 65535)
    return int(cudaErrorInvalidValue);
  Prods ps{};
  ps.n = n;
  int total = 0, smem = 0;
  for (int i = 0; i < n; ++i) {
    const bool sm = small[i] != 0;
    const int bm = sm ? Small::BM : Big::BM, bn = sm ? Small::BN : Big::BN;
    const int kq = sm ? BK * Small::KSPLIT : BK;
    if (a[i] == nullptr || b[i] == nullptr || code[i] < 0 || code[i] > 2 ||
        M[i] < OUT_ROWS || M[i] % bm || N[i] < bn || N[i] % bn ||
        N[i] > Np || kb[i] < kq || kb[i] % kq)
      return int(cudaErrorInvalidValue);
    ps.p[i] = Prod{static_cast<const int8_t*>(a[i]),
                   static_cast<const int8_t*>(b[i]),
                   static_cast<int*>(rows) + size_t(i) * OUT_ROWS * Np,
                   M[i], N[i], kb[i], code[i], int(sm), total, N[i] / bn, Np};
    total += (M[i] / bm) * (N[i] / bn);
    const int s = sm ? gemm_smem<Small>(kb[i], code[i] == 2)
                     : gemm_smem<Big>(kb[i], code[i] == 2);
    smem = s > smem ? s : smem;
  }
  if (smem > MAX_SMEM) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kb_gemm_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kb_gemm_multi_kernel<<<dim3(total, 1, groups), NT, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      ps, static_cast<int*>(sums), steps, groups);
  return int(cudaGetLastError());
}

int svt_kb_rows_sum(const void* rows, void* out, int n, int Np, int n_out,
                    void* stream) {
  if (rows == nullptr || out == nullptr || n < 1 || n_out < 1 || n_out > Np)
    return int(cudaErrorInvalidValue);
  const int total = OUT_ROWS * n_out;
  kb_rows_sum_kernel<<<(total + 255) / 256, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<float*>(out), n, Np, n_out);
  return int(cudaGetLastError());
}

}  // extern "C"
