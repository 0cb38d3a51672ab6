// The int8 kernel microbenchmark's chain and pipelined-forward kernels for
// Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of tools/kernel_bench.py that time the int8
// decoder's first layer ("the a0 chain": h0 = x0*f0 + x1*f1 + c, a0q =
// round(127 * tanh h0)) alone and beside a GEMM:
//   `gvpu_kernel`     (:183, pallas_call :197, run `gemm1+vpu`)   -> DEP
//   `vpuonly_kernel`  (:218, :227, run `vpu-only`)                -> CHAIN_ROWS
//   `givpu_kernel`    (:247, :260, run `gemm1+ivpu`)              -> IND_ROWS
//   `givpu2_kernel`   (:285, :300, run `gemm1+ivpu2`)             -> IND_SUMS
//   `vpu2_kernel`     (:325, :335, run `vpu-full`)                -> CHAIN_SUMS
// (`kb_chain`), and `fwdpipe_kernel` (:406 in `make_fwdpipe`, pallas_call
// :445, runs `fwd-pipe2`, `fwd-pipe4`) -> `kb_fwd_pipe<S>`.
//
// The TPU grid (B, HW / pt) runs its steps in order; step (i, j) works on
// image i and pixels j*pt .. (j+1)*pt.  Here a block takes a group of
// consecutive steps (kernels/kernel_bench.py `step_groups`, as the probe
// GEMMs do) and walks each step in 64-pixel sub-tiles with K4's tile code
// (int8_tile.cuh: 512 threads, the (64, Kp) int8 tile in shared memory, W1q
// streamed from L2 through the cp.async ring, mma.sync s8).  W1q (256 KB at
// H = 500) and the constant a0q tile (1 MB at pt = 2,048) do not fit shared
// memory beside the ring: the tile's rows are copied in per sub-tile.
//
// kb_chain: per sub-tile the chain writes a0q into a tile, every value of it
// folded into the block's wrapping 32-bit sum (`isums`), so no step's chain
// is dead code; the small outputs are the last step's, as the TPU's constant
// output block holds them after its grid:
//   DEP         chain -> tile -> acc = tile . W1q -> a1 = tanh(acc * (sw/127)
//               + b1) (sw/127 a division, as the TPU kernel writes it);
//               out_f = a1 rows 0..7; every a1 value summed in double in
//               `fsums` (each thread in its order, then the block in a fixed
//               order).
//   CHAIN_ROWS  chain alone; out_q = a0q rows 0..31.
//   IND_ROWS    acc = (the constant a0q tile's rows of the sub-tile) . W1q
//               and the chain, which does not feed it: out_f = acc rows
//               0..7, out_q = chain rows 0..31; acc folded into isums.
//   IND_SUMS    as IND_ROWS, out_s = the step's column sums of a0q (int32).
//   CHAIN_SUMS  chain alone, out_s as IND_SUMS.
// The block runs a sub-tile's chain and GEMM one after the other (barriers
// between), and its shared memory (the two tiles and the ring) leaves room
// for one block per SM, so an independent chain does not overlap the GEMM.
//
// kb_fwd_pipe<S>: K4's forward with f32 head weights and the a1 output,
// each block walking its steps' pixels in runs of S consecutive 64-pixel
// sub-tiles in the prototype's order: build(0); then for each t: gemm(t),
// build(t+1) into the other a0q buffer (double-buffered in shared memory),
// epilogue(t) (a1 in bf16, y).  The accumulator is not double-buffered as
// the prototype's VMEM one is: two (64, 512) int32 accumulators would take
// the 128 registers a thread has, so gemm(t+1) follows epilogue(t).
//
// What bounds them on this card: the int8 tensor-core rate of the GEMM
// runs (4.19e12 operations per call at B=2,048, HW=4,096, H=500: 2.12 ms)
// plus the chain's f32 work on the CUDA cores (about 7 operations per
// element, 0.44 ms); fwd-pipe's a1 output (8.39 GB, 2.50 ms of device
// memory).  Above H = 512 the WIDE instantiations keep the tiles in a
// per-block workspace and run 512-column chunks (int8_tile.cuh).

#include "int8_tile.cuh"

// A build-time switch that exists only for a faulty copy of `chip_smoke.py
// --limits kernel_bench`: -DSVT_KB_A1_NO_127=1 scales the accumulator by sw
// instead of sw/127 where a1 is formed.  The library is built with it at 0.
#ifndef SVT_KB_A1_NO_127
#define SVT_KB_A1_NO_127 0
#endif

namespace {

using namespace svt8;

enum ChainMode { DEP = 0, CHAIN_ROWS = 1, IND_ROWS = 2, IND_SUMS = 3,
                 CHAIN_SUMS = 4 };
constexpr int OUT_F_ROWS = 8;
constexpr int OUT_Q_ROWS = 32;

__host__ __device__ constexpr bool has_gemm(int m) {
  return m == DEP || m == IND_ROWS || m == IND_SUMS;
}
__host__ __device__ constexpr bool has_rows(int m) {
  return m == CHAIN_ROWS || m == IND_ROWS;
}
__host__ __device__ constexpr bool has_sums(int m) {
  return m == IND_SUMS || m == CHAIN_SUMS;
}

// The chain of pixels p0 .. p0+63 of image b into `tile` (row stride as):
// q = round(127 * tanh((x0*w0 + x1*w1) + c)), thread k owning column k
// (WIDE: k, k + NT, ...), zero past H; every q added to isum.  `rows`
// (pixels 0..31 of the step, or null) gets q at [p][k]; `cols` (or null)
// adds this sub-tile's column sums to [k].
template <bool WIDE>
__device__ __forceinline__ void chain_tile(
    const float* __restrict__ fold, const float* __restrict__ coords, int b,
    int p0, int HW, int H, int8_t* tile, int as, uint32_t& isum,
    int8_t* __restrict__ rows, int* __restrict__ cols) {
  for (int k = threadIdx.x; k < padded_k(H); k += NT) {
    const bool on = k < H;
    const float* f = fold + size_t(b) * 4 * H;
    const float w0 = on ? f[k] : 0.f;
    const float w1 = on ? f[H + k] : 0.f;
    const float c = on ? f[2 * H + k] : 0.f;
    int col = 0;
#pragma unroll 4
    for (int p = 0; p < PT; ++p) {
      const int pix = p0 + p;
      int q = 0;
      if (on && pix < HW) {
        const float a0 = tanhf(first_h0(coords[2 * pix], coords[2 * pix + 1],
                                        w0, w1, c));
        q = int(fminf(fmaxf(qround(__fmul_rn(a0, 127.f)), -127.f), 127.f));
      }
      tile[p * as + k] = static_cast<int8_t>(q);
      isum += uint32_t(q);
      col += q;
      if (rows != nullptr && on && p < OUT_Q_ROWS) rows[p * H + k] = int8_t(q);
    }
    if (cols != nullptr && on) cols[k] += col;
    if (!WIDE) break;
  }
}

// Fixed-order block sums (every thread calls them) through `red` (WARPS
// words); thread 0 gets the result.
__device__ __forceinline__ uint32_t block_sum_u32(uint32_t v, uint32_t* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}
__device__ __forceinline__ double block_sum_f64(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// Grid: one block per step group; steps s0 .. s1-1 of group blockIdx.x.
// aq: the constant a0q tile (pt, Kp) int8, zero-padded (IND modes).
// out_f (8, H) f32, out_q (32, H) int8, out_s (H) int32: the last step's.
template <int MODE, bool WIDE>
__global__ void __launch_bounds__(NT, 1)
kb_chain_kernel(const float* __restrict__ fold,
                const float* __restrict__ coords,
                const int8_t* __restrict__ w1qT, const float* __restrict__ sw,
                const float* __restrict__ b1, const int8_t* __restrict__ aq,
                float* __restrict__ out_f, int8_t* __restrict__ out_q,
                int* __restrict__ out_s, int* __restrict__ isums,
                double* __restrict__ fsums, int8_t* __restrict__ ws, int HW,
                int H, int pt, int steps, int groups) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Kp = padded_k(H);
  const int tiles = HW / pt;
  const int s0 = int((long long)blockIdx.x * steps / groups);
  const int s1 = int((long long)(blockIdx.x + 1) * steps / groups);
  // DEP: h1 = acc * (sw / 127) + b1, the TPU kernel's division
  const float scale = SVT_KB_A1_NO_127 ? *sw : __fdiv_rn(*sw, 127.f);
  uint32_t isum = 0;
  double fsum = 0.0;
  for (int s = s0; s < s1; ++s) {
    const bool last = s == steps - 1;
    const int b = s / tiles;
    if (last && has_sums(MODE))
      for (int k = tid; k < H; k += NT) out_s[k] = 0;
    for (int u = 0; u < pt / PT; ++u) {
      const int p0 = (s % tiles) * pt + u * PT;
      // the chain: DEP feeds the GEMM from sm.tile, the others write sm.q
      int8_t* rows = has_rows(MODE) && last && u == 0 ? out_q : nullptr;
      int* cols = has_sums(MODE) && last ? out_s : nullptr;
      chain_tile<WIDE>(fold, coords, b, p0, HW, H,
                       MODE == DEP ? sm.tile : sm.q, sm.as, isum, rows, cols);
      if constexpr (has_gemm(MODE)) {
        if constexpr (MODE != DEP) {   // the constant tile's rows, as loaded
          const int per = Kp / 16;
          for (int i = tid; i < PT * per; i += NT) {
            const int r = i / per, c = (i % per) * 16;
            *reinterpret_cast<uint4*>(sm.tile + r * sm.as + c) =
                *reinterpret_cast<const uint4*>(aq + size_t(u * PT + r) * Kp +
                                                c);
          }
        }
        for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
          int acc[MTILES][NTILES][4];
          tile_gemm_s8<WIDE>(sm.tile, sm.ring, w1qT, Kp, acc, sm.as, n0);
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = n0 + frag_col(warp, t, nt, c);
              if (n >= H) continue;
              const float bn = MODE == DEP ? b1[n] : 0.f;
#pragma unroll
              for (int mt = 0; mt < MTILES; ++mt) {
                const int r = frag_row(g, mt, c);
                float v;
                if constexpr (MODE == DEP) {
                  v = tanhf(__fadd_rn(__fmul_rn(float(acc[mt][nt][c]), scale),
                                      bn));
                  fsum += double(v);
                } else {
                  v = float(acc[mt][nt][c]);
                  isum += uint32_t(acc[mt][nt][c]);
                }
                if (last && u == 0 && r < OUT_F_ROWS) out_f[r * H + n] = v;
              }
            }
        }
      }
    }
  }
  __syncthreads();                    // the ring is free for the sums
  const uint32_t it =
      block_sum_u32(isum, reinterpret_cast<uint32_t*>(sm.ring));
  const double ft =
      block_sum_f64(fsum, reinterpret_cast<double*>(sm.ring) + WARPS);
  if (tid == 0) {
    isums[blockIdx.x] = int(it);
    fsums[blockIdx.x] = ft;
  }
}

// kb_fwd_pipe<S>: grid one block per step group; the group's pixels in
// runs of S 64-pixel sub-tiles.  wht (No, H) f32, y (B, No, HW) f32, a1
// (B, HW, H) bf16.
template <int S, bool WIDE>
__global__ void __launch_bounds__(NT, 1)
kb_fwd_pipe_kernel(const float* __restrict__ fold,
                   const float* __restrict__ coords,
                   const int8_t* __restrict__ w1qT,
                   const float* __restrict__ sw, const float* __restrict__ b1,
                   const float* __restrict__ wht,
                   const float* __restrict__ bht, float* __restrict__ y,
                   __nv_bfloat16* __restrict__ a1_out, int8_t* __restrict__ ws,
                   int HW, int H, int No, int pt, int steps, int groups) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  int8_t* buf[2] = {sm.tile, sm.q};
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Kp = padded_k(H);
  const int s0 = int((long long)blockIdx.x * steps / groups);
  const int s1 = int((long long)(blockIdx.x + 1) * steps / groups);
  const float scale = SVT_KB_A1_NO_127 ? *sw : __fmul_rn(*sw, 1.f / 127.f);
  // the group's 64-pixel sub-tiles in order (a sub-tile never straddles two
  // images: pt is a multiple of 64), in runs of S
  const long long u_first = (long long)s0 * (pt / PT);
  const int subs = (s1 - s0) * (pt / PT);
  auto at = [&](int u, int& b, int& p0) {
    const long long pix = (u_first + u) * PT;
    b = int(pix / HW);
    p0 = int(pix % HW);
  };
  for (int u0 = 0; u0 < subs; u0 += S) {
    const int run = subs - u0 < S ? subs - u0 : S;
    int b, p0;
    at(u0, b, p0);
    first_layer_q<127, WIDE>(fold, coords, b, p0, HW, H, buf[0], sm.as);
    for (int st = 0; st < run; ++st) {
      at(u0 + st, b, p0);
      float z = 0.f;
      for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
        int acc[MTILES][NTILES][4];
        tile_gemm_s8<WIDE>(buf[st & 1], sm.ring, w1qT, Kp, acc, sm.as, n0);
        if (n0 == 0 && st + 1 < run) {     // the next sub-tile's chain
          int bn, pn;
          at(u0 + st + 1, bn, pn);
          first_layer_q<127, WIDE>(fold, coords, bn, pn, HW, H,
                                   buf[(st + 1) & 1], sm.as);
        }
        float a1[MTILES][NTILES][4];
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + frag_col(warp, t, nt, c);
            const bool on = n < H;
            const float bn = on ? b1[n] : 0.f;
#pragma unroll
            for (int mt = 0; mt < MTILES; ++mt) {
              const int pix = p0 + frag_row(g, mt, c);
              float v = 0.f;
              if (on && pix < HW) {
                v = tanhf(__fadd_rn(__fmul_rn(float(acc[mt][nt][c]), scale),
                                    bn));
                a1_out[(size_t(b) * HW + pix) * H + n] =
                    __float2bfloat16_rn(v);
              }
              a1[mt][nt][c] = v;
            }
          }
        z += head_dot(a1, wht, H, No, reinterpret_cast<float*>(sm.ring), n0);
      }
      if (tid < No * PT) {
        const int o = tid / PT, pix = p0 + tid % PT;
        if (pix < HW)
          y[(size_t(b) * No + o) * HW + pix] =
              1.f / (1.f + expf(-__fadd_rn(z, bht[o])));
      }
    }
  }
}

bool bad_steps(int B, int HW, int H, int pt, int unit, int groups) {
  const long long steps = (long long)B * (HW / (pt > 0 ? pt : 1));
  return B < 1 || H < 1 || pt < unit || pt % unit || HW < pt || HW % pt ||
         groups < 1 || groups > steps || groups > 65535 ||
         steps > 2147483647LL;
}

}  // namespace

extern "C" {

// mode: ChainMode.  fold (B,4,H), coords (HW,2), sw (1), b1 (H) f32;
// w1qT (Kp,Kp) int8 rows of W1q^T; aq (pt,Kp) int8 or null; out_f (8,H),
// out_q (32,H), out_s (H) as the mode writes them (else null); isums int32
// and fsums f64 (groups).  For H > 512, ws holds groups *
// svt_int8_ws_block(H) bytes.
int svt_kb_chain(int mode, const void* fold, const void* coords,
                 const void* w1qT, const void* sw, const void* b1,
                 const void* aq, void* out_f, void* out_q, void* out_s,
                 void* isums, void* fsums, void* ws, int B, int HW, int H,
                 int pt, int groups, void* stream) {
  const bool wide = H > MAX_H;
  if (bad_steps(B, HW, H, pt, PT, groups) || mode < DEP ||
      mode > CHAIN_SUMS || (has_gemm(mode) && (w1qT == nullptr ||
                                               out_f == nullptr)) ||
      (mode == DEP && (sw == nullptr || b1 == nullptr)) ||
      (has_gemm(mode) && mode != DEP && aq == nullptr) ||
      (has_rows(mode) && out_q == nullptr) ||
      (has_sums(mode) && out_s == nullptr) || isums == nullptr ||
      fsums == nullptr || (wide && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int steps = B * (HW / pt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const int8_t*>(w1qT);
  const auto* s = static_cast<const float*>(sw);
  const auto* bb = static_cast<const float*>(b1);
  const auto* a = static_cast<const int8_t*>(aq);
  auto* of = static_cast<float*>(out_f);
  auto* oq = static_cast<int8_t*>(out_q);
  auto* os = static_cast<int*>(out_s);
  auto* is = static_cast<int*>(isums);
  auto* fs = static_cast<double*>(fsums);
  auto* wsb = static_cast<int8_t*>(ws);
#define SVT_CHAIN(M, WD)                                                    \
  do {                                                                      \
    auto k = kb_chain_kernel<M, WD>;                                        \
    const int smem = WD ? SMEM_WIDE : SMEM;                                 \
    cudaError_t err = allow_smem(k, smem);                                  \
    if (err != cudaSuccess) return int(err);                                \
    k<<<groups, NT, smem, st>>>(f, c, w, s, bb, a, of, oq, os, is, fs, wsb, \
                                HW, H, pt, steps, groups);                  \
  } while (0)
#define SVT_CHAIN_W(M)                                                      \
  do {                                                                      \
    if (wide) SVT_CHAIN(M, true); else SVT_CHAIN(M, false);                 \
  } while (0)
  switch (mode) {
    case DEP: SVT_CHAIN_W(DEP); break;
    case CHAIN_ROWS: SVT_CHAIN_W(CHAIN_ROWS); break;
    case IND_ROWS: SVT_CHAIN_W(IND_ROWS); break;
    case IND_SUMS: SVT_CHAIN_W(IND_SUMS); break;
    default: SVT_CHAIN_W(CHAIN_SUMS); break;
  }
#undef SVT_CHAIN_W
#undef SVT_CHAIN
  return int(cudaGetLastError());
}

// S in {2, 4}.  fold (B,4,H), coords (HW,2), sw (1), b1 (H), wht (No,H),
// bht (No) f32; w1qT (Kp,Kp) int8; y (B,No,HW) f32; a1 (B,HW,H) bf16; pt a
// multiple of 64 dividing HW.  For H > 512, ws holds groups *
// svt_int8_ws_block(H) bytes.
int svt_kb_fwd_pipe(int S, const void* fold, const void* coords,
                    const void* w1qT, const void* sw, const void* b1,
                    const void* wht, const void* bht, void* y, void* a1,
                    void* ws, int B, int HW, int H, int No, int pt,
                    int groups, void* stream) {
  const bool wide = H > MAX_H;
  if ((S != 2 && S != 4) || bad_steps(B, HW, H, pt, PT, groups) ||
      No < 1 || No > MAX_NO || y == nullptr || a1 == nullptr ||
      (wide && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int steps = B * (HW / pt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_PIPE(SS, WD)                                                    \
  do {                                                                      \
    auto k = kb_fwd_pipe_kernel<SS, WD>;                                    \
    const int smem = WD ? SMEM_WIDE : SMEM;                                 \
    cudaError_t err = allow_smem(k, smem);                                  \
    if (err != cudaSuccess) return int(err);                                \
    k<<<groups, NT, smem, st>>>(                                            \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1qT), static_cast<const float*>(sw),    \
        static_cast<const float*>(b1), static_cast<const float*>(wht),      \
        static_cast<const float*>(bht), static_cast<float*>(y),             \
        static_cast<__nv_bfloat16*>(a1), static_cast<int8_t*>(ws), HW, H,   \
        No, pt, steps, groups);                                             \
  } while (0)
  if (S == 2) {
    if (wide) SVT_PIPE(2, true); else SVT_PIPE(2, false);
  } else {
    if (wide) SVT_PIPE(4, true); else SVT_PIPE(4, false);
  }
#undef SVT_PIPE
  return int(cudaGetLastError());
}

}  // extern "C"
