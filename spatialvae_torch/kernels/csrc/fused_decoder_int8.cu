// The int8 decoder tail for Hopper (sm_90a): forward K4 and backward K5, and
// the split-K grouped dW1 kernel that K3 shares.
//
// Replaces the Pallas TPU kernels spatialvae_tpu/kernels/fused_decoder_int8.py
// `_fwd_kernel` (:60, through `_fwd_pallas` :197) and `_bwd_kernel` (:95,
// through `_bwd_pallas` :232 and the custom VJP `fused_decoder_tail_int8`
// :292), for the 2-layer decoder (one hidden (H, H) layer).  Per (image b,
// pixel p), with W1q, sw the per-tensor int8 copy of w1:
//
//   a0q = round(127 * tanh(x0*w0 + x1*w1 + c))          int8
//   h1  = (a0q @ W1q) * (sw/127) + b1                   int32 sums, exact
//   a1  = tanh(h1);  y = sigmoid(cast(a1) . wht^T + bht) f32 sums
//
// and the backward per quantisation group (one image x Pt pixels, Pt =
// pick_tile(HW): 2048 at the galaxy shape):
//
//   dz2 = g*y*(1-y);  dh1 = (cast(dz2)^T . wht) * (1 - a1^2)
//   sg  = max|dh1| over the group / 127 + 1e-30;  dh1q = clip(round(dh1/sg))
//   dW1 += (a0q^T . dh1q) * sg/127;  db1 += sum dh1 (unquantised)
//   da0 = (dh1q . W1q^T) * sg*sw;    dh0 = da0 * (1 - a0^2), exact a0
//   dfold[b] += (sum x0*dh0, sum x1*dh0, sum dh0, 0);  dWh^T, dbh from dz2
//
// a1 is the forward's bf16 residual, or rebuilt in f32 as the forward built
// it (RECOMPUTE), so the two variants differ as the TPU's do.
//
// What bounds it on this card: the three int8 GEMMs (forward, da0, dW1; a
// fourth with recompute) of 2*HW*H^2 = 2.05 G int8 ops per image each, 205
// G at the galaxy shape B=100: ~0.1 ms each at the 1,979 TOP/s int8 peak,
// against the 410 MB bf16 a1 residual (0.12 ms of HBM at 3.35 TB/s) when
// it is written and read.  The design follows what the TPU's sequential
// grid did and CUDA blocks cannot:
//   - The gradient scale is a max over a whole group (2048 x H values), and
//     a block owns 64 pixels.  So the backward runs in two passes over the
//     group's blocks: `bwd_scale` writes each block's max |dh1|; `bwd_grad`
//     rebuilds dh1 (one more int8 GEMM with recompute, a second read of
//     the residual otherwise), takes the group's max of those maxima, and
//     quantises with exactly the TPU's grouping.  A smaller group would
//     change the numbers, not only the speed.
//   - dW1 is a sum over groups of an exact int32 product, each scaled by
//     its own float sg/127: `bwd_grad` writes a0q and dh1q to feature-major
//     int8 workspaces (205 MB each at B=100), and `grouped_dw` runs a
//     split-K int8 GEMM that walks the groups, turning each group's int32
//     tile into f32 with its scale before the next group starts.
//   - Every cross-block sum (dW1 splits, dfold per image, db1, dWh^T, dbh)
//     is a per-block partial reduced by svt_sum_rows in a fixed order: no
//     atomics, bit-identical gradients from run to run.
// The int8 products run on mma.sync m16n8k32 (int8_tile.cuh); wgmma, TMA
// and keeping dh1q on chip are later work.  Above H = 512 the `WIDE`
// instantiations keep the block's two int8 tiles in a workspace in global
// memory and loop every GEMM and epilogue over 512-column chunks
// (int8_tile.cuh); the groups, and so the numbers, are the same.  K5's two
// passes live in fused_decoder_int8.cuh, which kernel_bench_bwd.cu also
// compiles in the microbenchmark's modes.

#include "fused_decoder_int8.cuh"

namespace {

using namespace svt8;

// ---- K4: forward, y and optionally the bf16 a1 residual
template <bool BF16, bool EMIT, bool WIDE>
__global__ void __launch_bounds__(NT, 1)
int8_fwd_kernel(const float* __restrict__ fold,
                const float* __restrict__ coords,
                const int8_t* __restrict__ w1qT, const float* __restrict__ sw,
                const float* __restrict__ b1, const float* __restrict__ wht,
                const float* __restrict__ bht, float* __restrict__ y,
                __nv_bfloat16* __restrict__ a1_out, int8_t* __restrict__ ws,
                int HW, int H, int No, int blocks) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve<WIDE>(smem4, ws, padded_k(H));
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / blocks;
  const int p0 = (blockIdx.x % blocks) * PT;

  first_layer_q<127, WIDE>(fold, coords, b, p0, HW, H, sm.tile, sm.as);
  float z = 0.f;
  for (int n0 = 0; n0 < chunk_end<WIDE>(H); n0 += MAX_H) {
    float a1[MTILES][NTILES][4];
    int8_a1<true, WIDE>(sm, w1qT, *sw, b1, nullptr, b, p0, HW, H, n0, a1);
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + frag_col(warp, t, nt, c);
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const int pix = p0 + frag_row(g, mt, c);
          if (EMIT && n < H && pix < HW)
            a1_out[(size_t(b) * HW + pix) * H + n] =
                __float2bfloat16_rn(a1[mt][nt][c]);
          a1[mt][nt][c] = operand<BF16>(a1[mt][nt][c]);
        }
      }
    const float zc =
        head_dot(a1, wht, H, No, reinterpret_cast<float*>(sm.ring), n0);
    z = WIDE ? z + zc : zc;
  }
  if (tid < No * PT) {
    const int o = tid / PT, pix = p0 + tid % PT;
    if (pix < HW)
      y[(size_t(b) * No + o) * HW + pix] =
          1.f / (1.f + expf(-__fadd_rn(z, bht[o])));
  }
}

// ---- split-K dW1 over quantisation groups, shared by K3 and K5.
//   aq_ws, q_ws: (nimg, Kp, HWp) int8, feature-major; group gi = image
//   gi / gpi, pixels (gi % gpi)*Pt .. +Pt (rounded up to 64: zeros past
//   HW).  blockIdx.x: (128, 128) tile of dW1; blockIdx.y: split s over
//   groups gps*s .. gps*(s+1)-1.  Each group's exact int32 tile times
//   gscale[gi] is added to the f32 sum before the next group starts; the
//   split's sum goes to part[s] (H, H).
constexpr int DW_T = 128;         // dW tile edge
constexpr int DW_NT = 256;        // threads: 8 warps as 2 (i) x 4 (j)
constexpr int DW_SLAB = DW_T * SLAB_S;
constexpr int DW_SMEM = STAGES * 2 * DW_SLAB;

__global__ void __launch_bounds__(DW_NT, 1)
grouped_dw_kernel(const int8_t* __restrict__ aq_ws,
                  const int8_t* __restrict__ q_ws,
                  const float* __restrict__ gscale, float* __restrict__ part,
                  int nimg, int HWp, int H, int Pt, int gpi, int gps) {
  extern __shared__ float4 dw_smem4[];
  int8_t* sm = reinterpret_cast<int8_t*>(dw_smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int Kp = padded_k(H);
  const int tiles_j = (Kp + DW_T - 1) / DW_T;
  const int i0 = (blockIdx.x / tiles_j) * DW_T;
  const int j0 = (blockIdx.x % tiles_j) * DW_T;
  const int G = nimg * gpi;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(G, g0 + gps);
  const int spg = (Pt + PT - 1) / PT;          // 64-pixel slabs per group
  const int total = max(0, g1 - g0) * spg;

  auto fill = [&](int idx) {
    if (idx < total) {
      const int gi = g0 + idx / spg;
      const int bl = gi / gpi;
      const int pix0 = (gi % gpi) * Pt + (idx % spg) * PT;
      int8_t* st = sm + (idx % STAGES) * 2 * DW_SLAB;
#pragma unroll
      for (int j = 0; j < 2 * DW_T * (BK / 16) / DW_NT; ++j) {
        const int e = tid + j * DW_NT;             // 0 .. 1023
        const int which = e / (DW_T * 4);          // 0: aq rows, 1: q rows
        const int r = (e / 4) % DW_T, c = (e % 4) * 16;
        const int row = (which ? j0 : i0) + r;
        if (row < Kp)
          cp_async16(st + which * DW_SLAB + r * SLAB_S + c,
                     (which ? q_ws : aq_ws) +
                         (size_t(bl) * Kp + row) * HWp + pix0 + c);
      }
    }
    cp_async_commit();
  };

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mt][nt][c] = 0;
        facc[mt][nt][c] = 0.f;
      }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill(s);
  for (int idx = 0; idx < total; ++idx) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fill(idx + STAGES - 1);
    const int8_t* A = sm + (idx % STAGES) * 2 * DW_SLAB;
    const int8_t* Bm = A + DW_SLAB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* bp = Bm + (wn * 32 + nt * 8 + g) * SLAB_S + kk + 4 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(bp);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* ap = A + (wm * 64 + mt * 16 + g) * SLAB_S + kk + 4 * t;
        const uint32_t af[4] = {
            *reinterpret_cast<const uint32_t*>(ap),
            *reinterpret_cast<const uint32_t*>(ap + 8 * SLAB_S),
            *reinterpret_cast<const uint32_t*>(ap + 16),
            *reinterpret_cast<const uint32_t*>(ap + 8 * SLAB_S + 16)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af, bf[nt][0],
                                              bf[nt][1]);
      }
    }
    if (idx % spg == spg - 1) {         // the group is complete: scale it
      const float s = gscale[g0 + idx / spg];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            facc[mt][nt][c] = __fadd_rn(
                facc[mt][nt][c], __fmul_rn(float(acc[mt][nt][c]), s));
            acc[mt][nt][c] = 0;
          }
    }
  }
  cp_async_wait<0>();
  float* out = part + size_t(blockIdx.y) * H * H;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + wm * 64 + mt * 16 + g + (c >> 1) * 8;
        const int j = j0 + wn * 32 + nt * 8 + 2 * t + (c & 1);
        if (i < H && j < H) out[size_t(i) * H + j] = facc[mt][nt][c];
      }
}

bool bad_shape(int B, int HW, int H, int No) {
  return B < 1 || HW < 1 || H < 1 || No < 1 || No > MAX_NO ||
         double(B) * ((HW + PT - 1) / PT) > 2147483647.0;
}

}  // namespace

extern "C" {

// Bytes of workspace each block of the wide int8 kernels (H > 512: K3, K4,
// K5) takes; 0 at H <= 512 (the tiles lie in shared memory).
long long svt_int8_ws_block(int H) {
  return H > MAX_H ? (long long)wide_block_bytes(padded_k(H)) : 0;
}

// K4.  fold (B,4,H), coords (HW,2), b1 (H), wht (No,H), bht (No), sw (1),
// y (B,No,HW): float32; w1qT (Kp,Kp) int8, rows of W1q^T zero-padded;
// a1 (B,HW,H) bf16 or null.  `bf16`: the weights hold bf16 values.  For
// H > 512, ws holds B*ceil(HW/64) * svt_int8_ws_block(H) bytes.
int svt_int8_decoder_fwd(const void* fold, const void* coords,
                         const void* w1qT, const void* sw, const void* b1,
                         const void* wht, const void* bht, void* y, void* a1,
                         void* ws, int B, int HW, int H, int No, int bf16,
                         void* stream) {
  if (bad_shape(B, HW, H, No) || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const int8_t*>(w1qT);
  const auto* s = static_cast<const float*>(sw);
  const auto* bb = static_cast<const float*>(b1);
  const auto* wt = static_cast<const float*>(wht);
  const auto* bt = static_cast<const float*>(bht);
  auto* out = static_cast<float*>(y);
  auto* act = static_cast<__nv_bfloat16*>(a1);
  auto* wsb = static_cast<int8_t*>(ws);
  const bool wide = H > MAX_H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_FWD(B16, E, WD)                                                \
  do {                                                                     \
    auto k = int8_fwd_kernel<B16, E, WD>;                                  \
    const int smem = WD ? SMEM_WIDE : SMEM;                                \
    cudaError_t err = allow_smem(k, smem);                                 \
    if (err != cudaSuccess) return int(err);                               \
    k<<<unsigned(B) * unsigned(blocks), NT, smem, st>>>(                   \
        f, c, w, s, bb, wt, bt, out, act, wsb, HW, H, No, blocks);         \
  } while (0)
#define SVT_FWD_W(B16, E)                                                  \
  do {                                                                     \
    if (wide) SVT_FWD(B16, E, true); else SVT_FWD(B16, E, false);          \
  } while (0)
  if (bf16) {
    if (a1) SVT_FWD_W(true, true); else SVT_FWD_W(true, false);
  } else {
    if (a1) SVT_FWD_W(false, true); else SVT_FWD_W(false, false);
  }
#undef SVT_FWD_W
#undef SVT_FWD
  return int(cudaGetLastError());
}

// K5 (a): part_max (B * ceil(HW/64)).  a1: the bf16 residual or null
// (recompute from fold, w1qT, sw, b1).  y, gy (B,No,HW) float32.  ws as
// for K4.
int svt_int8_decoder_bwd_scale(const void* fold, const void* coords,
                               const void* w1qT, const void* sw,
                               const void* b1, const void* wht,
                               const void* a1, const void* y, const void* gy,
                               void* part_max, void* ws, int B, int HW,
                               int H, int No, int bf16, void* stream) {
  if (bad_shape(B, HW, H, No) || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  const bool wide = H > MAX_H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_SCALE(B16, R, WD)                                              \
  do {                                                                     \
    auto k = int8_bwd_scale_kernel<B16, R, WD>;                            \
    const int smem = WD ? SMEM_WIDE : SMEM;                                \
    cudaError_t err = allow_smem(k, smem);                                 \
    if (err != cudaSuccess) return int(err);                               \
    k<<<unsigned(B) * unsigned(blocks), NT, smem, st>>>(                   \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1qT), static_cast<const float*>(sw),   \
        static_cast<const float*>(b1), static_cast<const float*>(wht),     \
        static_cast<const __nv_bfloat16*>(a1), static_cast<const float*>(y), \
        static_cast<const float*>(gy), static_cast<float*>(part_max),      \
        static_cast<int8_t*>(ws), HW, H, No, blocks, nullptr);             \
  } while (0)
#define SVT_SCALE_W(B16, R)                                                \
  do {                                                                     \
    if (wide) SVT_SCALE(B16, R, true); else SVT_SCALE(B16, R, false);      \
  } while (0)
  if (bf16) {
    if (a1) SVT_SCALE_W(true, false); else SVT_SCALE_W(true, true);
  } else {
    if (a1) SVT_SCALE_W(false, false); else SVT_SCALE_W(false, true);
  }
#undef SVT_SCALE_W
#undef SVT_SCALE
  return int(cudaGetLastError());
}

// K5 (b) for images b0 .. b0+Bc-1: gscale (B * HW/Pt) gets each group's dW
// scale sg/127; aq_ws, q_ws (Bc, Kp, HWp) int8; part_fold (B*blocks, 3, H)
// and part_w (B*blocks, H + No*H + No) the per-block partials.  w1q
// (Kp,Kp) int8: rows of W1q zero-padded.  Pt divides HW and is a multiple
// of 64, or equals HW.  For H > 512, ws holds Bc*ceil(HW/64) *
// svt_int8_ws_block(H) bytes.
int svt_int8_decoder_bwd_grad(const void* fold, const void* coords,
                              const void* w1qT, const void* sw,
                              const void* b1, const void* wht, const void* a1,
                              const void* y, const void* gy, const void* w1q,
                              const void* part_max, void* gscale,
                              void* aq_ws, void* q_ws, void* part_fold,
                              void* part_w, void* ws, int b0, int Bc, int HW,
                              int H, int No, int Pt, int bf16, void* stream) {
  if (bad_shape(Bc, HW, H, No) || b0 < 0 || Pt < 1 || HW % Pt ||
      (Pt % PT && Pt != HW) || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  const bool wide = H > MAX_H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_GRAD(B16, R, WD)                                               \
  do {                                                                     \
    auto k = int8_bwd_grad_kernel<B16, R, WD>;                             \
    const int smem = WD ? SMEM_WIDE : SMEM;                                \
    cudaError_t err = allow_smem(k, smem);                                 \
    if (err != cudaSuccess) return int(err);                               \
    k<<<unsigned(Bc) * unsigned(blocks), NT, smem, st>>>(                  \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1qT), static_cast<const float*>(sw),   \
        static_cast<const float*>(b1), static_cast<const float*>(wht),     \
        static_cast<const __nv_bfloat16*>(a1), static_cast<const float*>(y), \
        static_cast<const float*>(gy), static_cast<const int8_t*>(w1q),    \
        static_cast<const float*>(part_max), static_cast<float*>(gscale),  \
        static_cast<int8_t*>(aq_ws), static_cast<int8_t*>(q_ws),           \
        static_cast<float*>(part_fold), static_cast<float*>(part_w),       \
        static_cast<int8_t*>(ws), b0, HW, H, No, Pt, blocks, nullptr);     \
  } while (0)
#define SVT_GRAD_W(B16, R)                                                 \
  do {                                                                     \
    if (wide) SVT_GRAD(B16, R, true); else SVT_GRAD(B16, R, false);        \
  } while (0)
  if (bf16) {
    if (a1) SVT_GRAD_W(true, false); else SVT_GRAD_W(true, true);
  } else {
    if (a1) SVT_GRAD_W(false, false); else SVT_GRAD_W(false, true);
  }
#undef SVT_GRAD_W
#undef SVT_GRAD
  return int(cudaGetLastError());
}

// dW1 partials of nimg images from the workspaces: `splits` partials
// (H, H) f32 in part, groups spread evenly over the splits.
int svt_int8_grouped_dw(const void* aq_ws, const void* q_ws,
                        const void* gscale, void* part, int nimg, int HWp,
                        int H, int Pt, int gpi, int splits, void* stream) {
  if (nimg < 1 || H < 1 || HWp % PT || Pt < 1 || gpi < 1 ||
      splits < 1 || splits > 65535 || double(Pt) * gpi > HWp)
    return int(cudaErrorInvalidValue);
  const int G = nimg * gpi;
  const int gps = (G + splits - 1) / splits;
  const int tiles = (padded_k(H) + DW_T - 1) / DW_T;
  cudaError_t err = allow_smem(grouped_dw_kernel, DW_SMEM);
  if (err != cudaSuccess) return int(err);
  grouped_dw_kernel<<<dim3(unsigned(tiles * tiles), unsigned(splits)), DW_NT,
                      DW_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(aq_ws), static_cast<const int8_t*>(q_ws),
      static_cast<const float*>(gscale), static_cast<float*>(part), nimg,
      HWp, H, Pt, gpi, gps);
  return int(cudaGetLastError());
}

}  // extern "C"
