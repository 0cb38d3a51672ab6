// The int8 kernel microbenchmark's two backward kernels for Hopper (sm_90a):
// `fplain_kernel` (tools/kernel_bench.py:535, pallas_call :619, run
// `fused-plain`) and `bwdfix_kernel` (:714, pallas_call :766, run
// `bwd-fixscale`), as the T1_PLAIN and T1_FIX modes of K5's two passes
// (fused_decoder_int8.cuh describes both).  They compile here, in
// instantiations of their own, so K5's default kernels keep their code and
// registers.  The wrapper (kernels/kernel_bench.py) runs them as K5's does:
// per-block partials, feature-major int8 workspaces, the grouped dW1 kernel
// (svt_int8_grouped_dw, each step one group) and fixed-order sums, so two
// runs agree bit for bit.
//
// What bounds them on this card: fused-plain's three int8 GEMMs (h1, dW1,
// da0; 6.36 ms at B=2,048, HW=4,096, H=500) and its f32 chain, head and
// epilogue; bwd-fixscale's two GEMMs and its read of the 8.39 GB bf16 a1
// (2.50 ms of device memory).

#include "fused_decoder_int8.cuh"

namespace {

bool bad_shape(int B, int HW, int H, int No) {
  return B < 1 || HW < 1 || H < 1 || No < 1 || No > MAX_NO ||
         double(B) * ((HW + PT - 1) / PT) > 2147483647.0;
}

bool bad_group(int HW, int Pt) {
  return Pt < 1 || HW % Pt || (Pt % PT && Pt != HW);
}

}  // namespace

extern "C" {

// fused-plain's scale pass: part_max (B * ceil(HW/64)) each block's max
// |dh1|.  fold (B,4,H), coords (HW,2), sw (1), b1 (H), wht (No,H) (bf16
// values), bht (No), yt (B,No,HW) float32; w1qT (Kp,Kp) int8.  For H > 512,
// ws holds B*ceil(HW/64) * svt_int8_ws_block(H) bytes.
int svt_kb_plain_scale(const void* fold, const void* coords, const void* w1qT,
                       const void* sw, const void* b1, const void* wht,
                       const void* bht, const void* yt, void* part_max,
                       void* ws, int B, int HW, int H, int No, void* stream) {
  if (bad_shape(B, HW, H, No) || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_PSCALE(WD)                                                      \
  do {                                                                      \
    auto k = int8_bwd_scale_kernel<true, true, WD, T1_PLAIN>;               \
    const int smem = WD ? SMEM_WIDE : SMEM;                                 \
    cudaError_t err = allow_smem(k, smem);                                  \
    if (err != cudaSuccess) return int(err);                                \
    k<<<unsigned(B) * unsigned(blocks), NT, smem, st>>>(                    \
        static_cast<const float*>(fold), static_cast<const float*>(coords), \
        static_cast<const int8_t*>(w1qT), static_cast<const float*>(sw),    \
        static_cast<const float*>(b1), static_cast<const float*>(wht),      \
        nullptr, static_cast<const float*>(yt), nullptr,                    \
        static_cast<float*>(part_max), static_cast<int8_t*>(ws), HW, H, No, \
        blocks, static_cast<const float*>(bht));                            \
  } while (0)
  if (H > MAX_H) SVT_PSCALE(true); else SVT_PSCALE(false);
#undef SVT_PSCALE
  return int(cudaGetLastError());
}

// fused-plain's gradient pass for images b0 .. b0+Bc-1: gscale (B * HW/Pt)
// each step's sg/127; aq_ws, q_ws (Bc, Kp, HWp) int8; part_fold (B*blocks,
// 4, H) and part_w (B*blocks, H + No*H + No) the per-block partials (the
// loss at part_fold[.][3][0]).  w1q (Kp,Kp) int8 rows of W1q.  Pt (the
// step's pixels) divides HW and is a multiple of 64.
int svt_kb_plain_grad(const void* fold, const void* coords, const void* w1qT,
                      const void* sw, const void* b1, const void* wht,
                      const void* bht, const void* yt, const void* w1q,
                      const void* part_max, void* gscale, void* aq_ws,
                      void* q_ws, void* part_fold, void* part_w, void* ws,
                      int b0, int Bc, int HW, int H, int No, int Pt,
                      void* stream) {
  if (bad_shape(Bc, HW, H, No) || b0 < 0 || bad_group(HW, Pt) ||
      (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_PGRAD(WD)                                                        \
  do {                                                                       \
    auto k = int8_bwd_grad_kernel<true, true, WD, T1_PLAIN>;                 \
    const int smem = WD ? SMEM_WIDE : SMEM;                                  \
    cudaError_t err = allow_smem(k, smem);                                   \
    if (err != cudaSuccess) return int(err);                                 \
    k<<<unsigned(Bc) * unsigned(blocks), NT, smem, st>>>(                    \
        static_cast<const float*>(fold), static_cast<const float*>(coords),  \
        static_cast<const int8_t*>(w1qT), static_cast<const float*>(sw),     \
        static_cast<const float*>(b1), static_cast<const float*>(wht),       \
        nullptr, static_cast<const float*>(yt), nullptr,                     \
        static_cast<const int8_t*>(w1q),                                     \
        static_cast<const float*>(part_max), static_cast<float*>(gscale),    \
        static_cast<int8_t*>(aq_ws), static_cast<int8_t*>(q_ws),             \
        static_cast<float*>(part_fold), static_cast<float*>(part_w),         \
        static_cast<int8_t*>(ws), b0, HW, H, No, Pt, blocks,                 \
        static_cast<const float*>(bht));                                     \
  } while (0)
  if (H > MAX_H) SVT_PGRAD(true); else SVT_PGRAD(false);
#undef SVT_PGRAD
  return int(cudaGetLastError());
}

// bwd-fixscale's gradient pass for images b0 .. b0+Bc-1: a1 (B,HW,H) bf16
// the residual; y, gy (B,No,HW), wht (No,H) float32; gscale (B * HW/Pt)
// gets 1 per step; part_fold (B*blocks, 3, H).  Other arguments as
// svt_kb_plain_grad's.
int svt_kb_fix_grad(const void* fold, const void* coords, const void* sw,
                    const void* wht, const void* a1, const void* y,
                    const void* gy, const void* w1q, void* gscale,
                    void* aq_ws, void* q_ws, void* part_fold, void* ws,
                    int b0, int Bc, int HW, int H, int No, int Pt,
                    void* stream) {
  if (bad_shape(Bc, HW, H, No) || b0 < 0 || bad_group(HW, Pt) ||
      a1 == nullptr || (H > MAX_H && ws == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = (HW + PT - 1) / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_FGRAD(WD)                                                        \
  do {                                                                       \
    auto k = int8_bwd_grad_kernel<false, false, WD, T1_FIX>;                 \
    const int smem = WD ? SMEM_WIDE : SMEM;                                  \
    cudaError_t err = allow_smem(k, smem);                                   \
    if (err != cudaSuccess) return int(err);                                 \
    k<<<unsigned(Bc) * unsigned(blocks), NT, smem, st>>>(                    \
        static_cast<const float*>(fold), static_cast<const float*>(coords),  \
        nullptr, static_cast<const float*>(sw), nullptr,                     \
        static_cast<const float*>(wht),                                      \
        static_cast<const __nv_bfloat16*>(a1), static_cast<const float*>(y), \
        static_cast<const float*>(gy), static_cast<const int8_t*>(w1q),      \
        nullptr, static_cast<float*>(gscale), static_cast<int8_t*>(aq_ws),   \
        static_cast<int8_t*>(q_ws), static_cast<float*>(part_fold), nullptr, \
        static_cast<int8_t*>(ws), b0, HW, H, No, Pt, blocks, nullptr);       \
  } while (0)
  if (H > MAX_H) SVT_FGRAD(true); else SVT_FGRAD(false);
#undef SVT_FGRAD
  return int(cudaGetLastError());
}

}  // extern "C"
