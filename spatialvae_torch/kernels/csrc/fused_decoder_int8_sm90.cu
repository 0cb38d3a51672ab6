// K4 and K5 on the cluster passes (fused_decoder_int8_sm90.cuh): the
// instantiations the wrappers launch and their entry points.  A library
// built with SVT_I8_90_PINGPONG or SVT_I8_90_CUT (the header lists them)
// runs a timing copy of the bf16 calls they name through the same entry
// points; the wrappers' library runs the passes.

#include "fused_decoder_int8_sm90.cuh"

namespace {

template <bool BF16>
cudaError_t launch_scale90(const __nv_bfloat16* a1, const float* y,
                           const float* gy, const float* wht,
                           float* part_max, int Bc, int HW, int H, int No,
                           cudaStream_t st) {
  auto k = int8_scale90_kernel<BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, SCALE_SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = HW / PT;
  k<<<unsigned(Bc) * unsigned(blocks), SCALE_NT, SCALE_SMEM, st>>>(
      a1, y, gy, wht, part_max, HW, H, No, blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K4 on the cluster passes.  fold (B,4,H), coords (HW,2), b1 (H), wht
// (No,H), bht (No), sw (1), y (B,No,HW): float32; wslabs: W1q^T's half-slab
// stream (fused_decoder_int8.half_slabs90, Kp * 512 bytes); a1 (B,HW,H)
// bf16 or null.  `bf16`: the weights hold bf16 values.  Refused unless
// int8_route takes the call (H <= 512, HW a multiple of 256).
int svt_int8_90_fwd(const void* fold, const void* coords, const void* wslabs,
                    const void* sw, const void* b1, const void* wht,
                    const void* bht, void* y, void* a1, int B, int HW, int H,
                    int No, int bf16, void* stream) {
  if (bad90(B, HW, H, No)) return int(cudaErrorInvalidValue);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = a1 ? launch_fwd90<true, MODE_EMIT, SCHED_K4, WHOLE>(a, tiles, st)
             : launch_fwd90<true, MODE_Y, SCHED_K4, CUT_K>(a, tiles, st);
  else
    err = a1 ? launch_fwd90<false, MODE_EMIT, SERIAL, WHOLE>(a, tiles, st)
             : launch_fwd90<false, MODE_Y, SERIAL, WHOLE>(a, tiles, st);
  return int(err);
}

// K5's scale pass for images b0 .. b0+Bc-1: part_max (B * HW/64) gets each
// block's max |dh1| (globally indexed).  a1: the bf16 residual (B,HW,H), or
// null: a1 rebuilt on the forward's cluster machinery (fold, coords, wslabs,
// sw, b1 as for svt_int8_90_fwd) and left, f32, in `stash` (Bc * HW/64 *
// svt_int8_90_stash_block() bytes) for the gradient pass.  y, gy (B,No,HW)
// float32.
int svt_int8_90_scale(const void* fold, const void* coords,
                      const void* wslabs, const void* sw, const void* b1,
                      const void* wht, const void* a1, const void* y,
                      const void* gy, void* part_max, void* stash, int b0,
                      int Bc, int HW, int H, int No, int bf16, void* stream) {
  if (bad90(Bc, HW, H, No) || b0 < 0 || (a1 == nullptr && stash == nullptr))
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* gf = static_cast<const float*>(gy);
  auto* pm = static_cast<float*>(part_max);
  const auto* w = static_cast<const float*>(wht);
  if (a1 != nullptr) {
    const size_t o = size_t(b0) * No * HW;
    const auto* r = static_cast<const __nv_bfloat16*>(a1) +
                    size_t(b0) * HW * H;
    return int(bf16 ? launch_scale90<true>(r, yf + o, gf + o, w,
                                           pm + size_t(b0) * blocks, Bc, HW,
                                           H, No, st)
                    : launch_scale90<false>(r, yf + o, gf + o, w,
                                            pm + size_t(b0) * blocks, Bc, HW,
                                            H, No, st));
  }
  const Fwd90Args a{static_cast<const float*>(fold),
                    static_cast<const float*>(coords),
                    static_cast<const int8_t*>(wslabs),
                    static_cast<const float*>(sw),
                    static_cast<const float*>(b1), w, nullptr,
                    const_cast<float*>(yf), gf, nullptr,
                    static_cast<float*>(stash), pm, b0, HW, H, No, blocks};
  const int tiles = Bc * blocks;
  return int(bf16 ? launch_fwd90<true, MODE_SCALE, SERIAL, WHOLE>(a, tiles,
                                                                st)
                  : launch_fwd90<false, MODE_SCALE, SERIAL, WHOLE>(a, tiles,
                                                                 st));
}

// K5's gradient pass for images b0 .. b0+Bc-1: gscale (B * HW/Pt) gets each
// group's dW1 scale sg/127; aq_ws, q_ws (Bc * HW/64 blocks of 512 x 64
// bytes) the dW1 operands in svt_loss90_dw's layout; part_fold (B*blocks,
// 3, H) and part_w (B*blocks, H + No*H + No) the per-block partials.
// wslabs: W1q's slab stream (fused_loss_int8.sm90_slabs of W1q).  a1: the
// bf16 residual, or null and `stash` the scale pass's f32 a1 of the chunk.
// Pt: a multiple of 256 that divides HW.
int svt_int8_90_grad(const void* fold, const void* coords, const void* wslabs,
                     const void* sw, const void* wht, const void* a1,
                     const void* stash, const void* y, const void* gy,
                     const void* part_max, void* gscale, void* aq_ws,
                     void* q_ws, void* part_fold, void* part_w, int b0,
                     int Bc, int HW, int H, int No, int Pt, int bf16,
                     void* stream) {
  if (bad90(Bc, HW, H, No) || b0 < 0 || Pt < CS * PT || Pt % (CS * PT) ||
      HW % Pt || (a1 == nullptr && stash == nullptr))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = a1 ? launch_grad90<true, true, CUT_K>(a, tiles, st)
             : launch_grad90<true, false, WHOLE>(a, tiles, st);
  else
    err = a1 ? launch_grad90<false, true, WHOLE>(a, tiles, st)
             : launch_grad90<false, false, WHOLE>(a, tiles, st);
  return int(err);
}

// Bytes of one 64-pixel block's f32 a1 stash (the recompute scale pass
// writes it, the gradient pass reads it).
long long svt_int8_90_stash_block() { return (long long)PT * KW * 4; }

// Clusters of 4 CTAs that can be resident at once for each cluster kernel
// (0 forward bf16, 1 forward f32, 2 forward with a1, 3 the recompute scale
// pass, 4 gradient from the residual, 5 gradient from the stash; bf16
// weights but for 1); 0 if the card cannot make one resident.
int svt_int8_90_max_clusters(int which) {
  switch (which) {
    case 0:
      return max_clusters(
          int8_fwd90_kernel<true, MODE_Y, SERIAL, WHOLE>, NT,
          sizeof(FwdSmem<MODE_Y>), CS);
    case 1:
      return max_clusters(
          int8_fwd90_kernel<false, MODE_Y, SERIAL, WHOLE>, NT,
          sizeof(FwdSmem<MODE_Y>), CS);
    case 2:
      return max_clusters(
          int8_fwd90_kernel<true, MODE_EMIT, SERIAL, WHOLE>,
          NT, sizeof(FwdSmem<MODE_EMIT>), CS);
    case 3:
      return max_clusters(
          int8_fwd90_kernel<true, MODE_SCALE, SERIAL, WHOLE>,
          NT, sizeof(FwdSmem<MODE_SCALE>), CS);
    case 4:
      return max_clusters(int8_grad90_kernel<true, true, WHOLE>, NT,
                          sizeof(GradSmem), CS);
    case 5:
      return max_clusters(int8_grad90_kernel<true, false, WHOLE>, NT,
                          sizeof(GradSmem), CS);
    default:
      return 0;
  }
}

}  // extern "C"
