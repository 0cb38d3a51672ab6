// K3's entry points and its default kernels (H <= 512, no measurement
// lever); the kernels themselves are in fused_loss_int8.cuh, the levers'
// and the wide instantiations in fused_loss_int8_levers.cu and
// fused_loss_int8_wide.cu.

#include "fused_loss_int8.cuh"

namespace svt8 {

cudaError_t loss_fwd_default(const LossFwdArgs& a, int pb, bool bf16,
                             bool colored, bool tile, cudaStream_t st) {
  return dispatch_fwd<false, false>(a, 0, pb, bf16, colored, tile, st);
}

cudaError_t loss_grad_default(const LossGradArgs& a, int pb, bool bf16,
                              bool sr, cudaStream_t st) {
  return dispatch_grad<false, false>(a, pb, bf16, sr, st);
}

}  // namespace svt8

namespace {

// The device Philox of n counters (c: n x 4 uint32) under one key, to n x 4
// words: held against the plain version's.
__global__ void philox_kernel(const uint4* __restrict__ c, uint4* out, int n,
                              uint32_t k0, uint32_t k1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox4x32_10(c[i], k0, k1);
}

bool bad_shape(int B, int HW, int H, int No) {
  return B < 1 || HW < PT || HW % PT || H < 1 || No < 1 ||
         No > MAX_NO || double(B) * (HW / PT) > 2147483647.0;
}

// Whether the cluster passes (fused_loss_int8_sm90.cu, past H = 512
// fused_loss_int8_sm90_wide.cu, and with stochastic rounding
// fused_loss_int8_sm90_sr.cu) take a call: the default numerics (no mode
// bit; level 7) at every H, or the SR bit alone at H <= 512, in any family,
// over pixel counts and groups that are multiples of 256 (a cluster's four
// blocks lie in one group; a colored quad's two pairs too).  The wrapper
// chooses the route; the entry points refuse the cluster route where this
// is false.
bool sm90_takes(int HW, int H, int Pt, int mode, float lf) {
  return (mode == 0 || (mode == SR && H <= MAX_H)) && lf == 7.f &&
         HW % (4 * PT) == 0 && Pt % (4 * PT) == 0;
}

}  // namespace

extern "C" {

// Pass 1.  fold (B,4,H), coords (HW,2), h1s (H), b1 (H), wht (No,H), bht
// (No): float32; w1fT (Kp,Kp) int8, rows of W1f^T zero-padded; yt (B,No,HW)
// int8 (k-128, `yt_i8`) or float32; mask (HW) float32 or null; dz2
// (B,No,HW), part_max and part_bce (B*HW/64) float32 out.  `family`: 0
// Bernoulli, 1 Gaussian, 2 colored; colored takes No = 2, Pt a multiple of
// 128 that divides HW, coords chunk-permuted, yt (B,2,HW/2) and mask
// (2,HW/2) pre-paired.  lf: a0's quantisation level (7 or 127); mode: the
// Mode bits (TILE: part_max gets each block's max |dh1|, else max |dz2|);
// swht: the int8 head's scale under A1Q (wht then holds whtq).  For
// H > 512, ws holds B*HW/64 * svt_int8_ws_block(H) bytes.  `sm90` 1 runs
// the cluster passes (w1fT then holds W1f^T's slab stream; refused where
// sm90_takes is false; every block a CTA of its own, the colored family's
// pairs across a cluster; past H = 512 they leave aq in `aq_ws`), 0 the
// block passes (colored: a block per pair).
// The B images are images b0 .. b0+B-1 of the call (a workspace chunk):
// SR's words take the call's image index on the cluster passes and at
// H > 512.  The cluster passes take `ws` as the stash of a1c that the
// forward leaves for the gradient pass: B*HW/64 * svt_loss90_ws_block
// bytes; and with SR the chunk's dW1 operand workspace `aq_ws`
// (svt_loss_int8_grad's), where the forward leaves aq.  p_base: the first
// pixel's row in the call whose pixel slice coords, yt and mask are (a
// pixel shard's; 0 for a whole grid), where SR's counters start, on every
// route (the gradient pass takes it too).
int svt_loss_int8_fwd(const void* fold, const void* coords, const void* w1fT,
                      const void* h1s, const void* b1, const void* wht,
                      const void* bht, const void* yt, const void* mask,
                      void* dz2, void* part_max, void* part_bce, void* ws,
                      void* aq_ws, int b0, int p_base, int B, int HW, int H,
                      int No, int Pt, int yt_i8, int family, int bf16,
                      float lf, float swht, int mode, int sm90,
                      void* stream) {
  if (bad_shape(B, HW, H, No) || b0 < 0 || p_base < 0 ||
      family < BERNOULLI || family > COLORED || (H > MAX_H && ws == nullptr) ||
      (sm90 && !sm90_takes(HW, H, Pt, mode, lf)))
    return int(cudaErrorInvalidValue);
  const bool colored = family == COLORED;
  if (colored && (No != 2 || Pt < 2 * PT || Pt % (2 * PT) || HW % Pt))
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  LossFwdArgs a{static_cast<const float*>(fold),
                static_cast<const float*>(coords),
                static_cast<const int8_t*>(w1fT),
                static_cast<const float*>(h1s),
                static_cast<const float*>(b1),
                static_cast<const float*>(wht),
                static_cast<const float*>(bht),
                yt,
                static_cast<const float*>(mask),
                static_cast<float*>(dz2),
                static_cast<float*>(part_max),
                static_cast<float*>(part_bce),
                static_cast<int8_t*>(ws),
                HW, H, No, blocks, Pt, yt_i8, family, lf, swht, mode,
                unsigned(B) * unsigned(colored && !sm90 ? blocks / 2
                                                        : blocks)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tile = mode & TILE;
  cudaError_t err;
  if (sm90)
    err = mode & SR
              ? loss_fwd_sm90_sr(a, b0, p_base, static_cast<int8_t*>(aq_ws),
                                 bf16, st)
          : H > MAX_H
              ? loss_fwd_sm90_wide(a, static_cast<int8_t*>(aq_ws), bf16, st)
              : loss_fwd_sm90(a, bf16, st);
  else if (H > MAX_H)
    err = loss_fwd_wide(a, b0, p_base, bf16, colored, tile, st);
  else if (mode & LEVERS)
    err = loss_fwd_levers(a, p_base, bf16, colored, tile, st);
  else
    err = loss_fwd_default(a, p_base, bf16, colored, tile, st);
  return int(err);
}

// Pass 2 for images b0 .. b0+Bc-1.  w1r (Kp,Kp) int8: rows of W1r
// zero-padded; s4 (H) and gb (1) float32; gscale (B*HW/Pt) gets each
// group's dW scale sg/L, L the dW1 operand's level (lf, or 7 under AQ4_WS);
// aq_ws, q_ws (Bc, Kp, HW) int8; part_fold (B*HW/64, 3, H) and part_w
// (B*HW/64, H + No*H + No) float32.  lf, lv: the forward's and the
// gradient's levels; mode: the Mode bits; dbk: DB1_QI's pad-row constant.
// swht: the int8 head's scale under A1Q (wht then holds whtq and gb the
// bound over it); cut: the last phase under CUT (4..7 here: the host runs
// no gradient pass below 4).  For H > 512, ws holds Bc*HW/64 *
// svt_int8_ws_block(H) bytes.  `sm90` chooses the route as in
// svt_loss_int8_fwd (refused for the cluster passes unless lv is 7 too);
// the cluster passes take W1f^T's and W1r's slab streams and write aq_ws,
// q_ws as Bc*HW/64 blocks of R x 64 bytes (R = 512, or past H = 512 the
// padded width in whole 512-column chunks), reading the a1c stash `ws`
// that svt_loss_int8_fwd wrote for the same Bc images (past 512 also the
// aq it left in aq_ws).
int svt_loss_int8_grad(const void* fold, const void* coords, const void* w1fT,
                       const void* w1r, const void* h1s, const void* s4,
                       const void* gb, const void* b1, const void* wht,
                       const void* dz2, const void* part_max, void* gscale,
                       void* aq_ws, void* q_ws, void* part_fold,
                       void* part_w, void* ws, int b0, int p_base, int Bc,
                       int HW, int H, int No, int Pt, int bf16, float lf,
                       float lv, int mode, float dbk, float swht, int cut,
                       int sm90, void* stream) {
  if (bad_shape(Bc, HW, H, No) || b0 < 0 || p_base < 0 || Pt < PT ||
      Pt % PT || HW % Pt ||
      (H > MAX_H && ws == nullptr) || ((mode & CUT) && (cut < 4 || cut > 8)) ||
      (sm90 && !(sm90_takes(HW, H, Pt, mode, lf) && lv == 7.f)))
    return int(cudaErrorInvalidValue);
  const int blocks = HW / PT;
  LossGradArgs a{static_cast<const float*>(fold),
                 static_cast<const float*>(coords),
                 static_cast<const int8_t*>(w1fT),
                 static_cast<const int8_t*>(w1r),
                 static_cast<const float*>(h1s),
                 static_cast<const float*>(s4),
                 static_cast<const float*>(gb),
                 static_cast<const float*>(b1),
                 static_cast<const float*>(wht),
                 static_cast<const float*>(dz2),
                 static_cast<const float*>(part_max),
                 static_cast<float*>(gscale),
                 static_cast<int8_t*>(aq_ws),
                 static_cast<int8_t*>(q_ws),
                 static_cast<float*>(part_fold),
                 static_cast<float*>(part_w),
                 static_cast<int8_t*>(ws),
                 b0, HW, H, No, Pt, blocks, lf, lv, mode, dbk, swht, cut,
                 unsigned(Bc) * unsigned(blocks)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sr = mode & SR;
  cudaError_t err;
  if (sm90)
    err = sr          ? loss_grad_sm90_sr(a, p_base, bf16, st)
          : H > MAX_H ? loss_grad_sm90_wide(a, bf16, st)
                      : loss_grad_sm90(a, bf16, st);
  else if (H > MAX_H)
    err = loss_grad_wide(a, p_base, bf16, sr, st);
  else if (mode & LEVERS)
    err = loss_grad_levers(a, p_base, bf16, sr, st);
  else
    err = loss_grad_default(a, p_base, bf16, sr, st);
  return int(err);
}

// n Philox4x32-10 calls: counters (n, 4) uint32 -> words (n, 4) uint32.
int svt_philox4x32_10(const void* ctr, void* out, int n, unsigned k0,
                      unsigned k1, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  philox_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ctr), static_cast<uint4*>(out), n, k0, k1);
  return int(cudaGetLastError());
}

}  // extern "C"
