// Adam's per-element arithmetic, shared by the per-leaf kernels of adam.cu
// and the step kernel of adam_sm90.cu, so that both compute the same bits.
// Per element, in `adam_leaf`'s op order (spatialvae_tpu/train/optimizer.py),
// every operation rounded once to float32 (no contraction into FMA):
//
//   m' = b1*m + (1-b1)*g;   v' = b2*v + (1-b2)*(g*g)
//   p' = p + (-lr)*(m'/c1) / (sqrt(v'/c2) + eps)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A faulty copy for `chip_smoke.py --limits adam`, which must show that the
// bit compare refuses it: SVT_ADAM_FMA=1 contracts b1*m into an FMA.
#ifndef SVT_ADAM_FMA
#define SVT_ADAM_FMA 0
#endif

namespace adam {

struct AdamScalars {
  float b1, omb1, b2, omb2, neg_lr, eps, c1, c2;
};

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a / b and sqrt(x), each rounded once, without the slow path the IEEE
// sequences take for a zero operand: a zero a over b > 0 is a (of a's
// sign), sqrt(+-0) is x, so a zero is swapped for 1 before the operation
// and its exact result selected after it (same bits, no branch).  Zero
// gradients with zero moments (an input pixel that is 0 in every image of
// a batch zeroes a column of the first layer's dW) would otherwise send
// all three divisions and the root of such elements down the slow path.
__device__ __forceinline__ float div_rn(float a, float b) {
  const bool zero = a == 0.0f && b > 0.0f;
  const float q = __fdiv_rn(zero ? 1.0f : a, b);
  return zero ? a : q;
}
__device__ __forceinline__ float sqrt_rn(float x) {
  const float r = __fsqrt_rn(x == 0.0f ? 1.0f : x);
  return x == 0.0f ? x : r;
}

__device__ __forceinline__ void adam_elem(float g, float& m, float& v,
                                          float& p, const AdamScalars& s) {
#if SVT_ADAM_FMA
  m = __fmaf_rn(s.b1, m, __fmul_rn(s.omb1, g));
#else
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
#endif
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(s.neg_lr, div_rn(m, s.c1));
  const float den = __fadd_rn(sqrt_rn(div_rn(v, s.c2)), s.eps);
  p = __fadd_rn(p, div_rn(num, den));
}

// int8(clip(rint(x), -127, 127))
__device__ __forceinline__ int8_t quant(float x) {
  const float r = fminf(fmaxf(rintf(x), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// |x| as bits: non-negative floats order as their values, a NaN above all
__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

__device__ __forceinline__ void warp_atomic_max(unsigned int* out,
                                                unsigned int mx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if ((threadIdx.x & 31) == 0 && mx != 0u) atomicMax(out, mx);
}

// The scale of an abs-max: max/127 + 1e-30, as quantize_leaf computes it.
__device__ __forceinline__ float scale_of(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-30f);
}

}  // namespace adam
