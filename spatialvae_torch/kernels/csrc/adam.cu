// Adam for Hopper (sm_90a): K6, the update of one parameter leaf with its
// optional compute-dtype shadow, and K7, the same pass that also writes the
// leaf's int8 copy with a carried scale and the abs-max for the next one.
//
// Replaces the Pallas TPU kernels spatialvae_tpu/train/optimizer_pallas.py
// `_adam_kernel` (:53, through `_adam_leaf_pallas` :69) and
// `_adam_emit_kernel` (:129, through `_adam_emit_leaf` :181).  Per element,
// in `adam_leaf`'s op order (spatialvae_tpu/train/optimizer.py:45), every
// operation rounded once to float32 (no contraction into FMA):
//
//   m' = b1*m + (1-b1)*g;   v' = b2*v + (1-b2)*(g*g)
//   p' = p + (-lr)*(m'/c1) / (sqrt(v'/c2) + eps)
//
// g is float32 or bf16 (the shadow path's gradients), m and v float32 or
// bf16 (SPATIALVAE_ADAM_MOMENTS=bf16: widened, updated in float32, rounded
// to nearest even once on store).  p is the float32 master.  Outputs are
// written in place.  Optional outputs: the bf16 shadow bf16(p') (round to
// nearest even), max|p'| (atomicMax on the bit pattern of |p'|, which
// orders non-negative floats as their values and lets a NaN win as
// jnp.max does; max is order-free, so the result is exact), and for K7 the
// int8 copy q = int8(clip(rint(p' * (1/s_in)), -127, 127)) with the
// reciprocal taken once, as the TPU kernel multiplies.
//
// Two helpers serve the emission: `quant_scale` turns an abs-max into the
// scale max/127 + 1e-30 (the fresh scale of quantize_leaf when the qshadow
// is seeded, and of the per-dataset int8 copy), and `quantize` writes the
// fresh-scale int8 copies clip(rint(p'/s), -127, 127) of any number of
// leaves in one launch, dividing as quantize_leaf does.
//
// What bounds it on this card: memory.  One read of g, m, v, p and one
// write of m', v', p' (and the shadow, the int8 copy): 20-28 bytes per
// parameter, no reuse, so the design is a grid-stride loop with 16-byte
// loads and stores, 8 elements per thread per iteration, one launch per
// leaf, and the abs-max reduced in registers and a warp before one atomic
// per warp.  The TPU kernel walks row blocks in order and carries its max
// in a (1, 1) tile; here blocks run in no order and the atomic replaces
// that carry.  The training paths run the step kernel of adam_sm90.cu
// instead (one launch a step over every leaf, fed by a bulk-copy ring);
// these per-leaf kernels stay as its yardstick.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adam.cuh"

using namespace adam;

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                 // elements per thread per iteration
constexpr int kMaxBlocks = 132 * 16;    // 16 blocks per SM of an H100

// 8 consecutive elements through 16-byte words (the caller checked the
// alignment): one word for bf16, two for float32
template <typename T>
__device__ __forceinline__ void load8(const T* ptr, float (&out)[kVec]) {
  constexpr int kWords = int(sizeof(T)) * kVec / 16;
  uint4 raw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) raw[w] = reinterpret_cast<const uint4*>(ptr)[w];
  const T* vals = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) out[i] = widen(vals[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* ptr, const float (&in)[kVec]) {
  constexpr int kWords = int(sizeof(T)) * kVec / 16;
  uint4 raw[kWords];
  T* vals = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) vals[i] = narrow<T>(in[i]);
#pragma unroll
  for (int w = 0; w < kWords; ++w) reinterpret_cast<uint4*>(ptr)[w] = raw[w];
}

// SHADOW: write bf16(p'); AMAX: fold |p'| into *amax; QUANT (K7): write the
// int8 copy with the carried scale *s_in.  `vec`: every pointer is 16-byte
// aligned (q 8-byte), so the body runs on 8-element words.
template <typename G, typename M, bool SHADOW, bool AMAX, bool QUANT>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const G* __restrict__ g, M* m, M* v, float* p,
            __nv_bfloat16* __restrict__ shadow, int8_t* __restrict__ q,
            const float* __restrict__ s_in, unsigned int* amax, long long n,
            AdamScalars s, int vec) {
  float inv = 0.0f;
  if (QUANT) inv = __fdiv_rn(1.0f, s_in[0]);
  unsigned int mx = 0u;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nvec = vec ? n / kVec : 0;
  for (long long i = tid; i < nvec; i += stride) {
    const long long at = i * kVec;
    float gg[kVec], mm[kVec], vv[kVec], pp[kVec];
    load8(g + at, gg);
    load8(m + at, mm);
    load8(v + at, vv);
    load8(p + at, pp);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adam_elem(gg[k], mm[k], vv[k], pp[k], s);
    store8(m + at, mm);
    store8(v + at, vv);
    store8(p + at, pp);
    if (SHADOW) store8(shadow + at, pp);
    if (QUANT) {
      uint2 word;
      int8_t* b = reinterpret_cast<int8_t*>(&word);
#pragma unroll
      for (int k = 0; k < kVec; ++k) b[k] = quant(__fmul_rn(pp[k], inv));
      *reinterpret_cast<uint2*>(q + at) = word;
    }
    if (AMAX) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) mx = max(mx, abs_bits(pp[k]));
    }
  }
  for (long long i = nvec * kVec + tid; i < n; i += stride) {
    float mi = widen(m[i]), vi = widen(v[i]), pi = p[i];
    adam_elem(widen(g[i]), mi, vi, pi, s);
    m[i] = narrow<M>(mi);
    v[i] = narrow<M>(vi);
    p[i] = pi;
    if (SHADOW) shadow[i] = __float2bfloat16_rn(pi);
    if (QUANT) q[i] = quant(__fmul_rn(pi, inv));
    if (AMAX) mx = max(mx, abs_bits(pi));
  }
  if (AMAX) warp_atomic_max(amax, mx);
}

__global__ void quant_scale_kernel(const float* __restrict__ amax,
                                   float* __restrict__ s,
                                   float* __restrict__ ns) {
  const float v = scale_of(amax[0]);
  s[0] = v;
  if (ns != nullptr) ns[0] = v;
}

// The fresh-scale copies of up to kQuantLeaves leaves in one launch: one
// block per chunk of kQuantChunk elements of a leaf, each thread kQuantIter
// words of 8 floats (16-byte loads, all issued before the first division)
// and 8-byte stores; a leaf whose p is not 16-byte or whose q is not 8-byte
// aligned, and the last elements of a leaf that fill no word, take plain
// loads.
constexpr int kQuantLeaves = 64;
constexpr int kQuantIter = 4;
constexpr long long kQuantChunk = (long long)kThreads * kVec * kQuantIter;

struct QuantLeaf {
  const float* p;
  const float* s;        // one float
  int8_t* q;
  long long n;
  long long begin;       // the leaf's first chunk
};
struct QuantTable {
  QuantLeaf leaf[kQuantLeaves];
  int leaves;
};

__global__ void __launch_bounds__(kThreads) quantize_kernel(QuantTable t) {
  const long long chunk = blockIdx.x;
  int li = 0;
  while (li + 1 < t.leaves && t.leaf[li + 1].begin <= chunk) ++li;
  const QuantLeaf& L = t.leaf[li];
  const long long base = (chunk - L.begin) * kQuantChunk;
  const long long left = L.n - base;
  const int count = int(left < kQuantChunk ? left : kQuantChunk);
  const float* p = L.p + base;
  int8_t* q = L.q + base;
  const float sc = L.s[0];
  const bool vec = reinterpret_cast<uintptr_t>(L.p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(L.q) % 8 == 0;
  const int words = vec ? count / kVec : 0;
  float x[kQuantIter][kVec];
#pragma unroll
  for (int it = 0; it < kQuantIter; ++it) {
    const int w = it * kThreads + threadIdx.x;
    if (w < words) load8(p + (long long)w * kVec, x[it]);
  }
#pragma unroll
  for (int it = 0; it < kQuantIter; ++it) {
    const int w = it * kThreads + threadIdx.x;
    if (w < words) {
      uint2 word;
      int8_t* b = reinterpret_cast<int8_t*>(&word);
#pragma unroll
      for (int k = 0; k < kVec; ++k) b[k] = quant(__fdiv_rn(x[it][k], sc));
      *reinterpret_cast<uint2*>(q + (long long)w * kVec) = word;
    }
  }
  for (int i = words * kVec + threadIdx.x; i < count; i += kThreads)
    q[i] = quant(__fdiv_rn(p[i], sc));
}

unsigned int grid_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return unsigned(blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename G, typename M, bool SHADOW, bool AMAX, bool QUANT>
cudaError_t launch(const void* g, void* m, void* v, float* p, void* shadow,
                   void* q, const float* s_in, void* amax, long long n,
                   const AdamScalars& s, cudaStream_t st) {
  const int vec = aligned(g, 16) && aligned(m, 16) && aligned(v, 16) &&
                  aligned(p, 16) && aligned(shadow, 16) && aligned(q, 8);
  const long long work = vec ? (n + kVec - 1) / kVec : n;
  adam_kernel<G, M, SHADOW, AMAX, QUANT><<<grid_for(work), kThreads, 0, st>>>(
      static_cast<const G*>(g), static_cast<M*>(m), static_cast<M*>(v), p,
      static_cast<__nv_bfloat16*>(shadow), static_cast<int8_t*>(q), s_in,
      static_cast<unsigned int*>(amax), n, s, vec);
  return cudaGetLastError();
}

template <typename G, typename M>
cudaError_t launch_k6(const void* g, void* m, void* v, float* p, void* shadow,
                      void* amax, long long n, const AdamScalars& s,
                      cudaStream_t st) {
  if (shadow != nullptr)
    return amax != nullptr
               ? launch<G, M, true, true, false>(g, m, v, p, shadow, nullptr,
                                                 nullptr, amax, n, s, st)
               : launch<G, M, true, false, false>(g, m, v, p, shadow, nullptr,
                                                  nullptr, amax, n, s, st);
  return amax != nullptr
             ? launch<G, M, false, true, false>(g, m, v, p, shadow, nullptr,
                                                nullptr, amax, n, s, st)
             : launch<G, M, false, false, false>(g, m, v, p, shadow, nullptr,
                                                 nullptr, amax, n, s, st);
}

}  // namespace

extern "C" {

// K6 on one leaf of n elements, in place on m, v and p.  g bf16 when
// g_bf16, else float32; m and v bf16 when m_bf16, else float32.  shadow
// (bf16) and amax (one float, zeroed by the caller) may be null.
int svt_adam(const void* g, void* m, void* v, void* p, void* shadow,
             void* amax, long long n, int g_bf16, int m_bf16, float b1,
             float omb1, float b2, float omb2, float neg_lr, float eps,
             float c1, float c2, void* stream) {
  if (n < 1 || g == nullptr || m == nullptr || v == nullptr || p == nullptr)
    return int(cudaErrorInvalidValue);
  const AdamScalars s{b1, omb1, b2, omb2, neg_lr, eps, c1, c2};
  auto* pp = static_cast<float*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (g_bf16)
    return int(m_bf16 ? launch_k6<bf, bf>(g, m, v, pp, shadow, amax, n, s, st)
                      : launch_k6<bf, float>(g, m, v, pp, shadow, amax, n, s,
                                             st));
  return int(m_bf16 ? launch_k6<float, bf>(g, m, v, pp, shadow, amax, n, s, st)
                    : launch_k6<float, float>(g, m, v, pp, shadow, amax, n, s,
                                              st));
}

// K7 on one leaf: K6 with the bf16 shadow, the int8 copy q with the carried
// scale s_in (one float) and max|p'| into amax (one float, zeroed by the
// caller).
int svt_adam_emit(const void* g, void* m, void* v, void* p, void* shadow,
                  void* q, const void* s_in, void* amax, long long n,
                  int g_bf16, int m_bf16, float b1, float omb1, float b2,
                  float omb2, float neg_lr, float eps, float c1, float c2,
                  void* stream) {
  if (n < 1 || g == nullptr || m == nullptr || v == nullptr || p == nullptr ||
      shadow == nullptr || q == nullptr || s_in == nullptr || amax == nullptr)
    return int(cudaErrorInvalidValue);
  const AdamScalars s{b1, omb1, b2, omb2, neg_lr, eps, c1, c2};
  auto* pp = static_cast<float*>(p);
  const auto* si = static_cast<const float*>(s_in);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (g_bf16)
    err = m_bf16 ? launch<bf, bf, true, true, true>(g, m, v, pp, shadow, q, si,
                                                    amax, n, s, st)
                 : launch<bf, float, true, true, true>(g, m, v, pp, shadow, q,
                                                       si, amax, n, s, st);
  else
    err = m_bf16 ? launch<float, bf, true, true, true>(g, m, v, pp, shadow, q,
                                                       si, amax, n, s, st)
                 : launch<float, float, true, true, true>(g, m, v, pp, shadow,
                                                          q, si, amax, n, s,
                                                          st);
  return int(err);
}

// s = amax/127 + 1e-30 (one float each); ns, if not null, gets the same.
int svt_quant_scale(const void* amax, void* s, void* ns, void* stream) {
  if (amax == nullptr || s == nullptr) return int(cudaErrorInvalidValue);
  quant_scale_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(amax), static_cast<float*>(s),
      static_cast<float*>(ns));
  return int(cudaGetLastError());
}

// q = int8(clip(rint(p/s), -127, 127)) of `leaves` float32 leaves in one
// launch.  `table` (host memory): 4 words per leaf, the addresses of p, s
// (one float) and q and the element count n.
int svt_quantize(const void* table, int leaves, void* stream) {
  if (table == nullptr || leaves < 1 || leaves > kQuantLeaves)
    return int(cudaErrorInvalidValue);
  const auto* w = static_cast<const long long*>(table);
  QuantTable t{};
  t.leaves = leaves;
  long long chunks = 0;
  for (int i = 0; i < leaves; ++i, w += 4) {
    QuantLeaf& L = t.leaf[i];
    L.p = reinterpret_cast<const float*>(w[0]);
    L.s = reinterpret_cast<const float*>(w[1]);
    L.q = reinterpret_cast<int8_t*>(w[2]);
    L.n = w[3];
    if (L.p == nullptr || L.s == nullptr || L.q == nullptr || L.n < 1)
      return int(cudaErrorInvalidValue);
    L.begin = chunks;
    chunks += (L.n + kQuantChunk - 1) / kQuantChunk;
  }
  if (chunks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  quantize_kernel<<<unsigned(chunks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(t);
  return int(cudaGetLastError());
}

}  // extern "C"
