// Adam for Hopper (sm_90a), one launch a step over every parameter leaf:
// K6 (the update with its optional bf16 shadow and abs-max) and K7 (the
// same with the leaf's int8 copy at a carried scale), and the scales the
// int8 emission needs, in the same launch.
//
// Replaces the Pallas TPU kernels spatialvae_tpu/train/optimizer_pallas.py
// `_adam_kernel` (:53, through `_adam_leaf_pallas` :69) and
// `_adam_emit_kernel` (:129, through `_adam_emit_leaf` :181) on the
// training paths; the per-leaf kernels of adam.cu stay as its yardstick.
// Per element it computes what they compute, `adam_elem`'s operations
// (adam.cuh: `adam_leaf`'s op order, every operation rounded once), so
// every output is bit-equal to theirs and to the plain versions.
//
// What bounds it on this card: memory.  20-29 bytes a parameter move once
// (g, m, v, p in; m', v', p', the shadow and q out), against three IEEE
// divisions and a root per element.  The per-leaf kernels run a
// grid-stride loop whose next loads leave only after its stores, so the
// bytes in flight while a warp divides are the other warps' alone, and
// they take a launch per leaf (13 a galaxy step, 11 of them under 0.25 M
// elements).  Here:
//
// - One launch per step.  The host passes a table of up to kMaxLeaves
//   leaves by value (their pointers, element counts, first chunk and
//   flags); a model with more leaves takes more launches.  The types of g
//   and of the moments and the shadow are the step's and template
//   arguments; the per-leaf flags (abs-max, K7's copy, which scales to
//   write) are read at run time, so K6 and K7 leaves share the launch.
// - Persistent CTAs, one per SM, walk a chunk list: chunk c of the step
//   lies in one leaf; the leaf's first chunks cover its "bulk" part (the
//   largest multiple of kAlign elements, when every pointer of the leaf is
//   16-byte aligned) kChunk elements at a time, its other chunks the rest
//   (a tail under kAlign elements, or a whole leaf that is not aligned),
//   also kChunk at a time.  CTA b takes chunks b, b + grid, ...  Chunks of
//   4,096 elements (3 or 4 stages) ran faster on the card than chunks of
//   2,048 in 6 or 8 stages, most with bf16 arrays, whose bulk copies they
//   double; 16 consumer warps hide the division's latency a little better
//   than 8; two CTAs an SM, plain stores and one store per chunk gained
//   nothing (PERF.md, Findings).
// - Bulk chunks go through a ring of kStages stages in shared memory.
//   Warp 0 (one lane) is the producer: it waits for a stage to be free
//   and issues one bulk copy each of the chunk's g, m, v and p into it,
//   the stage's mbarrier set to expect their bytes, with an L2
//   evict-first policy (the streams never fit the 50 MB L2).  The
//   kConsumerWarps consumer warps each take a kSlice-element slice of the
//   stage: they wait on the barrier, run the update from shared memory,
//   write m', v', p' in place there and the shadow and q beside them, and
//   one lane stores the slice back with bulk stores.  A warp releases a
//   stage once `cp.async.bulk.wait_group.read` says the stores of its
//   slice have read it (checked after the next chunk's stores are issued,
//   so no warp waits on its own stores).  So the loads of the next
//   kStages - 1 chunks are in flight while a chunk is divided.
// - Other chunks (tails, unaligned leaves) are run by the consumer warps
//   with plain loads and stores in the same walk.
// - The abs-max: each warp folds |p'| of one leaf in registers and, when
//   its walk leaves the leaf, reduces across the warp and adds one
//   atomicMax on the bits (adam.cuh) to the leaf's slot.  The slots, the
//   scales and a ticket share one buffer the host zeroes once a step.
//   The last CTA to finish (a __threadfence and the ticket) computes each
//   quantised leaf's scale max/127 + 1e-30 and writes s and ns (the fresh
//   scale) or ns (K7's next scale), so no scale launch is left in a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adam.cuh"
#include "sm90.cuh"

// A faulty copy for `chip_smoke.py --limits adam` (beside adam.cuh's
// SVT_ADAM_FMA), which the bit compare must refuse: SVT_ADAM_DROP_TAIL=1
// skips the plain-load tail of every aligned leaf.
#ifndef SVT_ADAM_DROP_TAIL
#define SVT_ADAM_DROP_TAIL 0
#endif

using namespace adam;

namespace {

constexpr int kConsumerWarps = 16;
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // warp 0: producer
constexpr int kSlice = 256;                 // elements of a warp's slice
constexpr int kChunk = kSlice * kConsumerWarps;
constexpr int kAlign = 16;                  // 16 bytes of the int8 copy
constexpr int kMaxLeaves = 48;
constexpr int kMaxStages = 8;
constexpr int kSmemBytes = 226 * 1024;      // under an H100 block's 227 KiB

// per-leaf flags
constexpr int kAmax = 1;      // fold max|p'| into the leaf's slot
constexpr int kQuant = 2;     // K7: q = int8(rint(p' * (1/s_in)))
constexpr int kWriteS = 4;    // the finisher writes s = scale(max)
constexpr int kWriteNS = 8;   // ... and ns

struct Leaf {
  const void* g;
  void* m;
  void* v;
  float* p;
  __nv_bfloat16* shadow;
  int8_t* q;
  const float* s_in;
  long long n;
  long long n_bulk;   // a multiple of kAlign; 0 unless every pointer aligned
  int begin;          // the leaf's first chunk
  int flags;
};

struct StepParams {
  Leaf leaf[kMaxLeaves];
  AdamScalars s;
  // `leaves` floats each: max|p'| bits, s, ns; then the ticket
  float* aux;
  int leaves;
  int chunks;
  int finish;         // some leaf has kWriteS or kWriteNS
};
static_assert(sizeof(StepParams) <= 4096, "the leaf table is a parameter");

template <typename G, typename M, bool SHADOW>
struct Layout {
  static constexpr int kG = kChunk * int(sizeof(G));
  static constexpr int kM = kChunk * int(sizeof(M));
  static constexpr int kP = kChunk * 4;
  static constexpr int kSh = SHADOW ? kChunk * 2 : 0;
  static constexpr int kQ = kChunk;
  static constexpr int kStage = kG + 2 * kM + kP + kSh + kQ;
  static constexpr int kBars = 2 * kMaxStages * 8;
  static constexpr int kStages =
      (kSmemBytes - kBars) / kStage < kMaxStages
          ? (kSmemBytes - kBars) / kStage
          : kMaxStages;
  static constexpr int kBytes = kStages * kStage + kBars;
  static_assert(kStages >= 2, "the ring needs two stages");
};

// 4 consecutive elements of shared memory to float and back: a lane's
// four are 16 (float32) or 8 (bf16) bytes, the warp's contiguous
__device__ __forceinline__ void ld4(const float* ptr, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(ptr);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* ptr,
                                    float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(ptr);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __bfloat162float(b[i]);
}
__device__ __forceinline__ void st4(float* ptr, const float (&x)[4]) {
  *reinterpret_cast<float4*>(ptr) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* ptr, const float (&x)[4]) {
  uint2 raw;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __float2bfloat16_rn(x[i]);
  *reinterpret_cast<uint2*>(ptr) = raw;
}

// Where chunk c lies: leaf `li` (advanced from the caller's, chunks are
// walked in increasing order), its first element and its length, and
// whether it is a bulk chunk.
struct Chunk {
  long long start;
  int count;
  bool bulk;
};
__device__ __forceinline__ Chunk locate(const StepParams& P, int c,
                                        int& li) {
  while (li + 1 < P.leaves && P.leaf[li + 1].begin <= c) ++li;
  const Leaf& L = P.leaf[li];
  const long long j = c - L.begin;
  const long long nb = (L.n_bulk + kChunk - 1) / kChunk;
  Chunk k;
  k.bulk = j < nb;
  k.start = k.bulk ? j * kChunk : L.n_bulk + (j - nb) * kChunk;
  const long long end = k.bulk ? L.n_bulk : L.n;
  k.count = int(end - k.start < kChunk ? end - k.start : kChunk);
  return k;
}

template <typename G, typename M, bool SHADOW>
__global__ void __launch_bounds__(kThreads, 1)
adam_step_kernel(const __grid_constant__ StepParams P) {
  using Lay = Layout<G, M, SHADOW>;
  constexpr int S = Lay::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * Lay::kStage);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerWarps);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer: the bulk chunks' loads, one lane
    if (lane == 0) {
      const uint64_t pol = sm90::l2_evict_first();
      int li = 0, k = 0;
      for (int c = blockIdx.x; c < P.chunks; c += gridDim.x) {
        const Chunk ch = locate(P, c, li);
        if (!ch.bulk) continue;
        const int s = k % S;
        if (k >= S) sm90::mbar_wait(&empty[s], ((k / S) + 1) & 1);
        const Leaf& L = P.leaf[li];
        unsigned char* st = smem + s * Lay::kStage;
        const uint32_t n = uint32_t(ch.count);
        sm90::mbar_expect_tx(&full[s],
                             n * uint32_t(sizeof(G) + 2 * sizeof(M) + 4));
        sm90::bulk_load(st, static_cast<const G*>(L.g) + ch.start,
                        n * sizeof(G), &full[s], pol);
        sm90::bulk_load(st + Lay::kG, static_cast<const M*>(L.m) + ch.start,
                        n * sizeof(M), &full[s], pol);
        sm90::bulk_load(st + Lay::kG + Lay::kM,
                        static_cast<const M*>(L.v) + ch.start, n * sizeof(M),
                        &full[s], pol);
        sm90::bulk_load(st + Lay::kG + 2 * Lay::kM, L.p + ch.start, n * 4,
                        &full[s], pol);
        ++k;
      }
    }
  } else {
    // ---- consumers
    const int w = warp - 1;
    const int ct = threadIdx.x - 32;            // 0 .. 32 * kConsumerWarps
    const uint64_t pol = sm90::l2_evict_first();
    int li = 0, k = 0, cur = -1;
    unsigned int mx = 0u;
    float inv = 0.0f;
    for (int c = blockIdx.x; c < P.chunks; c += gridDim.x) {
      const Chunk ch = locate(P, c, li);
      const Leaf& L = P.leaf[li];
      if (li != cur) {              // the walk enters another leaf
        if (cur >= 0 && (P.leaf[cur].flags & kAmax))
          warp_atomic_max(reinterpret_cast<unsigned int*>(P.aux) + cur, mx);
        cur = li;
        mx = 0u;
        if (L.flags & kQuant) inv = __fdiv_rn(1.0f, L.s_in[0]);
      }
      const bool amax = L.flags & kAmax, quant = L.flags & kQuant;
      if (!ch.bulk) {
#if SVT_ADAM_DROP_TAIL
        if (L.n_bulk > 0) continue;
#endif
        // plain loads and stores: a tail, or a leaf that is not aligned
        const G* g = static_cast<const G*>(L.g) + ch.start;
        M* m = static_cast<M*>(L.m) + ch.start;
        M* v = static_cast<M*>(L.v) + ch.start;
        float* p = L.p + ch.start;
        for (int i = ct; i < ch.count; i += 32 * kConsumerWarps) {
          float mi = widen(m[i]), vi = widen(v[i]), pi = p[i];
          adam_elem(widen(g[i]), mi, vi, pi, P.s);
          m[i] = narrow<M>(mi);
          v[i] = narrow<M>(vi);
          p[i] = pi;
          if (SHADOW) L.shadow[ch.start + i] = __float2bfloat16_rn(pi);
          if (quant) L.q[ch.start + i] = adam::quant(__fmul_rn(pi, inv));
          if (amax) mx = max(mx, abs_bits(pi));
        }
        continue;
      }
      const int s = k % S;
      sm90::mbar_wait(&full[s], (k / S) & 1);
      unsigned char* st = smem + s * Lay::kStage;
      const G* sg = reinterpret_cast<const G*>(st);
      M* sm_ = reinterpret_cast<M*>(st + Lay::kG);
      M* sv = reinterpret_cast<M*>(st + Lay::kG + Lay::kM);
      float* sp = reinterpret_cast<float*>(st + Lay::kG + 2 * Lay::kM);
      __nv_bfloat16* ssh =
          reinterpret_cast<__nv_bfloat16*>(st + Lay::kG + 2 * Lay::kM +
                                           Lay::kP);
      int8_t* sq = reinterpret_cast<int8_t*>(st + Lay::kG + 2 * Lay::kM +
                                             Lay::kP + Lay::kSh);
      const int base = w * kSlice;
      const int left = ch.count - base;
      const int len = left < 0 ? 0 : (left < kSlice ? left : kSlice);
      constexpr int R = kSlice / 128;       // rounds of 4 elements a lane
      float gg[R][4], mm[R][4], vv[R][4], pp[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = base + r * 128 + lane * 4;
        if (e - base < len) {       // len is a multiple of kAlign
          ld4(sg + e, gg[r]);
          ld4(sm_ + e, mm[r]);
          ld4(sv + e, vv[r]);
          ld4(sp + e, pp[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = base + r * 128 + lane * 4;
        if (e - base < len) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            adam_elem(gg[r][i], mm[r][i], vv[r][i], pp[r][i], P.s);
          st4(sm_ + e, mm[r]);
          st4(sv + e, vv[r]);
          st4(sp + e, pp[r]);
          if (SHADOW) st4(ssh + e, pp[r]);
          if (quant) {
            uint32_t word;
            int8_t* b = reinterpret_cast<int8_t*>(&word);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              b[i] = adam::quant(__fmul_rn(pp[r][i], inv));
            *reinterpret_cast<uint32_t*>(sq + e) = word;
          }
          if (amax) {
#pragma unroll
            for (int i = 0; i < 4; ++i) mx = max(mx, abs_bits(pp[r][i]));
          }
        }
      }
      // the slice back to global memory: every lane's writes made visible
      // to the bulk copies, then one lane stores and closes its group
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (len > 0) {
          const long long at = ch.start + base;
          const uint32_t n = uint32_t(len);
          sm90::bulk_store(static_cast<M*>(L.m) + at, sm_ + base,
                           n * sizeof(M), pol);
          sm90::bulk_store(static_cast<M*>(L.v) + at, sv + base,
                           n * sizeof(M), pol);
          sm90::bulk_store(L.p + at, sp + base, n * 4, pol);
          if (SHADOW)
            sm90::bulk_store(L.shadow + at, ssh + base, n * 2, pol);
          if (quant) sm90::bulk_store(L.q + at, sq + base, n, pol);
        }
        sm90::bulk_commit();
        // the previous chunk's stores have read their stage: release it
        sm90::bulk_wait_read<1>();
        if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % S]);
      }
      ++k;
    }
    if (cur >= 0 && (P.leaf[cur].flags & kAmax))
      warp_atomic_max(reinterpret_cast<unsigned int*>(P.aux) + cur, mx);
    if (lane == 0) sm90::bulk_wait<0>();      // the last stores written
  }

  // ---- the finisher: the last CTA writes the scales
  if (!P.finish) return;
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned int* ticket =
        reinterpret_cast<unsigned int*>(P.aux) + 3 * P.leaves;
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < P.leaves; i += kThreads) {
    const int f = P.leaf[i].flags;
    if (!(f & (kWriteS | kWriteNS))) continue;
    const float a = __uint_as_float(
        __ldcg(reinterpret_cast<const unsigned int*>(P.aux) + i));
    const float v = scale_of(a);
    if (f & kWriteS) P.aux[P.leaves + i] = v;
    if (f & kWriteNS) P.aux[2 * P.leaves + i] = v;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The kernel's dynamic shared memory allowed, once per instantiation.
template <typename G, typename M, bool SHADOW>
cudaError_t prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      adam_step_kernel<G, M, SHADOW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<G, M, SHADOW>::kBytes);
  return e;
}

template <typename G, typename M, bool SHADOW>
cudaError_t launch(const StepParams& P, cudaStream_t st) {
  using Lay = Layout<G, M, SHADOW>;
  const cudaError_t e = prepare<G, M, SHADOW>();
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int grid = P.chunks < 1 ? 1 : (P.chunks < sms ? P.chunks : sms);
  adam_step_kernel<G, M, SHADOW><<<grid, kThreads, Lay::kBytes, st>>>(P);
  return cudaGetLastError();
}

template <typename G, typename M>
cudaError_t launch_shadow(const StepParams& P, int shadow, cudaStream_t st) {
  return shadow ? launch<G, M, true>(P, st) : launch<G, M, false>(P, st);
}

template <typename G, typename M, bool SHADOW>
void info(int* out) {
  using Lay = Layout<G, M, SHADOW>;
  out[0] = Lay::kStages;
  out[1] = Lay::kBytes;
  out[2] = kChunk;
  out[3] = 0;
  if (prepare<G, M, SHADOW>() != cudaSuccess) return;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], adam_step_kernel<G, M, SHADOW>, kThreads, Lay::kBytes);
}

}  // namespace

extern "C" {

// One step of Adam over `leaves` leaves in one launch.  `table` (host
// memory): 10 words per leaf, the addresses of g, m, v, p, the shadow (or
// 0), q (or 0) and s_in (or 0), the element count n, the bulk count
// n_bulk, and begin | flags << 32 (its first chunk and its flags: 1 the
// abs-max, 2 K7's copy, 4 write s, 8 write ns).  `aux`: 3 * leaves + 1
// floats, zeroed (the abs-max slots, s, ns, the ticket), or null when no
// leaf takes the abs-max.  g bf16 when g_bf16, else float32; m and v bf16
// when m_bf16; `shadow`: every leaf has a bf16 shadow.  Refuses a table
// whose plan is not the one the kernel walks.
int svt_adam_step(const void* table, int leaves, void* aux, int g_bf16,
                  int m_bf16, int shadow, float b1, float omb1, float b2,
                  float omb2, float neg_lr, float eps, float c1, float c2,
                  void* stream) {
  if (table == nullptr || leaves < 1 || leaves > kMaxLeaves)
    return int(cudaErrorInvalidValue);
  const auto* w = static_cast<const long long*>(table);
  StepParams P{};
  P.s = AdamScalars{b1, omb1, b2, omb2, neg_lr, eps, c1, c2};
  P.aux = static_cast<float*>(aux);
  P.leaves = leaves;
  long long chunks = 0;
  int any_amax = 0;
  for (int i = 0; i < leaves; ++i, w += 10) {
    Leaf& L = P.leaf[i];
    L.g = reinterpret_cast<const void*>(w[0]);
    L.m = reinterpret_cast<void*>(w[1]);
    L.v = reinterpret_cast<void*>(w[2]);
    L.p = reinterpret_cast<float*>(w[3]);
    L.shadow = reinterpret_cast<__nv_bfloat16*>(w[4]);
    L.q = reinterpret_cast<int8_t*>(w[5]);
    L.s_in = reinterpret_cast<const float*>(w[6]);
    L.n = w[7];
    L.n_bulk = w[8];
    L.begin = int(w[9] & 0xffffffffLL);
    L.flags = int(w[9] >> 32);
    const bool quant = L.flags & kQuant;
    if (L.n < 0 || L.n_bulk < 0 || L.n_bulk > L.n || L.n_bulk % kAlign ||
        L.g == nullptr || L.m == nullptr || L.v == nullptr ||
        L.p == nullptr || (shadow != 0) != (L.shadow != nullptr) ||
        quant != (L.q != nullptr) || quant != (L.s_in != nullptr) ||
        ((L.flags & (kWriteS | kWriteNS)) && !(L.flags & kAmax)) ||
        L.begin != chunks)
      return int(cudaErrorInvalidValue);
    if (L.n_bulk > 0 &&
        !(aligned16(L.g) && aligned16(L.m) && aligned16(L.v) &&
          aligned16(L.p) && (L.shadow == nullptr || aligned16(L.shadow)) &&
          (L.q == nullptr || aligned16(L.q))))
      return int(cudaErrorInvalidValue);
    chunks += (L.n_bulk + kChunk - 1) / kChunk +
              (L.n - L.n_bulk + kChunk - 1) / kChunk;
    any_amax |= L.flags & kAmax;
    P.finish |= (L.flags & (kWriteS | kWriteNS)) != 0;
  }
  if (chunks > 0x7fffffffLL || (any_amax && aux == nullptr))
    return int(cudaErrorInvalidValue);
  P.chunks = int(chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (g_bf16)
    err = m_bf16 ? launch_shadow<bf, bf>(P, shadow, st)
                 : launch_shadow<bf, float>(P, shadow, st);
  else
    err = m_bf16 ? launch_shadow<float, bf>(P, shadow, st)
                 : launch_shadow<float, float>(P, shadow, st);
  return int(err);
}

// The step kernel of (g_bf16, m_bf16, shadow): its ring's stages, its
// dynamic shared memory, its chunk and the CTAs an SM holds at once.
int svt_adam_step_info(int g_bf16, int m_bf16, int shadow, int* out) {
  using bf = __nv_bfloat16;
  if (g_bf16)
    m_bf16 ? (shadow ? info<bf, bf, true>(out) : info<bf, bf, false>(out))
           : (shadow ? info<bf, float, true>(out)
                     : info<bf, float, false>(out));
  else
    m_bf16 ? (shadow ? info<float, bf, true>(out)
                     : info<float, bf, false>(out))
           : (shadow ? info<float, float, true>(out)
                     : info<float, float, false>(out));
  return int(cudaGetLastError());
}

}  // extern "C"
