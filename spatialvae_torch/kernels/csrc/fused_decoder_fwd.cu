// Fused spatial-decoder tail, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spatialvae_tpu/kernels/fused_decoder.py
// `_fwd_kernel` (reached through `_fwd_pallas` and `fused_decoder_tail`) with
// emit_acts=False: the eval / serving forward.  Per (image b, pixel p):
//
//   a0  = tanh(x0[p]*w0[b] + x1[p]*w1[b] + c[b])     (pose-folded first layer)
//   a_l = tanh(cast(a_{l-1}) @ W_l + b_l [+ a_{l-1}])  l = 1..Lh
//   y   = sigmoid(cast(a_Lh) . wht^T + bht)
//
// where cast() rounds to the weight dtype exactly where the TPU kernel does
// (f32: identity; bf16: round-to-nearest-even) and every sum accumulates in
// f32.  The (B, HW, H) activations never leave the SM: one block owns a tile
// of PT pixels of one image and keeps its (PT, H) activations in shared
// memory; only the (B, No, HW) output is written.
//
// What bounds it: the galaxy forward costs 2*HW*(H^2 + H*No) ~ 2.06 GFLOP per
// image (HW=4096, H=500, No=3) against ~50 KB of input and output, so it is
// compute-bound, and the f32 CUDA cores (67 TFLOP/s) are the wrong unit for
// it.  The hidden GEMMs run on the tensor cores with mma.sync m16n8k8 TF32:
//   - f32 weights: each operand is split into a TF32 head and a TF32 tail
//     (x = hi + lo) and the product is hi*hi + hi*lo + lo*hi, three passes
//     that keep about f32 accuracy;
//   - bf16 weights (passed here already widened to f32, which is exact): a
//     bf16 value is exact in TF32, so one pass computes exactly the
//     bf16-operand, f32-accumulate product.
// The other bound is W_l itself: every block streams all of it (1 MB in f32)
// from L2 per layer, so the pixels per block set the L2 traffic.  A block
// takes 64 pixels and holds the layer's whole (64, 512) output in registers
// (each of the 16 warps owns 32 columns: 4 x 4 m16n8 tiles), so the single
// activation buffer is updated in place and H is capped at 512.  W_l, which
// the caller pads to (Hp, Hp), streams through a 3-stage ring of 16-row
// shared-memory slabs in 16-byte cp.async copies, one barrier per two
// k8-steps.  Row strides are padded so every fragment load of a warp hits
// 32 distinct banks.  wgmma with TMA multicast across a cluster, which would
// share one W read among several blocks, is later work.
//
// Shapes: fold (B,4,H); coords (HW,2); whid (Lh,Hp,Hp) [in][out], zero
// outside its leading (H,H), Hp = 32*ceil(H/32); bhid (Lh,H); wht (No,H);
// bht (No); y (B,No,HW); all float32.  H and HW are ragged (masked here).
// 1 <= Lh <= 4, 1 <= No <= 8, H <= MAX_H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PT = 64;                 // pixels per block: four m16 tiles
constexpr int NT = 512;                // threads per block: 16 warps
constexpr int WARPS = NT / 32;
constexpr int MAX_H = 512;             // the layer output fits in registers
constexpr int WN = MAX_H / WARPS;      // columns per warp
constexpr int MTILES = PT / 16;
constexpr int NTILES = WN / 8;
constexpr int BK = 16;                 // W rows per slab: two k8-steps
constexpr int STAGES = 3;              // slabs in flight
constexpr int BNS = MAX_H + 8;         // slab row stride: conflict-free B frags
constexpr int AS = MAX_H + 4;          // activation row stride: same for A
constexpr int MAX_NO = 8;
constexpr int MAX_LH = 4;
constexpr int PIX_PER_WARP = PT / WARPS;   // head
constexpr size_t SMEM_BYTES =
    (size_t(PT) * AS + size_t(STAGES) * BK * BNS) * sizeof(float);
static_assert(NT == MAX_H, "the first layer takes one column per thread");
static_assert(MAX_NO * MAX_H <= STAGES * BK * BNS, "head weights fit the ring");
static_assert(SMEM_BYTES <= 232448, "opt-in shared memory per block on sm_90");

__host__ __device__ constexpr int padded_hidden(int h) {
  return (h + 31) / 32 * 32;
}

// The activation cast before each product (the TPU kernel's
// `a.astype(w.dtype)`): identity for f32 weights, round-to-nearest-even to
// bf16 for bf16 weights.
template <bool BF16>
__device__ __forceinline__ float operand(float a) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(a)) : a;
}

// Where the cast happens.  With bf16 weights and no residual add the f32
// activation is never read again, so it is rounded once when stored; with
// the residual add the f32 value stays in shared memory for the add and is
// rounded at each read.  (Rounding is idempotent, so a second cast is
// harmless.)
template <bool BF16, bool RESID>
__device__ __forceinline__ float stored(float v) {
  return (BF16 && !RESID) ? operand<BF16>(v) : v;
}
template <bool BF16, bool RESID>
__device__ __forceinline__ float loaded(float v) {
  return (BF16 && !RESID) ? v : operand<BF16>(v);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with both parts TF32 (about 21 significant bits together)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy that bypasses registers and L1
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool BF16, bool RESID>
__global__ void __launch_bounds__(NT, 1)
fused_decoder_fwd_kernel(const float* __restrict__ fold,
                         const float* __restrict__ coords,
                         const float* __restrict__ whid,
                         const float* __restrict__ bhid,
                         const float* __restrict__ wht,
                         const float* __restrict__ bht,
                         float* __restrict__ y,
                         int HW, int H, int Lh, int No, int tiles) {
  // f32 weights need the three-pass split; bf16 values are exact in TF32
  constexpr bool SPLIT = !BF16;
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);   // (PT, AS), pixel-major
  float* ring = act + PT * AS;                    // STAGES x (BK, BNS)
  const int Hp = padded_hidden(H);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * PT;

  // ---- first layer from the fold rows, one column per thread.  Columns
  // H <= k < Hp are zero so the padded K range of every GEMM adds nothing;
  // columns k >= Hp are never read.
  if (tid < Hp) {
    const int k = tid;
    const bool on = k < H;
    const float* f = fold + size_t(b) * 4 * H;
    const float w0 = on ? f[k] : 0.f;
    const float w1 = on ? f[H + k] : 0.f;
    const float c = on ? f[2 * H + k] : 0.f;
#pragma unroll 4
    for (int p = 0; p < PT; ++p) {
      const int pix = p0 + p;
      float x0 = 0.f, x1 = 0.f;
      if (pix < HW) {
        x0 = coords[2 * pix];
        x1 = coords[2 * pix + 1];
      }
      act[p * AS + k] =
          on ? stored<BF16, RESID>(tanhf(x0 * w0 + x1 * w1 + c)) : 0.f;
    }
  }

  // ---- hidden layers: act = tanh(cast(act) @ W_l + b_l (+ act)) in place
  const int nslab = Hp / BK;
  const bool busy = warp * WN < Hp;   // warps past Hp own only padding
  for (int l = 0; l < Lh; ++l) {
    const float* W = whid + size_t(l) * Hp * Hp;
    const float* bias = bhid + size_t(l) * H;
    auto fill = [&](int slab) {
      if (slab < nslab) {
        float* dst = ring + (slab % STAGES) * BK * BNS;
        const float* src = W + size_t(slab) * BK * Hp;
#pragma unroll
        for (int j = 0; j < BK * MAX_H / 4 / NT; ++j) {
          const int i = tid + j * NT;
          const int r = i / (MAX_H / 4), c = (i % (MAX_H / 4)) * 4;
          if (c < Hp) cp_async16(dst + r * BNS + c, src + size_t(r) * Hp + c);
        }
      }
      cp_async_commit();  // empty groups keep the wait count uniform
    };
    float acc[MTILES][NTILES][4];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

    __syncthreads();                    // act written, ring free
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fill(s);
    for (int j = 0; j < nslab; ++j) {
      cp_async_wait<STAGES - 2>();      // slab j has landed (this thread)
      __syncthreads();                  // ... for every thread; slab j-1 free
      fill(j + STAGES - 1);             // refills slab j-1's stage
      if (!busy) continue;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        const float* bp =
            ring + (j % STAGES) * BK * BNS + (kk + t) * BNS + warp * WN + g;
        uint32_t bhi[NTILES][2], blo[NTILES][2];
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt) {
          const float v0 = bp[nt * 8], v1 = bp[4 * BNS + nt * 8];
          if (SPLIT) {
            split(v0, bhi[nt][0], blo[nt][0]);
            split(v1, bhi[nt][1], blo[nt][1]);
          } else {
            bhi[nt][0] = __float_as_uint(v0);
            bhi[nt][1] = __float_as_uint(v1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTILES; ++mt) {
          const float* ap = act + (mt * 16 + g) * AS + j * BK + kk + t;
          const float av[4] = {ap[0], ap[8 * AS], ap[4], ap[8 * AS + 4]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float x = loaded<BF16, RESID>(av[c]);
            if (SPLIT)
              split(x, ahi[c], alo[c]);
            else
              ahi[c] = __float_as_uint(x);
          }
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt) {
            if (SPLIT) {
              mma_tf32(acc[mt][nt], alo, bhi[nt][0], bhi[nt][1]);
              mma_tf32(acc[mt][nt], ahi, blo[nt][0], blo[nt][1]);
            }
            mma_tf32(acc[mt][nt], ahi, bhi[nt][0], bhi[nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();                 // drain the (empty) tail groups
    __syncthreads();                    // every read of act done: update it

    if (busy) {
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = warp * WN + nt * 8 + 2 * t + (c & 1);  // < Hp
          const float bn = n < H ? bias[n] : 0.f;
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt) {
            const int p = mt * 16 + g + (c >> 1) * 8;
            float v = 0.f;
            if (n < H) {
              float h = acc[mt][nt][c] + bn;
              if (RESID) h += act[p * AS + n];
              v = tanhf(h);
            }
            act[p * AS + n] = stored<BF16, RESID>(v);
          }
        }
      }
    }
  }

  // ---- head: z[o, p] = sum_k wht[o, k] * cast(a[p, k]) + bht[o].  The
  // head weights go to the (now free) ring; warp w takes pixels
  // 4w .. 4w+3, lanes split k, a shuffle tree sums the lanes.
  float* wsm = ring;                    // (MAX_NO, MAX_H)
  for (int i = tid; i < No * MAX_H; i += NT) {
    const int o = i / MAX_H, k = i % MAX_H;
    wsm[i] = k < H ? wht[size_t(o) * H + k] : 0.f;
  }
  __syncthreads();                      // head weights and last layer in
  float part[PIX_PER_WARP][MAX_NO];
#pragma unroll
  for (int q = 0; q < PIX_PER_WARP; ++q)
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o) part[q][o] = 0.f;
  const float* arow = act + warp * PIX_PER_WARP * AS;
  for (int k = lane; k < H; k += 32) {
    float a[PIX_PER_WARP];
#pragma unroll
    for (int q = 0; q < PIX_PER_WARP; ++q) a[q] = operand<BF16>(arow[q * AS + k]);
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o) {
      if (o < No) {
        const float w = wsm[o * MAX_H + k];
#pragma unroll
        for (int q = 0; q < PIX_PER_WARP; ++q)
          part[q][o] = fmaf(w, a[q], part[q][o]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PIX_PER_WARP; ++q) {
    const int pix = p0 + warp * PIX_PER_WARP + q;
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o) {
      if (o >= No) break;
      float z = part[q][o];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        z += __shfl_xor_sync(0xffffffffu, z, off);
      if (lane == 0 && pix < HW)
        y[(size_t(b) * No + o) * HW + pix] = 1.f / (1.f + expf(-(z + bht[o])));
    }
  }
}

template <bool BF16, bool RESID>
cudaError_t launch(const float* fold, const float* coords, const float* whid,
                   const float* bhid, const float* wht, const float* bht,
                   float* y, int B, int HW, int H, int Lh, int No,
                   cudaStream_t stream) {
  auto kernel = fused_decoder_fwd_kernel<BF16, RESID>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int tiles = (HW + PT - 1) / PT;
  kernel<<<unsigned(B) * unsigned(tiles), NT, SMEM_BYTES, stream>>>(
      fold, coords, whid, bhid, wht, bht, y, HW, H, Lh, No, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest hidden layer the kernel takes (its output must fit in registers).
int svt_fused_decoder_max_hidden() { return MAX_H; }

const char* svt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All tensors float32, whid padded to (Lh, Hp, Hp) as above; `bf16` says
// the weights hold bf16 values (widened exactly by the caller) and selects
// bf16 activation casts.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks shapes, dtypes,
// devices and contiguity first.
int svt_fused_decoder_fwd(const void* fold, const void* coords,
                          const void* whid, const void* bhid,
                          const void* wht, const void* bht, void* y,
                          int B, int HW, int H, int Lh, int No, int resid,
                          int bf16, void* stream) {
  if (B < 1 || HW < 1 || H < 1 || H > MAX_H || Lh < 1 || Lh > MAX_LH ||
      No < 1 || No > MAX_NO ||
      double(B) * ((HW + PT - 1) / PT) > 2147483647.0)
    return int(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  const auto* wh = static_cast<const float*>(whid);
  const auto* bh = static_cast<const float*>(bhid);
  const auto* wt = static_cast<const float*>(wht);
  const auto* bt = static_cast<const float*>(bht);
  auto* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = resid ? launch<true, true>(f, c, wh, bh, wt, bt, out, B, HW, H, Lh,
                                     No, st)
                : launch<true, false>(f, c, wh, bh, wt, bt, out, B, HW, H,
                                      Lh, No, st);
  else
    err = resid ? launch<false, true>(f, c, wh, bh, wt, bt, out, B, HW, H,
                                      Lh, No, st)
                : launch<false, false>(f, c, wh, bh, wt, bt, out, B, HW, H,
                                       Lh, No, st);
  return int(err);
}

}  // extern "C"
