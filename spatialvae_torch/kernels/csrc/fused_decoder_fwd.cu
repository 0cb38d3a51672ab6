// Fused spatial-decoder tail, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spatialvae_tpu/kernels/fused_decoder.py
// `_fwd_kernel` (reached through `_fwd_pallas`), in both of its variants:
// emit_acts=False (the eval / serving forward) and emit_acts=True (the
// training forward, which also writes a_1..a_Lh for the backward).  Per
// (image b, pixel p):
//
//   a0  = tanh(x0[p]*w0[b] + x1[p]*w1[b] + c[b])     (pose-folded first layer)
//   a_l = tanh(cast(a_{l-1}) @ W_l + b_l [+ a_{l-1}])  l = 1..Lh
//   y   = sigmoid(cast(a_Lh) . wht^T + bht)
//
// where cast() rounds to the weight dtype exactly where the TPU kernel does
// (f32: identity; bf16: round-to-nearest-even) and every sum accumulates in
// f32.  The (B, HW, H) activations never leave the SM unless emitted: one
// block owns a tile of PT pixels of one image and keeps its (PT, H)
// activations in shared memory; the hidden GEMMs run on the tensor cores
// (decoder_tile.cuh: `tile_gemm`).
//
// What bounds it: the galaxy forward costs 2*HW*(H^2 + H*No) ~ 2.06 GFLOP per
// image (HW=4096, H=500, No=3) against ~50 KB of input and output, so it is
// compute-bound, and the f32 CUDA cores (67 TFLOP/s) are the wrong unit for
// it; hence TF32 tensor cores with a 3-pass split for f32 weights.  The other
// bound is W_l itself: every block streams all of it (1 MB in f32) from L2
// per layer, so the pixels per block set the L2 traffic: 64 pixels per block,
// the layer's whole (64, 512) output in registers, one activation buffer
// updated in place.  wgmma with TMA multicast across a cluster, which would
// share one W read among several blocks, is later work.
//
// Wider layers (H > 512, `fused_decoder_fwd_wide_kernel`): a (64, H) f32
// activation no longer fits beside the ring (PT = 64 at H = 1000 needs
// 257 KB), and a layer's output no longer fits in registers.  The block keeps
// the same 64 pixels, the same ring and the same register tile, but its two
// (64, Hp) activation buffers live in a per-block workspace in global memory
// (read through L1 and L2), and each layer runs in 512-column chunks that
// read the whole input buffer and write their columns of the other one, so
// no chunk overwrites what a later chunk still reads.  The workspace costs
// 2 * 64 * Hp * 4 bytes per block; the wrapper launches the images in chunks
// that bound it.  The default width compiles to the kernel above unchanged.
//
// The emitting variant adds the (Lh, B, HW, H) activation output: 819 MB at
// the galaxy shape (B=100) in f32, written from the layer epilogue's
// registers, so it costs memory bandwidth on top of the compute.  EMIT=1
// writes f32 values, EMIT=2 writes them rounded to bf16 (the training
// forward with bf16 weights: the TPU residual has the weight dtype); the
// backward's recompute path runs EMIT=1 into a workspace with either weight
// dtype, since the TPU recompute keeps f32 activations.
//
// Shapes: fold (B,4,H); coords (HW,2); whid (Lh,Hp,Hp) [in][out], zero
// outside its leading (H,H), Hp = 32*ceil(H/32); bhid (Lh,H); wht (No,H);
// bht (No); y (B,No,HW); all float32; acts (Lh,B,HW,H) float32 or bf16,
// layer l at l*act_ls elements.  H and HW are ragged (masked here).
// 1 <= Lh <= 4, 1 <= No <= 8, any H >= 1.

#include "decoder_tile.cuh"

namespace {

using namespace svt;

constexpr int PIX_PER_WARP = PT / WARPS;   // head

template <bool BF16, bool RESID, int EMIT>
__global__ void __launch_bounds__(NT, 1)
fused_decoder_fwd_kernel(const float* __restrict__ fold,
                         const float* __restrict__ coords,
                         const float* __restrict__ whid,
                         const float* __restrict__ bhid,
                         const float* __restrict__ wht,
                         const float* __restrict__ bht,
                         float* __restrict__ y, void* __restrict__ acts,
                         long long act_ls, int HW, int H, int Lh, int No,
                         int tiles) {
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
  const bool busy = warp * WN < Hp;
  for (int l = 0; l < Lh; ++l) {
    const float* bias = bhid + size_t(l) * H;
    float acc[MTILES][NTILES][4];
    tile_gemm<BF16, RESID>(act, ring, whid + size_t(l) * Hp * Hp, Hp, acc);
    if (busy) {
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = frag_col(warp, t, nt, c);  // < Hp
          const float bn = n < H ? bias[n] : 0.f;
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt) {
            const int p = frag_row(g, mt, c);
            float v = 0.f;
            if (n < H) {
              float h = acc[mt][nt][c] + bn;
              if (RESID) h += act[p * AS + n];
              v = tanhf(h);
              if (EMIT && p0 + p < HW)
                store_elem<EMIT == 2>(
                    acts, size_t(l) * act_ls + (size_t(b) * HW + p0 + p) * H
                              + n, v);
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

// The same forward for H > MAX_H: activations in the block's workspace
// slice ws + blockIdx.x * wide_block_floats(Hp) (two (PT, Hp) buffers),
// every layer and the head in 512-column chunks (see the top of the file).
template <bool BF16, bool RESID, int EMIT>
__global__ void __launch_bounds__(NT, 1)
fused_decoder_fwd_wide_kernel(const float* __restrict__ fold,
                              const float* __restrict__ coords,
                              const float* __restrict__ whid,
                              const float* __restrict__ bhid,
                              const float* __restrict__ wht,
                              const float* __restrict__ bht,
                              float* __restrict__ y, void* __restrict__ acts,
                              long long act_ls, float* __restrict__ ws,
                              int HW, int H, int Lh, int No, int tiles) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // STAGES x (BK, BNS)
  const int Hp = padded_hidden(H);
  const int as = Hp;
  float* cur = ws + size_t(blockIdx.x) * wide_block_floats(Hp);
  float* nxt = cur + size_t(PT) * as;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * PT;

  // ---- first layer, columns tid, tid + NT, ...; zero for H <= k < Hp
  const float* f = fold + size_t(b) * 4 * H;
  for (int k = tid; k < Hp; k += NT) {
    const bool on = k < H;
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
      cur[p * as + k] =
          on ? stored<BF16, RESID>(tanhf(x0 * w0 + x1 * w1 + c)) : 0.f;
    }
  }

  // ---- hidden layers: nxt = tanh(cast(cur) @ W_l + b_l (+ cur)), chunked
  for (int l = 0; l < Lh; ++l) {
    const float* bias = bhid + size_t(l) * H;
    for (int n0 = 0; n0 < wide_end(Hp); n0 += MAX_H) {
      float acc[MTILES][NTILES][4];
      tile_gemm<BF16, RESID, true>(cur, ring, whid + size_t(l) * Hp * Hp, Hp,
                                   acc, as, n0);
      if (n0 + warp * WN >= Hp) continue;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + frag_col(warp, t, nt, c);   // < Hp
          const float bn = n < H ? bias[n] : 0.f;
#pragma unroll
          for (int mt = 0; mt < MTILES; ++mt) {
            const int p = frag_row(g, mt, c);
            float v = 0.f;
            if (n < H) {
              float h = acc[mt][nt][c] + bn;
              if (RESID) h += cur[p * as + n];
              v = tanhf(h);
              if (EMIT && p0 + p < HW)
                store_elem<EMIT == 2>(
                    acts, size_t(l) * act_ls + (size_t(b) * HW + p0 + p) * H
                              + n, v);
            }
            nxt[p * as + n] = stored<BF16, RESID>(v);
          }
        }
      }
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  __syncthreads();                      // the last layer's columns written

  // ---- head as in the narrow kernel, the weights read through L1
  float part[PIX_PER_WARP][MAX_NO];
#pragma unroll
  for (int q = 0; q < PIX_PER_WARP; ++q)
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o) part[q][o] = 0.f;
  const float* arow = cur + warp * PIX_PER_WARP * as;
  for (int k = lane; k < H; k += 32) {
    float a[PIX_PER_WARP];
#pragma unroll
    for (int q = 0; q < PIX_PER_WARP; ++q) a[q] = operand<BF16>(arow[q * as + k]);
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o) {
      if (o < No) {
        const float w = __ldg(wht + size_t(o) * H + k);
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

template <bool BF16, bool RESID, int EMIT>
cudaError_t launch(const float* fold, const float* coords, const float* whid,
                   const float* bhid, const float* wht, const float* bht,
                   float* y, void* acts, long long act_ls, float* ws, int B,
                   int HW, int H, int Lh, int No, cudaStream_t stream) {
  const int tiles = (HW + PT - 1) / PT;
  const unsigned grid = unsigned(B) * unsigned(tiles);
  if (H > MAX_H) {
    auto kernel = fused_decoder_fwd_wide_kernel<BF16, RESID, EMIT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(RING_BYTES));
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, RING_BYTES, stream>>>(fold, coords, whid, bhid, wht,
                                             bht, y, acts, act_ls, ws, HW, H,
                                             Lh, No, tiles);
    return cudaGetLastError();
  }
  auto kernel = fused_decoder_fwd_kernel<BF16, RESID, EMIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      fold, coords, whid, bhid, wht, bht, y, acts, act_ls, HW, H, Lh, No,
      tiles);
  return cudaGetLastError();
}

template <bool BF16, bool RESID>
cudaError_t launch_emit(int emit, const float* fold, const float* coords,
                        const float* whid, const float* bhid,
                        const float* wht, const float* bht, float* y,
                        void* acts, long long act_ls, float* ws, int B,
                        int HW, int H, int Lh, int No, cudaStream_t st) {
  switch (emit) {
    case 0:
      return launch<BF16, RESID, 0>(fold, coords, whid, bhid, wht, bht, y,
                                    acts, act_ls, ws, B, HW, H, Lh, No, st);
    case 1:
      return launch<BF16, RESID, 1>(fold, coords, whid, bhid, wht, bht, y,
                                    acts, act_ls, ws, B, HW, H, Lh, No, st);
    default:
      return launch<BF16, RESID, 2>(fold, coords, whid, bhid, wht, bht, y,
                                    acts, act_ls, ws, B, HW, H, Lh, No, st);
  }
}

}  // namespace

extern "C" {

// Floats of workspace each block of the wide kernels (H > 512) takes, for
// the forward and for the backward's chain; 0 at H <= 512 (no workspace).
long long svt_fused_decoder_ws_block(int H) {
  return H > MAX_H ? (long long)wide_block_floats(padded_hidden(H)) : 0;
}

const char* svt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All tensors float32, whid padded to (Lh, Hp, Hp) as above; `bf16` says
// the weights hold bf16 values (widened exactly by the caller) and selects
// bf16 activation casts.  `emit` 0 writes y only; 1 also writes a_1..a_Lh
// to the float32 `acts` (layer l at l*act_ls elements, image b's rows at
// b*HW*H); 2 writes them rounded to bf16.  For H > 512, `ws` holds
// B*ceil(HW/64) * svt_fused_decoder_ws_block(H) floats.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); the caller
// checks shapes, dtypes, devices and contiguity first.
int svt_fused_decoder_fwd(const void* fold, const void* coords,
                          const void* whid, const void* bhid,
                          const void* wht, const void* bht, void* y,
                          void* acts, long long act_ls, void* ws, int B,
                          int HW, int H, int Lh, int No, int resid, int bf16,
                          int emit, void* stream) {
  if (B < 1 || HW < 1 || H < 1 || Lh < 1 || Lh > MAX_LH ||
      No < 1 || No > MAX_NO || emit < 0 || emit > 2 ||
      (emit != 0 && acts == nullptr) || (H > MAX_H && ws == nullptr) ||
      double(B) * ((HW + PT - 1) / PT) > 2147483647.0)
    return int(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(fold);
  const auto* c = static_cast<const float*>(coords);
  const auto* wh = static_cast<const float*>(whid);
  const auto* bh = static_cast<const float*>(bhid);
  const auto* wt = static_cast<const float*>(wht);
  const auto* bt = static_cast<const float*>(bht);
  auto* out = static_cast<float*>(y);
  auto* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_FWD(B16, R)                                                     \
  launch_emit<B16, R>(emit, f, c, wh, bh, wt, bt, out, acts, act_ls, w, B, \
                      HW, H, Lh, No, st)
  cudaError_t err;
  if (bf16)
    err = resid ? SVT_FWD(true, true) : SVT_FWD(true, false);
  else
    err = resid ? SVT_FWD(false, true) : SVT_FWD(false, false);
#undef SVT_FWD
  return int(err);
}

}  // extern "C"
