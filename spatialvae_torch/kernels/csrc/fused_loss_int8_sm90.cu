// K3's cluster passes at the default numerics (the pass bodies and their
// design are in fused_loss_int8_sm90.cuh; the stochastic-rounding
// instantiations in fused_loss_int8_sm90_sr.cu), their dW1 kernel, the
// pieces the card tests hold alone, and the C entry points of the passes'
// helpers.

#include "fused_loss_int8_sm90.cuh"

namespace {

template <bool BF16, bool COLORED>
__global__ void __launch_bounds__(NT, 1)
loss_fwd90_kernel(const LossFwdArgs a, int nquads) {
  loss_fwd90_body<BF16, COLORED, false>(a, nquads);
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 1)
loss_grad90_kernel(const LossGradArgs a, int nquads) {
  loss_grad90_body<BF16, false>(a, nquads);
}

// ---- dW1 from the workspaces on clusters of 2 x 2 output tiles of
// (128, 128): CTA rank r takes i-tile 2 (sup / 2) + r % 2 and j-tile
// 2 (sup % 2) + r / 2 of the split blockIdx.y (sup = blockIdx.x / 4).  The
// aq rows of an i-tile go to the two CTAs that share it, each fetching one
// half and multicasting it; the qi rows of a j-tile the same.  Each group's
// exact int32 product times gscale[group] is added to the f32 sum before
// the next group starts: grouped_dw's op order, so its partials are
// the same bit for bit.  A stage holds DW_BLK 64-pixel blocks (a group is
// a multiple of 256 pixels, so no stage straddles two).
__global__ void __launch_bounds__(DW_NT, 1)
grouped_dw90_kernel(const int8_t* __restrict__ aq_ws,
                    const int8_t* __restrict__ q_ws,
                    const float* __restrict__ gscale,
                    float* __restrict__ part, int nimg, int blocks, int H,
                    int Pt, int gpi, int gps) {
  extern __shared__ __align__(128) uint8_t smem90[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int ci = rank & 1, cj = rank >> 1;
  const int sup = blockIdx.x / CS;
  const int i0 = (2 * (sup >> 1) + ci) * 128, j0 = (2 * (sup & 1) + cj) * 128;
  const int G = nimg * gpi;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(G, g0 + gps);
  const int bpg = Pt / PT;
  const int total = max(0, g1 - g0) * bpg / DW_BLK;
  const uint16_t mask_a = uint16_t((1u << ci) | (1u << (ci + 2)));
  const uint16_t mask_b = uint16_t(3u << (2 * cj));

  auto fetch = [&](int idx) {
    const int st = idx % DW_STAGES;
    if (idx >= DW_STAGES)
      mbar_wait(&sm.empty[st], uint32_t(idx / DW_STAGES - 1) & 1u);
    mbar_expect_tx(&sm.full[st], DW_STAGE);
    for (int q = 0; q < DW_BLK; ++q) {
      const int kb = DW_BLK * idx + q;
      const int gi = g0 + kb / bpg;
      const size_t base =
          (size_t(gi / gpi) * blocks + (gi % gpi) * bpg + kb % bpg) *
          WS_BLOCK;
      int8_t* dst = sm.ring[st] + q * DW_OP;
      bulk_multicast(dst + cj * (DW_OP / 2),
                     aq_ws + base + i0 * PT + cj * (DW_OP / 2),
                     DW_OP / 2, &sm.full[st], mask_a);
      bulk_multicast(dst + DW_BLK * DW_OP + ci * (DW_OP / 2),
                     q_ws + base + j0 * PT + ci * (DW_OP / 2),
                     DW_OP / 2, &sm.full[st], mask_b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], DW_WARPS * CS);
    }
    fence_mbar_init();
  }
  cluster_sync();
  if (tid == 0)
    for (int s = 0; s < DW_STAGES && s < total; ++s) fetch(s);

  int acc[64];
  float facc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0;
    facc[j] = 0.f;
  }
  for (int idx = 0; idx < total; ++idx) {
    const int st = idx % DW_STAGES;
    mbar_wait(&sm.full[st], uint32_t(idx / DW_STAGES) & 1u);
    const bool first = (DW_BLK * idx) % bpg == 0;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < DW_BLK; ++q)
#pragma unroll
      for (int kk = 0; kk < PT; kk += 32) {
        const int8_t* A = sm.ring[st] + q * DW_OP + wg * (DW_OP / 2);
        const int8_t* Bm = sm.ring[st] + (DW_BLK + q) * DW_OP;
        wgmma_s8_n128(acc, gmma_desc_sw64(A + kk), gmma_desc_sw64(Bm + kk),
                      first && q == 0 && kk == 0 ? 0 : 1);
      }
    wgmma_commit();
    wgmma_wait<1>();                       // the previous stage is read
    if (idx > 0) {
      release_cluster(&sm.empty[(idx - 1) % DW_STAGES], CS);
      if (tid == 0 && idx - 1 + DW_STAGES < total) fetch(idx - 1 + DW_STAGES);
    }
    if ((DW_BLK * idx + DW_BLK - 1) % bpg == bpg - 1) {  // group complete
      wgmma_wait<0>();
      fence_operands(acc);
      const float s = gscale[g0 + (DW_BLK * idx) / bpg];
#pragma unroll
      for (int j = 0; j < 64; ++j)
        facc[j] = __fadd_rn(facc[j], __fmul_rn(float(acc[j]), s));
    }
  }
  float* out = part + size_t(blockIdx.y) * H * H;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int i = i0 + 64 * wg + 16 * w + g + 8 * ((j >> 1) & 1);
    const int jj = j0 + 8 * (j >> 2) + 2 * t + (j & 1);
    if (i < H && jj < H) out[size_t(i) * H + jj] = facc[j];
  }
  cluster_sync();
}

// ---- the products alone, for the card tests: out (ntiles, 64, 512) int32
// = a (ntiles, 64, 512) int8 . W^T, W given as its slab stream (Kp / 64
// slabs), on the loss kernels' ring, clusters and wgmma.
__global__ void __launch_bounds__(NT, 1)
tile_product90_kernel(const int8_t* __restrict__ a_in,
                      const int8_t* __restrict__ wslabs, int* __restrict__ out,
                      int Kp, int nquads) {
  extern __shared__ __align__(128) uint8_t smem90[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  const int ntl = cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
  const int nslab = Kp / SB;
  const Ring<FWD_STAGES> ring{sm.ring, sm.full, sm.empty, wslabs, nslab,
                              ntl * nslab, cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();
  for (int k = 0; k < ntl; ++k) {
    const int tb = (cid + k * ncl) * CS + int(ring.rank);
    __syncthreads();
    for (int i = tid; i < TILE_B / 4; i += NT) {
      const int p = i / (KW / 4), c = 4 * (i % (KW / 4));
      *reinterpret_cast<uint32_t*>(sm.aq[0] + tile_off(p, c)) =
          *reinterpret_cast<const uint32_t*>(a_in + size_t(tb) * TILE_B +
                                             p * KW + c);
    }
    fence_proxy_async();
    __syncthreads();
    int acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    ring_product(acc, sm.aq[0], ring, k * nslab, nslab, wg, [](int) {});
#pragma unroll
    for (int j = 0; j < 64; ++j)
      out[size_t(tb) * PT * KW + (16 * w + g + 8 * ((j >> 1) & 1)) * KW +
          acc_col(wg, t, j)] = acc[j];
  }
  cluster_sync();
}

// q7_fast against q7 at every float input (all 2^32 bit patterns): out
// (one unsigned long long) counts those where they differ.
__global__ void __launch_bounds__(256)
chain_check90_kernel(unsigned long long* out) {
  __shared__ float thr[8];
  q7_thresholds(thr);
  __syncthreads();
  unsigned long long n = 0;
  const uint64_t stride = uint64_t(gridDim.x) * blockDim.x;
  for (uint64_t i = uint64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (uint64_t(1) << 32); i += stride) {
    const float x = __uint_as_float(uint32_t(i));
    n += float(q7_fast(x, thr)) != q7(x);
  }
  if (n) atomicAdd(out, n);
}

int fwd_clusters(bool bf16, bool colored = false) {
  static int c[4] = {0, 0, 0, 0};
  int* at = &c[2 * colored + bf16];
  if (colored)
    return bf16 ? cached_clusters(loss_fwd90_kernel<true, true>, NT,
                                  sizeof(FwdSmem), at)
                : cached_clusters(loss_fwd90_kernel<false, true>, NT,
                                  sizeof(FwdSmem), at);
  return bf16 ? cached_clusters(loss_fwd90_kernel<true, false>, NT,
                                sizeof(FwdSmem), at)
              : cached_clusters(loss_fwd90_kernel<false, false>, NT,
                                sizeof(FwdSmem), at);
}
int grad_clusters(bool bf16) {
  static int c[2] = {0, 0};
  return bf16 ? cached_clusters(loss_grad90_kernel<true>, NT,
                                sizeof(GradSmem), &c[1])
              : cached_clusters(loss_grad90_kernel<false>, NT,
                                sizeof(GradSmem), &c[0]);
}
int dw_clusters() {
  static int c = 0;
  return cached_clusters(grouped_dw90_kernel, DW_NT, sizeof(DwSmem), &c);
}
int product_clusters() {
  static int c = 0;
  return cached_clusters(tile_product90_kernel, NT, sizeof(FwdSmem), &c);
}

}  // namespace

namespace svt8 {

cudaError_t loss_fwd_sm90(const LossFwdArgs& a, bool bf16, cudaStream_t st) {
  if (a.ws == nullptr) return cudaErrorInvalidValue;     // the a1c stash
  const bool colored = a.family == COLORED;
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, fwd_clusters(bf16, colored));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  const unsigned grid = unsigned(ncl * CS);
  const int smem = sizeof(FwdSmem);
  if (colored)
    return bf16 ? launch_clusters(loss_fwd90_kernel<true, true>, grid, NT,
                                  smem, CS, st, a, nquads)
                : launch_clusters(loss_fwd90_kernel<false, true>, grid, NT,
                                  smem, CS, st, a, nquads);
  return bf16 ? launch_clusters(loss_fwd90_kernel<true, false>, grid, NT,
                                smem, CS, st, a, nquads)
              : launch_clusters(loss_fwd90_kernel<false, false>, grid, NT,
                                smem, CS, st, a, nquads);
}

cudaError_t loss_grad_sm90(const LossGradArgs& a, bool bf16,
                           cudaStream_t st) {
  if (a.ws == nullptr) return cudaErrorInvalidValue;     // the a1c stash
  const int nquads = int(a.grid / CS);
  const int ncl = min(nquads, grad_clusters(bf16));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return bf16 ? launch_clusters(loss_grad90_kernel<true>, unsigned(ncl * CS),
                                NT, sizeof(GradSmem), CS, st, a, nquads)
              : launch_clusters(loss_grad90_kernel<false>,
                                unsigned(ncl * CS), NT, sizeof(GradSmem), CS,
                                st, a, nquads);
}

}  // namespace svt8

extern "C" {

// The dW1 partials of K3's cluster passes from their workspaces (nimg
// images of HW/64 blocks of WS_BLOCK bytes each; past H = 512 of 64 x R
// bytes, the wide passes' rows, fused_loss_int8_sm90_wide.cu): `splits`
// partials (H, H) f32 in part, groups spread over the splits as
// svt_int8_grouped_dw spreads them.  Pt: pixels per group, a multiple of
// 256 dividing HW.
int svt_loss90_dw(const void* aq_ws, const void* q_ws, const void* gscale,
                  void* part, int nimg, int HW, int H, int Pt, int splits,
                  void* stream) {
  if (nimg < 1 || H < 1 || HW < 1 || HW % (CS * PT) ||
      Pt < DW_BLK * PT || Pt % (DW_BLK * PT) || HW % Pt || splits < 1 ||
      splits > 65535)
    return int(cudaErrorInvalidValue);
  if (H > KW)                     // the R-row workspaces of the wide passes
    return int(svt8::loss90_dw_wide(
        static_cast<const int8_t*>(aq_ws), static_cast<const int8_t*>(q_ws),
        static_cast<const float*>(gscale), static_cast<float*>(part), nimg,
        HW, H, Pt, splits, static_cast<cudaStream_t>(stream)));
  const int gpi = HW / Pt;
  const int G = nimg * gpi;
  const int gps = (G + splits - 1) / splits;
  if (dw_clusters() < 1) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_dw90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(sizeof(DwSmem)));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16, unsigned(splits));
  cfg.blockDim = dim3(DW_NT);
  cfg.dynamicSmemBytes = sizeof(DwSmem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, grouped_dw90_kernel,
                           static_cast<const int8_t*>(aq_ws),
                           static_cast<const int8_t*>(q_ws),
                           static_cast<const float*>(gscale),
                           static_cast<float*>(part), nimg, HW / PT, H, Pt,
                           gpi, gps);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// Clusters of 4 CTAs that can be resident at once for each cluster kernel
// (0 forward bf16, 1 forward f32, 2 gradient bf16, 3 gradient f32, 4 dW1,
// 5 the product alone, 6 colored forward bf16, 7 colored forward f32, 8..13
// the SR kernels in the order of 0, 1, 2, 3, 6, 7, 14..20 the wide kernels
// in the order of 0, 1, 2, 3, 6, 7, 4); 0 if the card cannot make one
// resident.
int svt_loss90_max_clusters(int which) {
  switch (which) {
    case 0: return fwd_clusters(true);
    case 1: return fwd_clusters(false);
    case 2: return grad_clusters(true);
    case 3: return grad_clusters(false);
    case 4: return dw_clusters();
    case 5: return product_clusters();
    case 6: return fwd_clusters(true, true);
    case 7: return fwd_clusters(false, true);
    default:
      return which < 14   ? svt8::loss90_sr_max_clusters(which - 8)
             : which < 21 ? svt8::loss90_wide_max_clusters(which - 14)
                          : 0;
  }
}

// The inputs of the 2^32 where the cluster passes' a0 chain (its
// thresholds) and clip(round(7 tanh(x)), -7, 7) differ, counted into
// `count` (one unsigned long long, zeroed by the caller).
int svt_loss90_chain_check(void* count, void* stream) {
  chain_check90_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count));
  return int(cudaGetLastError());
}

// out (ntiles, 64, 512) int32 = a (ntiles, 64, 512) int8 . W^T, W as its
// slab stream (Kp / 64 slabs of 64 K-bytes x 512 rows, the layout of
// fused_loss_int8.sm90_slabs); ntiles a multiple of 4.
int svt_sm90_tile_product(const void* a, const void* wslabs, void* out,
                          int ntiles, int Kp, void* stream) {
  if (ntiles < CS || ntiles % CS || Kp < SB || Kp > KW || Kp % SB)
    return int(cudaErrorInvalidValue);
  const int nquads = ntiles / CS;
  const int ncl = min(nquads, product_clusters());
  if (ncl < 1) return int(cudaErrorInvalidConfiguration);
  return int(launch_clusters(tile_product90_kernel, unsigned(ncl * CS), NT,
                             sizeof(FwdSmem), CS,
                             static_cast<cudaStream_t>(stream),
                             static_cast<const int8_t*>(a),
                             static_cast<const int8_t*>(wslabs),
                             static_cast<int*>(out), Kp, nquads));
}

}  // extern "C"
