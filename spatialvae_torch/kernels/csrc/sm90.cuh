// Hopper (sm_90a) building blocks of the cluster kernels in
// fused_loss_int8_sm90.cu: mbarriers, bulk copies multicast into the shared
// memory of every CTA of a thread block cluster, remote arrivals, and the
// int8 warpgroup product `wgmma.mma_async ... s32.s8.s8` with both operands
// in shared memory.  Raw PTX through inline asm, so the translation unit
// needs no CUTLASS or CuTe header and builds in seconds.
//
// Shared-memory operands use wgmma's K-major layout with the 64-byte
// swizzle: rows of 64 K-bytes, 8-row groups of 512 bytes, and the 16-byte
// chunk c of row r stored at chunk c ^ ((r >> 1) & 3), so that a 32-byte K
// step of eight rows spreads over the banks.  Int8 wgmma takes K-major
// operands only, for A and B.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row r, k < 64) of a swizzled K-major operand of
// 64-byte rows (its base 512-byte aligned).
__host__ __device__ constexpr int offset_sw64(int r, int k) {
  return r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// Arrive on the barrier at the same offset in the shared memory of CTA
// `cta` of the cluster (this CTA included).  A consumer arrives once the
// reads it releases are complete (wgmma.wait_group), so the default
// semantics (release at CTA scope) suffice.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}
// Every warp of the caller's CTA releases `bar` in each of the `cs` CTAs of
// its cluster: lane c arrives on CTA c's barrier.
__device__ __forceinline__ void release_cluster(uint64_t* bar, int cs) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  if (lane < cs) mbar_arrive_remote(bar, uint32_t(lane));
}

// ---- bulk copies: `bytes` (a multiple of 16, 16-byte aligned ends) from
// global memory to the same offset of the shared memory of every CTA in
// `mask` (bit i: cluster rank i); each destination's barrier at the offset
// of `bar` counts the bytes it received.
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// ---- clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster: arrive and wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads), before the barrier that orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma
// Descriptor of a 64-byte-swizzled K-major operand whose rows start at `p`
// (p + 32 for the second 32-byte K step of a row): 8-row groups 512 bytes
// apart (SBO), LBO unused inside a swizzle atom (1), layout type 2.
__device__ __forceinline__ uint64_t gmma_desc_sw64(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of the accumulator across
// the asynchronous product.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32 int8) . B (128 x 32 int8)^T in s32 over the warpgroup:
// thread (warp w of the group, lane 4g + t) holds d[4 nt + 2 h + e] =
// D[16 w + g + 8 h][8 nt + 2 t + e].  `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// ---- the launch of a kernel in clusters of `cs` CTAs along x, and the
// number of such clusters that can be resident at once (0 on error).
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*k)(P...), unsigned grid, int threads,
                            int smem, int cs, cudaStream_t st, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename... P>
int max_clusters(void (*k)(P...), int threads, int smem, int cs) {
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * 256);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)k, &cfg) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace sm90
