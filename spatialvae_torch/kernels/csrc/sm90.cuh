// Hopper (sm_90a) building blocks of the cluster kernels in
// fused_loss_int8_sm90.cu, fused_decoder_sm90.cu and
// fused_decoder_int8_sm90.cuh and of Adam's step kernel in adam_sm90.cu:
// mbarriers, plain bulk loads and stores with an L2
// cache policy, bulk copies multicast into the shared memory of every CTA
// of a thread block cluster, remote arrivals and loads, the cluster barrier
// whole and in halves, and the warpgroup products
// with both operands in shared memory: int8 `wgmma.mma_async ...
// s32.s8.s8` (k32; m64n128, and m64n64 for the int8 decoder's halves), TF32
// `... f32.tf32.tf32` (k8) and bf16 `... f32.bf16.bf16` (k16), each m64n128;
// and the int8 decoder's head, TF32 m64n8k8 with A in registers.
// Raw PTX through inline asm, so the translation units need no CUTLASS or
// CuTe header and build in seconds.
//
// Shared-memory operands use wgmma's K-major layout with the 64-byte
// swizzle: rows of 64 K-bytes, 8-row groups of 512 bytes, and the 16-byte
// chunk c of row r stored at chunk c ^ ((r >> 1) & 3), so that a 32-byte K
// step of eight rows spreads over the banks.  A K step is 32 bytes in all
// three types (32 int8, 8 TF32 or 16 bf16 values).  Int8 and TF32 wgmma take
// K-major operands only, for A and B; the bf16 products here use it too.

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

// ---- plain bulk copies (Adam's step kernel, adam_sm90.cu): `bytes` a
// multiple of 16, both ends 16-byte aligned, `policy` an L2 cache policy
// (l2_evict_first).
// An L2 policy that evicts these lines first: for streams read or written
// once that never fit the 50 MB L2.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
// One plain arrival on a barrier of this CTA.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Global to this CTA's shared memory; the barrier counts the bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
// This CTA's shared memory to global, in the issuing thread's open bulk
// group (bulk_commit closes it).  The caller made its shared-memory writes
// visible to the async proxy first (fence_proxy_async).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of the thread's bulk groups still read their
// shared-memory source (the source may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of the thread's bulk groups are incomplete (their
// writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
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
// cluster_sync in two halves: the arrival releases the thread's earlier
// accesses (reads of other CTAs' shared memory included), the wait acquires
// everyone's.  A thread alternates them, every thread of the cluster alike.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float at the same offset as `p` in the shared memory of CTA `cta` of
// the cluster (distributed shared memory).
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  float v;
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [ra];\n}\n"
      : "=f"(v)
      : "r"(smem_u32(p)), "r"(cta)
      : "memory");
  return v;
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

// d (+)= A (64 x 32 int8) . B (64 x 32 int8)^T in s32, the half-width
// product of the int8 decoder's cluster kernels: thread (warp w of the
// group, lane 4g + t) holds d[4 nt + 2 h + e] = D[16 w + g + 8 h][8 nt + 2 t
// + e], nt < 8.
__device__ __forceinline__ void fence_operands(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (+)= A (64 x 8) . B (8 x 8)^T in TF32, A in registers, B (K-major) in
// shared memory: the int8 decoder's head on the tensor cores.  d[2 h + e]
// = D[16 w + g + 8 h][2 t + e]; a[0] holds A[16w + g][t], a[1] row + 8,
// a[2] A[16w + g][t + 4], a[3] row + 8.
__device__ __forceinline__ void fence_operands(float (&d)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wgmma_tf32_n8_ra(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate)
      : "memory");
}

// ---- f32-accumulating products: d (+)= A (64 x K) . B (128 x K)^T over the
// warpgroup, both K-major in shared memory, one 32-byte K step; the
// accumulator layout is wgmma_s8_n128's (thread (warp w, lane 4g + t) holds
// d[4 nt + 2 h + e] = D[16 w + g + 8 h][8 nt + 2 t + e]).
#define SM90_F32_ACC(d)  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// TF32 operands (f32 bit patterns whose low 13 bits are zero), k8.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : SM90_F32_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// bf16 operands, k16, neither transposed.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_F32_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// ---- the accumulator layout of the m64n128 products over a warpgroup

// The column of accumulator element j of this thread (warpgroup wg).
__device__ __forceinline__ int acc_col(int wg, int t, int j) {
  return 128 * wg + 8 * (j >> 2) + 2 * t + (j & 1);
}

// Halving exchange over the 8 lanes of a column (lane bits 2..4): v[i] holds
// this thread's partial of chunk index i; afterwards v[0] holds the sum over
// the 8 lanes of index g (the lane's g = lane >> 2).
__device__ __forceinline__ float reduce_scatter8(float (&v)[8]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = g & 4;
    const float keep = hi ? v[i + 4] : v[i], send = hi ? v[i] : v[i + 4];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = g & 2;
    const float keep = hi ? v[i + 2] : v[i], send = hi ? v[i] : v[i + 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = g & 1;
  const float keep = hi ? v[1] : v[0], send = hi ? v[0] : v[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 4);
}

// The column that reduce_scatter8's result belongs to, for chunk ch (nt =
// 4 ch .. 4 ch + 3, chunk index 2 (nt % 4) + e).
__device__ __forceinline__ int chunk_col(int wg, int t, int g, int ch) {
  return 128 * wg + 8 * (4 * ch + (g >> 1)) + 2 * t + (g & 1);
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
