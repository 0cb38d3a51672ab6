// K1 and K2 redesigned for Hopper: the float decoder tail's forward and
// backward at the shapes every CLI defaults to (one hidden layer, Lh = 1,
// H <= 512, No <= 8, any pixel count), on thread block clusters, TF32 and
// bf16 wgmma and multicast bulk copies.
//
// Replaces, like fused_decoder_fwd.cu and fused_decoder_bwd.cu, the Pallas
// TPU kernels spatialvae_tpu/kernels/fused_decoder.py `_fwd_kernel` (:105)
// and `_bwd_kernel` (:196).  Per pixel p of image b:
//
//   a0 = tanh(x0 w0 + x1 w1 + c);  a1 = tanh(cast(a0) @ W1 + b1 [+ a0])
//   y  = sigmoid(cast(a1) . wht^T + bht)
//   dz2 = g s (1 - s);  da1 = cast(dz2)^T . wht;  dh1 = da1 (1 - a1^2)
//   da0 = cast(dh1) . W1^T [+ dh1];  dh0 = da0 (1 - a0^2)
//   dW1 = sum_p cast(a0)^T cast(dh1);  db1, dWh^T, dbh, dfold: column sums
//
// with cast() the TPU kernel's `astype(w.dtype)`.  The wrapper's
// decoder_route sends every call to the sm90 kernels, and single_pass
// sends the calls with one hidden layer at most 512 wide here; every other
// width and depth takes the layer passes of fused_decoder_sm90_deep.cu,
// built from the same pieces (fused_decoder_sm90.cuh), and the tile
// kernels of fused_decoder_{fwd,bwd}.cu stay the A/B's yardstick.  The
// entry points below refuse a call these kernels do not take (Lh != 1,
// H > 512, No > 8).
//
// What bounds it on this card: the products, 2 HW H^2 per image each (the
// forward's, the chain's da0, dW1), 205 GFLOP at galaxy B=100 (HW = 4096,
// H = 500): 1.24 ms as three TF32 products at 495 TFLOP/s, 0.21 ms in bf16
// at 989.  The tile kernels lost their time to W: a 64-pixel block streamed
// all of W (1 MiB in f32) from L2 for every block, 6.7 GB a call at B=100,
// on mma.sync with every A fragment re-split at every read.  Here:
//   - W once per cluster: four CTAs, each a 64-pixel tile of any image
//     (W is the same for all), share one stream of W slabs laid out by the
//     host once per weight version in wgmma's K-major 64-byte swizzled
//     layout (fused_decoder.decoder_slabs); each CTA bulk-copies a quarter
//     of every slab and multicasts it into the four rings.  The stream is
//     64-byte K units of all 512 output rows: 16 K values in f32, as two
//     planes, the TF32 head hi = rna(w) and tail lo = rna(w - hi), or 32 in
//     bf16, kept 2 bytes; a slab is one f32 unit (64 KiB) or two bf16 units
//     in the forward (64 KiB, half the slab iterations) and one in the chain
//     (32 KiB, beside its partials).  The L2 stream at B=100 falls to 3.4
//     GB (f32, split on the host) or 0.84 GB (bf16).
//   - the tensor cores: f32 weights take three `wgmma m64n128k8
//     f32.tf32.tf32` products per K step, lo.hi + hi.lo + hi.hi, with the
//     operands split by cvt.rna.tf32 as the tile kernels split them; bf16
//     weights take `wgmma m64n128k16 f32.bf16.bf16` with no widening (a
//     bf16 x bf16 product is exact in f32).  Four warpgroups of 128 output
//     columns, a (64, 128) f32 accumulator each (64 registers a thread).
//   - A built slab by slab: the only product of the forward takes cast(a0)
//     and the chain's takes cast(dh1), both elementwise in the K index, so
//     the CTA builds the next K slab of A (64 pixels x one slab's K, split
//     for f32) between issuing the current slab's products and waiting for
//     the previous slab's, in three A buffers; the forward's fold rows are
//     loaded one slab earlier still.  No (64, H) activation tile is kept.
//     The chain's build also computes da1 on the CUDA cores (K = No) and
//     takes db1's and dWh^T's column sums.
//   - dW1 from K-major workspaces: TF32 wgmma takes no transposed operand,
//     so the chain writes cast(a0)^T and cast(dh1)^T per 64-pixel block as
//     (512 rows, 64 pixels) in the swizzled layout, the pixels in the
//     accumulator rows' order (dW1 sums over all of them, so the order is
//     free), and dec_dw90 multiplies them on 2 x 2 clusters of (128, 128)
//     output tiles, each operand half multicast to the two CTAs that share
//     its rows (f32: split into TF32 planes in shared memory as each stage
//     lands, beside the previous stage's products), one split-K partial
//     per 4,096 pixels summed by svt_sum_rows in a fixed order.  The chain
//     computes a0 for dh0 anyway; writing it (819 MB more at B=100 in f32)
//     was taken over regenerating it in the dW kernel, which would repeat
//     the tanh once per output tile column (four times over).
//   - the epilogues: bias, exact tanhf, the head over No <= 8 and the
//     sigmoid; column sums by halving lane exchanges and a fixed-order warp
//     and warpgroup sum through shared memory.  No float atomics: reruns are
//     bit-identical.  Emitted activations are stored as adjacent pairs from
//     the accumulator (a 32-byte sector per 4 lanes in f32).
// Every op the plain version rounds (the first layer, dz2, dh) is written
// with __f*_rn in its order.  The switches of decoder_tile.cuh act here too:
// SVT_TF32_SPLIT=0 keeps one TF32 product (hi.hi), SVT_BF16_CASTS=0 drops
// the casts outside the products (the bf16 products take bf16 operands by
// construction).  SVT_DEC90_CUT=1 builds a copy whose tiles end after the
// product (chip_smoke.py --split dec90 times it against the sound build;
// cut_store keeps its products alive).

#include "fused_decoder_sm90.cuh"

namespace {

using namespace svt;
using namespace sm90;

// ---------------------------------------------------------------------------
// K1: the forward
// ---------------------------------------------------------------------------

struct Fwd90Args {
  const float* fold;      // (B, 4, H)
  const float* coords;    // (HW, 2)
  const uint8_t* wslabs;  // W1^T's slab stream
  const float* bhid;      // (H,) f32
  const float* wht;       // (No, H) f32
  const float* bht;       // (No,) f32
  float* y;               // (B, No, HW)
  void* acts;             // (B, HW, H) f32 (EMIT 1) or bf16 (EMIT 2)
  int HW, H, No, tiles, total;
};

template <bool BF16>
struct Fwd90Smem {
  using C = Fwd90K<BF16>;
  uint8_t ring[C::STAGES][C::SLAB];
  // the A slabs; after a tile's product, the head's weights and the bias
  union {
    uint8_t a[C::NA][C::ASLAB];
    float head[(MAX_NO + 1) * KW];
  } u;
  float red[WG * MAX_NO * PT];       // the head's partials per warpgroup
  uint64_t full[C::STAGES], empty[C::STAGES];
};
static_assert(sizeof(Fwd90Smem<false>) <= 232448, "shared memory, f32");
static_assert(sizeof(Fwd90Smem<true>) <= 232448, "shared memory, bf16");


// The forward's epilogue of one tile: bias, the residual add, tanh, the
// emitted activations, the head.
template <bool BF16, bool RESID, int EMIT>
__device__ __forceinline__ void fwd_epilogue(const Fwd90Args& a,
                                             Fwd90Smem<BF16>& sm,
                                             float (&acc)[64], int b, int p0,
                                             bool valid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No;
  // the head's weights and the bias to shared memory, zero past H
  float* wsm = sm.u.head;
  float* bsm = wsm + MAX_NO * KW;
  for (int i = tid; i < (MAX_NO + 1) * KW; i += NT90) {
    const int o = i / KW, n = i % KW;
    float v = 0.f;
    if (n < H) v = o < No ? a.wht[size_t(o) * H + n]
                          : o == MAX_NO ? a.bhid[n] : 0.f;
    wsm[i] = v;
  }
  __syncthreads();

  // a1 = tanh(acc + b1 [+ a0]) in place
  const int px0 = 16 * w + g, px1 = px0 + 8;
  const int pix0 = p0 + px0, pix1 = p0 + px1;
  const bool on0 = valid && pix0 < HW, on1 = valid && pix1 < HW;
  float xr[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (RESID) {
    if (on0) xr[0][0] = a.coords[2 * pix0], xr[0][1] = a.coords[2 * pix0 + 1];
    if (on1) xr[1][0] = a.coords[2 * pix1], xr[1][1] = a.coords[2 * pix1 + 1];
  }
  const float* f = a.fold + size_t(b) * 4 * H;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int n = acc_col(wg, t, j), h = (j >> 1) & 1;
    float x = __fadd_rn(acc[j], bsm[n]);
    if (RESID && n < H)
      x = __fadd_rn(x, tanhf(first_h0(xr[h][0], xr[h][1], f[n], f[H + n],
                                      f[2 * H + n])));
    acc[j] = n < H ? tanhf(x) : 0.f;
  }
  if (EMIT) {
    // adjacent columns n, n + 1 of a row as one store
    const bool pairs = (H & 1) == 0;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int n = acc_col(wg, t, j), h = (j >> 1) & 1;
      if (!(h ? on1 : on0) || n >= H) continue;
      const size_t at = (size_t(b) * HW + (h ? pix1 : pix0)) * H + n;
      if (pairs) {
        if (EMIT == 2)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.acts) + at) =
              __floats2bfloat162_rn(acc[j], acc[j + 1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.acts) + at) =
              make_float2(acc[j], acc[j + 1]);
      } else {
        store_elem<EMIT == 2>(a.acts, at, acc[j]);
        if (n + 1 < H) store_elem<EMIT == 2>(a.acts, at + 1, acc[j + 1]);
      }
    }
  }
  // the head: per output, this thread's 32 columns of its two rows, the 4
  // lanes of a row, then the 4 warpgroups in order; one output at a time,
  // a1 cast in place, keeps the epilogue's registers few (the kernel sits
  // at the 128-register cap of 512 threads)
  if (BF16) {
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = operand<BF16>(acc[j]);
  }
#pragma unroll 1
  for (int o = 0; o < No; ++o) {
    const float* wo = wsm + o * KW;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      if (j & 2) continue;
      const float wv = wo[acc_col(wg, t, j)];
      r0 = fmaf(wv, acc[j], r0);
      r1 = fmaf(wv, acc[j + 2], r1);
    }
    r0 += __shfl_xor_sync(0xffffffffu, r0, 1);
    r0 += __shfl_xor_sync(0xffffffffu, r0, 2);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 1);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 2);
    if (t == 0) {
      sm.red[(wg * MAX_NO + o) * PT + px0] = r0;
      sm.red[(wg * MAX_NO + o) * PT + px1] = r1;
    }
  }
  __syncthreads();
  if (tid < No * PT) {
    const int o = tid / PT, pp = tid % PT, pix = p0 + pp;
    float z = 0.f;
    for (int q = 0; q < WG; ++q) z += sm.red[(q * MAX_NO + o) * PT + pp];
    if (valid && pix < HW)
      a.y[(size_t(b) * No + o) * HW + pix] =
          1.f / (1.f + expf(-(z + a.bht[o])));
  }
}

template <bool BF16, bool RESID, int EMIT>
__global__ void __launch_bounds__(NT90, 1)
dec_fwd90_kernel(const Fwd90Args a, int nquads) {
  using C = Fwd90K<BF16>;
  extern __shared__ __align__(1024) uint8_t smem90[];
  Fwd90Smem<BF16>& sm = *reinterpret_cast<Fwd90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No;
  const int ntl = tiles_of_cta(nquads);
  const int nslab = slab_k(H) / C::KS;
  const Ring90<C::STAGES, C::SLAB> ring{&sm.ring[0][0], sm.full, sm.empty,
                                        a.wslabs, nslab, ntl * nslab,
                                        cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();

  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k, ring.rank);
    const bool valid = tb < a.total;
    const int b = valid ? tb / a.tiles : 0;
    const int p0 = valid ? (tb % a.tiles) * PT : 0;
    build_a0<BF16>(a, p0, valid, 0, fold_col<C>(a.fold, H, b, valid, 0),
                   sm.u.a[0]);
    fence_proxy_async();
    FoldCol fc = fold_col<C>(a.fold, H, b, valid, 1);
    __syncthreads();
    float acc[64];
    for (int s = 0; s < nslab; ++s) {
      const int seq = k * nslab + s;
      mma_slab90<C>(acc, sm.u.a[s % C::NA], ring.wait(seq), wg, s == 0);
      // A slab s + 1 takes the buffer of slab s - 2, whose products every
      // warpgroup waited for before the last barrier; it is built while the
      // tensor cores run slabs s - 1 and s, and slab s + 2's fold values
      // are loaded beside it
      if (s + 1 < nslab) {
        const FoldCol cur = fc;
        fc = fold_col<C>(a.fold, H, b, valid, s + 2);
        build_a0<BF16>(a, p0, valid, s + 1, cur, sm.u.a[(s + 1) % C::NA]);
        fence_proxy_async();
      }
      wgmma_wait<1>();                  // slab s - 1's products are done
      if (s > 0) ring.release(seq - 1);
      __syncthreads();                  // slab s + 1 of A is complete
      ring.refill(seq);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    ring.release(k * nslab + nslab - 1);
    __syncthreads();                    // every warpgroup's A reads done
    if (SVT_DEC90_CUT) {
      cut_store(acc, a.y + size_t(b) * No * HW + p0);
      continue;
    }
    fwd_epilogue<BF16, RESID, EMIT>(a, sm, acc, b, p0, valid);
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// K2: the chain and dW1
// ---------------------------------------------------------------------------

struct Chain90Args {
  const float* fold;      // (Bc, 4, H)
  const float* coords;    // (HW, 2)
  const uint8_t* wslabs;  // W1's slab stream (rows: input unit)
  const float* wht;       // (No, H) f32
  const void* acts;       // a1 (Bc, HW, H), f32 or bf16
  const float* y;         // (Bc, No, HW)
  const float* gy;        // (Bc, No, HW)
  float* part_fold;       // (Bc*tiles, 3, H)
  float* part_w;          // (Bc*tiles, H + No*H + No): db1 | dWh^T | dbh
  uint8_t* ws_a0;         // (Bc*tiles) blocks of WS_BLOCK bytes: cast(a0)^T
  uint8_t* ws_dh;         // the same for cast(dh1)^T
  int HW, H, No, tiles, total;
};

template <bool BF16>
struct Chain90Smem {
  uint8_t ring[K90<BF16>::STAGES][K90<BF16>::SLAB];
  union {
    struct {
      uint8_t a[K90<BF16>::NA][K90<BF16>::ASLAB];
      float red[2][K90<BF16>::RED];   // db1's and dWh^T's column partials
    } m;
    float fold3[3][4][KW];            // dfold's column partials per warp
  } u;
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  uint64_t full[K90<BF16>::STAGES], empty[K90<BF16>::STAGES];
};
static_assert(sizeof(Chain90Smem<false>) <= 232448, "shared memory, f32");
static_assert(sizeof(Chain90Smem<true>) <= 232448, "shared memory, bf16");


// Slab s of cast(dh1) into `dst`, its columns' db1 and dWh^T partials into
// `red`, cast(dh1)^T to the block's workspace.  (a1 is not loaded a slab
// ahead, as the forward's fold rows are: held in registers it did not pay,
// the kernel sits at its register cap.)
template <bool BF16, bool ACT_BF16>
__device__ __forceinline__ void build_dh(const Chain90Args& a,
                                         const float* dzc, int b, int p0,
                                         bool valid, int s, uint8_t* dst,
                                         float* red, uint8_t* ws) {
  using C = K90<BF16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = C::CW * (warp % C::CG) + lane % C::CW;
  const int j = s * C::KS + c;
  const bool on = valid && j < a.H;
  const int No = a.No;
  float sdb = 0.f, swt[MAX_NO];
#pragma unroll
  for (int o = 0; o < MAX_NO; ++o) swt[o] = 0.f;
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
    float dh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pair_pixel(q, h), pix = p0 + p;
      float a1 = 0.f, v = 0.f;
      if (on && pix < a.HW) {
        a1 = load_elem<ACT_BF16>(a.acts, (size_t(b) * a.HW + pix) * a.H + j);
        v = dh1_of(a1, dzc, a.wht, p, j, a.H, No);
      }
      sdb += v;
      const float a1c = operand<BF16>(a1);
#pragma unroll
      for (int o = 0; o < MAX_NO; ++o)
        if (o < No) swt[o] = fmaf(dzc[o * PT + p], a1c, swt[o]);
      dh[h] = operand<BF16>(v);
      store_a<C>(dst, p, c, dh[h]);
    }
    if (valid) store_ws_pair<BF16>(ws, j, 2 * q, dh[0], dh[1]);
  }
  // over the RPW lanes (and the thread's pairs) of a column, then one slot
  // per pair group
#pragma unroll
  for (int m = C::CW; m < 32; m *= 2) {
    sdb += __shfl_xor_sync(0xffffffffu, sdb, m);
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o)
      if (o < No) swt[o] += __shfl_xor_sync(0xffffffffu, swt[o], m);
  }
  if (lane < C::CW) {
    float* r = red + (warp / C::CG) * (1 + MAX_NO) * C::KS + c;
    r[0] = sdb;
#pragma unroll
    for (int o = 0; o < MAX_NO; ++o)
      if (o < No) r[(1 + o) * C::KS] = swt[o];
  }
}

// The chain's epilogue of one tile: dh0 with a0 rebuilt, cast(a0)^T to
// its workspace, dfold's column partials.
template <bool BF16, bool RESID, bool ACT_BF16>
__device__ __forceinline__ void chain_epilogue(const Chain90Args& a,
                                               Chain90Smem<BF16>& sm,
                                               float (&acc)[64], int tb,
                                               int b, int p0, bool valid) {
  using C = K90<BF16>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No;
  // dh0 = (da0 [+ dh1]) (1 - a0^2) with a0 rebuilt, cast(a0)^T to its
  // workspace, dfold's column partials
  const int px0 = 16 * w + g, px1 = px0 + 8;
  const int pix0 = p0 + px0, pix1 = p0 + px1;
  const bool on0 = valid && pix0 < HW, on1 = valid && pix1 < HW;
  float xr[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (on0) xr[0][0] = a.coords[2 * pix0], xr[0][1] = a.coords[2 * pix0 + 1];
  if (on1) xr[1][0] = a.coords[2 * pix1], xr[1][1] = a.coords[2 * pix1 + 1];
  const float* f = a.fold + size_t(b) * 4 * H;
  uint8_t* wsa = a.ws_a0 + size_t(valid ? tb : 0) * C::WS_BLOCK;
  // the residual add's da0 += dh1 in a pass of its own, eight accumulator
  // values at a time, each da1 summed over the outputs in the plain
  // version's order (dh1_of's): rebuilt inside the loop below, dh1 made
  // the chain spill 5.5 KB of loads a thread
  if (RESID) {
#pragma unroll
    for (int j0 = 0; j0 < 64; j0 += 8) {
      float da1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) da1[u] = 0.f;
      for (int o = 0; o < No; ++o) {
        const float d0 = sm.dzc[o * PT + px0], d1 = sm.dzc[o * PT + px1];
        const float* wo = a.wht + size_t(o) * H;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = acc_col(wg, t, j0 + u);
          const float wv = i < H ? __ldg(wo + i) : 0.f;
          da1[u] = fmaf((u >> 1) & 1 ? d1 : d0, wv, da1[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u, i = acc_col(wg, t, j), h = (j >> 1) & 1;
        if (i < H && (h ? on1 : on0)) {
          const float a1 = load_elem<ACT_BF16>(
              a.acts, (size_t(b) * HW + (h ? pix1 : pix0)) * H + i);
          acc[j] = __fadd_rn(acc[j], __fmul_rn(da1[u], __fsub_rn(
                                         1.f, __fmul_rn(a1, a1))));
        }
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float s0[8], s1[8], s2[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nt = 4 * ch + u;
      const int n0 = acc_col(wg, t, 4 * nt);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = n0 + e;
        const bool oni = i < H;
        const float w0 = oni ? f[i] : 0.f, w1 = oni ? f[H + i] : 0.f;
        const float cb = oni ? f[2 * H + i] : 0.f;
        float a0c[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool on = oni && (h ? on1 : on0);
          float a0 = 0.f, dh0 = 0.f;
          if (on) {
            a0 = tanhf(first_h0(xr[h][0], xr[h][1], w0, w1, cb));
            dh0 = __fmul_rn(acc[4 * nt + 2 * h + e],
                            __fsub_rn(1.f, __fmul_rn(a0, a0)));
          }
          a0c[h] = operand<BF16>(a0);
          const int iv = 2 * u + e;
          if (h == 0) {
            s0[iv] = __fmul_rn(xr[0][0], dh0);
            s1[iv] = __fmul_rn(xr[0][1], dh0);
            s2[iv] = dh0;
          } else {
            s0[iv] = fmaf(xr[1][0], dh0, s0[iv]);
            s1[iv] = fmaf(xr[1][1], dh0, s1[iv]);
            s2[iv] += dh0;
          }
        }
        if (valid) store_ws_pair<BF16>(wsa, i, 16 * w + 2 * g, a0c[0],
                                       a0c[1]);
      }
    }
    const int n = chunk_col(wg, t, g, ch);
    sm.u.fold3[0][w][n] = reduce_scatter8(s0);
    sm.u.fold3[1][w][n] = reduce_scatter8(s1);
    sm.u.fold3[2][w][n] = reduce_scatter8(s2);
  }
  __syncthreads();
  if (valid && tid < H) {
    float* pf = a.part_fold + size_t(tb) * 3 * H;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      pf[r * H + tid] = sm.u.fold3[r][0][tid] + sm.u.fold3[r][1][tid] +
                        sm.u.fold3[r][2][tid] + sm.u.fold3[r][3][tid];
  }
  __syncthreads();                    // the union is free for the next tile
}

template <bool BF16, bool RESID, bool ACT_BF16>
__global__ void __launch_bounds__(NT90, 1)
dec_chain90_kernel(const Chain90Args a, int nquads) {
  using C = K90<BF16>;
  extern __shared__ __align__(1024) uint8_t smem90[];
  Chain90Smem<BF16>& sm = *reinterpret_cast<Chain90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No;
  const int Mw = H + No * H + No;
  const int ntl = tiles_of_cta(nquads);
  const int nslab = slab_k(H) / C::KS;
  const Ring90<C::STAGES, C::SLAB> ring{&sm.ring[0][0], sm.full, sm.empty,
                                        a.wslabs, nslab, ntl * nslab,
                                        cluster_rank()};
  if (tid == 0) ring.init();
  cluster_sync();
  ring.start();

  for (int k = 0; k < ntl; ++k) {
    const int tb = block_of(k, ring.rank);
    const bool valid = tb < a.total;
    const int b = valid ? tb / a.tiles : 0;
    const int p0 = valid ? (tb % a.tiles) * PT : 0;
    float* pw = a.part_w + size_t(valid ? tb : 0) * Mw;
    uint8_t* wsd = a.ws_dh + size_t(valid ? tb : 0) * C::WS_BLOCK;
    // dz2 = g s (1 - s), 0 past HW; its cast; dbh's partial
    if (tid < No * PT) {
      const int pix = p0 + tid % PT;
      float d = 0.f;
      if (valid && pix < HW) {
        const size_t at = (size_t(b) * No + tid / PT) * HW + pix;
        const float s = a.y[at];
        d = __fmul_rn(__fmul_rn(a.gy[at], s), __fsub_rn(1.f, s));
      }
      sm.dz[tid] = d;
      sm.dzc[tid] = operand<BF16>(d);
    }
    __syncthreads();
    if (valid && tid < No) {
      float s = 0.f;
      for (int p = 0; p < PT; ++p) s += sm.dz[tid * PT + p];
      pw[(1 + No) * H + tid] = s;
    }
    build_dh<BF16, ACT_BF16>(a, sm.dzc, b, p0, valid, 0, sm.u.m.a[0],
                             sm.u.m.red[0], wsd);
    fence_proxy_async();
    __syncthreads();

    // da0 = cast(dh1) . W1^T, the next slab of cast(dh1) built beside it;
    // each slab's column partials summed over the pair groups in order
    float acc[64];
    for (int s = 0; s < nslab; ++s) {
      const int seq = k * nslab + s;
      mma_slab90<C>(acc, sm.u.m.a[s % C::NA], ring.wait(seq), wg, s == 0);
      if (s + 1 < nslab) {            // as in the forward
        build_dh<BF16, ACT_BF16>(a, sm.dzc, b, p0, valid, s + 1,
                                 sm.u.m.a[(s + 1) % C::NA],
                                 sm.u.m.red[(s + 1) & 1], wsd);
        fence_proxy_async();
      }
      if (tid < (1 + No) * C::KS) {
        const int kind = tid / C::KS, c = tid % C::KS, j = s * C::KS + c;
        const float* r = sm.u.m.red[s & 1] + kind * C::KS + c;
        float v = 0.f;
        for (int pg = 0; pg < C::PG; ++pg) v += r[pg * (1 + MAX_NO) * C::KS];
        if (valid && j < H) pw[kind == 0 ? j : kind * H + j] = v;
      }
      wgmma_wait<1>();
      if (s > 0) ring.release(seq - 1);
      __syncthreads();
      ring.refill(seq);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    ring.release(k * nslab + nslab - 1);
    __syncthreads();                    // every warpgroup's A reads done
    if (SVT_DEC90_CUT) {
      cut_store(acc, a.part_fold + size_t(valid ? tb : 0) * 3 * H);
      continue;
    }
    chain_epilogue<BF16, RESID, ACT_BF16>(a, sm, acc, tb, b, p0, valid);
  }
  cluster_sync();
}

// dW1 = sum_p cast(a0)^T[i][p] cast(dh1)^T[j][p] from the workspaces, on
// clusters of 2 x 2 (128, 128) output tiles: CTA rank r of the cluster
// blockIdx.x / 4 (sup = that % 4, split = blockIdx.x / 16) takes i-tile
// 2 (sup / 2) + r % 2 and j-tile 2 (sup % 2) + r / 2.  A stage is one 64-byte
// K chunk (16 f32 or 32 bf16 pixels) of one block: the i-tile's 128 rows of
// cast(a0)^T then the j-tile's of cast(dh1)^T; each half of an operand is
// fetched by one of the two CTAs that share it and multicast to both.  With
// f32 weights the CTA splits each landed stage into its TF32 planes (a
// double-buffered copy the products read) while the tensor cores run the
// previous one, so the workspaces hold the values once.  Split `split`
// (blockIdx.x / 16) sums blocks split * bps .. (split + 1) * bps - 1 (none
// past the last block: a zero partial).
constexpr int DW_NT = 256;                 // two warpgroups of 64 rows
constexpr int DW_WARPS = DW_NT / 32;
constexpr int DW_OPB = 128 * SB;           // one operand's rows of a stage
constexpr int DW_STAGE = 2 * DW_OPB;       // A rows, then B rows
constexpr int DW_STAGES = 8;

template <bool BF16>
struct Dw90Smem {
  uint8_t ring[DW_STAGES][DW_STAGE];
  // f32: three split copies of a stage, [A hi | A lo | B hi | B lo]
  uint8_t split[BF16 ? 1 : 3][BF16 ? 16 : 2 * DW_STAGE];
  uint64_t full[DW_STAGES], empty[DW_STAGES];
};
static_assert(sizeof(Dw90Smem<false>) <= 232448, "shared memory, f32");

template <bool BF16>
__global__ void __launch_bounds__(DW_NT, 1)
dec_dw90_kernel(const uint8_t* __restrict__ ws_a0,
                const uint8_t* __restrict__ ws_dh, float* __restrict__ part,
                int nblk, int H, int bps) {
  using C = K90<BF16>;
  constexpr int S = DW_STAGES;
  extern __shared__ __align__(1024) uint8_t smem90[];
  Dw90Smem<BF16>& sm = *reinterpret_cast<Dw90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t rank = cluster_rank();
  const int ci = rank & 1, cj = rank >> 1;
  const int split = blockIdx.x / 16, sup = (blockIdx.x % 16) / CS;
  const int i0 = (2 * (sup >> 1) + ci) * 128, j0 = (2 * (sup & 1) + cj) * 128;
  const int blk0 = split * bps;
  const int total = max(0, min(nblk, blk0 + bps) - blk0) * C::CH;
  const uint16_t mask_a = uint16_t((1u << ci) | (1u << (ci + 2)));
  const uint16_t mask_b = uint16_t(3u << (2 * cj));

  auto fetch = [&](int idx) {
    const int st = idx % S;
    if (idx >= S) mbar_wait(&sm.empty[st], uint32_t(idx / S - 1) & 1u);
    mbar_expect_tx(&sm.full[st], DW_STAGE);
    const size_t base = size_t(blk0 + idx / C::CH) * C::WS_BLOCK +
                        size_t(idx % C::CH) * PART;
    uint8_t* dst = sm.ring[st];
    bulk_multicast(dst + cj * (DW_OPB / 2),
                   ws_a0 + base + size_t(i0) * SB + cj * (DW_OPB / 2),
                   DW_OPB / 2, &sm.full[st], mask_a);
    bulk_multicast(dst + DW_OPB + ci * (DW_OPB / 2),
                   ws_dh + base + size_t(j0) * SB + ci * (DW_OPB / 2),
                   DW_OPB / 2, &sm.full[st], mask_b);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], DW_WARPS * CS);
    }
    fence_mbar_init();
  }
  cluster_sync();
  if (tid == 0)
    for (int s = 0; s < S && s < total; ++s) fetch(s);

  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  for (int idx = 0; idx < total; ++idx) {
    const int st = idx % S;
    mbar_wait(&sm.full[st], uint32_t(idx / S) & 1u);
    const uint8_t* ops = sm.ring[st];
    if (!BF16) {
      // the stage's TF32 head and tail into split copy idx % 3, whose last
      // products (stage idx - 3) both warpgroups waited for before the last
      // barrier; the same swizzled offsets, 16 bytes a thread at a time
      uint8_t* sp = sm.split[idx % 3];
#pragma unroll
      for (int m = 0; m < DW_STAGE / 16 / DW_NT; ++m) {
        const int ch = tid + m * DW_NT, op = ch / (DW_OPB / 16);
        const int off = (ch % (DW_OPB / 16)) * 16;
        const float4 v =
            *reinterpret_cast<const float4*>(ops + op * DW_OPB + off);
        float4 hi, lo;
        planes<C::SPLIT>(v.x, hi.x, lo.x);
        planes<C::SPLIT>(v.y, hi.y, lo.y);
        planes<C::SPLIT>(v.z, hi.z, lo.z);
        planes<C::SPLIT>(v.w, hi.w, lo.w);
        *reinterpret_cast<float4*>(sp + (2 * op) * DW_OPB + off) = hi;
        *reinterpret_cast<float4*>(sp + (2 * op + 1) * DW_OPB + off) = lo;
      }
      fence_proxy_async();
      __syncthreads();                     // the split copy is complete
      release_cluster(&sm.empty[st], CS);  // the raw stage is read
      if (tid == 0 && idx + S < total) fetch(idx + S);
      ops = sp;
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SB; kk += 32) {
      const int acc_in = idx == 0 && kk == 0 ? 0 : 1;
      if (BF16) {
        const uint8_t* A = ops + wg * (DW_OPB / 2) + kk;
        const uint8_t* B = ops + DW_OPB + kk;
        wgmma_bf16_n128(acc, gmma_desc_sw64(A), gmma_desc_sw64(B), acc_in);
      } else {
        const uint8_t* A = ops + wg * (DW_OPB / 2) + kk;      // A hi
        const uint8_t* B = ops + 2 * DW_OPB + kk;             // B hi
        if (C::SPLIT) {
          wgmma_tf32_n128(acc, gmma_desc_sw64(A + DW_OPB),
                          gmma_desc_sw64(B), acc_in);
          wgmma_tf32_n128(acc, gmma_desc_sw64(A),
                          gmma_desc_sw64(B + DW_OPB), 1);
          wgmma_tf32_n128(acc, gmma_desc_sw64(A), gmma_desc_sw64(B), 1);
        } else {
          wgmma_tf32_n128(acc, gmma_desc_sw64(A), gmma_desc_sw64(B),
                          acc_in);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                       // the previous stage is read
    if (BF16 && idx > 0) {
      release_cluster(&sm.empty[(idx - 1) % S], CS);
      if (tid == 0 && idx - 1 + S < total) fetch(idx - 1 + S);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  float* out = part + size_t(split) * H * H;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int i = i0 + 64 * wg + 16 * w + g + 8 * ((j >> 1) & 1);
    const int jj = j0 + 8 * (j >> 2) + 2 * t + (j & 1);
    if (i < H && jj < H) out[size_t(i) * H + jj] = acc[j];
  }
  cluster_sync();
}

// ---- launches

template <typename K>
int cached_clusters(K k, int threads, int smem, int* cache) {
  if (*cache <= 0) *cache = max_clusters(k, threads, smem, CS);
  return *cache;
}

template <bool BF16, bool RESID, int EMIT>
cudaError_t launch_fwd(const Fwd90Args& a, cudaStream_t st) {
  static int cache = 0;
  auto k = dec_fwd90_kernel<BF16, RESID, EMIT>;
  const int smem = int(sizeof(Fwd90Smem<BF16>));
  const int nquads = (a.total + CS - 1) / CS;
  const int ncl = min(nquads, cached_clusters(k, NT90, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT90, smem, CS, st, a,
                         nquads);
}

template <bool BF16, bool RESID, bool ACT_BF16>
cudaError_t launch_chain(const Chain90Args& a, cudaStream_t st) {
  static int cache = 0;
  auto k = dec_chain90_kernel<BF16, RESID, ACT_BF16>;
  const int smem = int(sizeof(Chain90Smem<BF16>));
  const int nquads = (a.total + CS - 1) / CS;
  const int ncl = min(nquads, cached_clusters(k, NT90, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT90, smem, CS, st, a,
                         nquads);
}

template <bool BF16>
cudaError_t launch_dw(const uint8_t* wa, const uint8_t* wd, float* part,
                      int nblk, int H, int splits, cudaStream_t st) {
  const int bps = (nblk + splits - 1) / splits;
  return launch_clusters(dec_dw90_kernel<BF16>, unsigned(16 * splits), DW_NT,
                         int(sizeof(Dw90Smem<BF16>)), CS, st, wa, wd, part,
                         nblk, H, bps);
}

// The calls these kernels take: one hidden layer at most 512 wide, at most
// 8 outputs (decoder_route's "sm90").
bool refused(int B, int HW, int H, int Lh, int No) {
  return B < 1 || HW < 1 || H < 1 || H > KW || Lh != 1 || No < 1 ||
         No > MAX_NO || double(B) * ((HW + PT - 1) / PT) > 2147483647.0;
}

}  // namespace

extern "C" {

// Bytes of one 64-pixel block of each dW1 operand workspace (cast(a0)^T,
// cast(dh1)^T): 512 rows x 64 pixels of f32 or bf16 values.
long long svt_decoder90_ws_block(int bf16) {
  return bf16 ? K90<true>::WS_BLOCK : K90<false>::WS_BLOCK;
}

// K1 on clusters: fold (B,4,H), coords (HW,2), wslabs W1^T's slab stream
// (fused_decoder.decoder_slabs), bhid (H,), wht (No,H), bht (No,) f32;
// y (B,No,HW); `emit` 0: y only, 1: also a1 (B,HW,H) f32 in acts, 2: bf16.
// Refuses (cudaErrorInvalidValue) a call outside the route: Lh != 1,
// H > 512, No > 8.
int svt_decoder90_fwd(const void* fold, const void* coords,
                      const void* wslabs, const void* bhid, const void* wht,
                      const void* bht, void* y, void* acts, int B, int HW,
                      int H, int Lh, int No, int resid, int bf16, int emit,
                      void* stream) {
  if (refused(B, HW, H, Lh, No) || emit < 0 || emit > 2 ||
      (emit != 0 && acts == nullptr))
    return int(cudaErrorInvalidValue);
  const int tiles = (HW + PT - 1) / PT;
  const Fwd90Args a{static_cast<const float*>(fold),
                    static_cast<const float*>(coords),
                    static_cast<const uint8_t*>(wslabs),
                    static_cast<const float*>(bhid),
                    static_cast<const float*>(wht),
                    static_cast<const float*>(bht), static_cast<float*>(y),
                    acts, HW, H, No, tiles, B * tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_F90(B16, R)                                           \
  (emit == 0 ? launch_fwd<B16, R, 0>(a, st)                       \
   : emit == 1 ? launch_fwd<B16, R, 1>(a, st)                     \
               : launch_fwd<B16, R, 2>(a, st))
  cudaError_t err;
  if (bf16)
    err = resid ? SVT_F90(true, true) : SVT_F90(true, false);
  else
    err = resid ? SVT_F90(false, true) : SVT_F90(false, false);
#undef SVT_F90
  return int(err);
}

// K2's chain on clusters for a chunk of Bc images (pointers at its first
// image): wslabs W1's slab stream, wht (No,H) f32, acts a1 (Bc,HW,H) f32 or
// bf16 (act_bf16), y and gy (Bc,No,HW); writes part_fold (Bc*tiles,3,H),
// part_w (Bc*tiles, H+No*H+No) and the dW1 operands ws_a0, ws_dh
// (Bc*tiles blocks of svt_decoder90_ws_block bytes).  Refuses a call
// outside the route.
int svt_decoder90_chain(const void* fold, const void* coords,
                        const void* wslabs, const void* wht, const void* acts,
                        const void* y, const void* gy, void* part_fold,
                        void* part_w, void* ws_a0, void* ws_dh, int Bc,
                        int HW, int H, int Lh, int No, int resid, int bf16,
                        int act_bf16, void* stream) {
  if (refused(Bc, HW, H, Lh, No) || (act_bf16 && !bf16))
    return int(cudaErrorInvalidValue);
  const int tiles = (HW + PT - 1) / PT;
  const Chain90Args a{static_cast<const float*>(fold),
                      static_cast<const float*>(coords),
                      static_cast<const uint8_t*>(wslabs),
                      static_cast<const float*>(wht), acts,
                      static_cast<const float*>(y),
                      static_cast<const float*>(gy),
                      static_cast<float*>(part_fold),
                      static_cast<float*>(part_w),
                      static_cast<uint8_t*>(ws_a0),
                      static_cast<uint8_t*>(ws_dh), HW, H, No, tiles,
                      Bc * tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16)
    err = resid ? launch_chain<false, true, false>(a, st)
                : launch_chain<false, false, false>(a, st);
  else if (act_bf16)
    err = resid ? launch_chain<true, true, true>(a, st)
                : launch_chain<true, false, true>(a, st);
  else
    err = resid ? launch_chain<true, true, false>(a, st)
                : launch_chain<true, false, false>(a, st);
  return int(err);
}

// dW1's split-K partials (splits, H, H) f32 from the chain's workspaces of
// nblk blocks.
int svt_decoder90_dw(const void* ws_a0, const void* ws_dh, void* part,
                     int nblk, int H, int splits, int bf16, void* stream) {
  if (nblk < 1 || H < 1 || H > KW || splits < 1 || splits > nblk ||
      splits > 65535)
    return int(cudaErrorInvalidValue);
  const auto* wa = static_cast<const uint8_t*>(ws_a0);
  const auto* wd = static_cast<const uint8_t*>(ws_dh);
  auto* out = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch_dw<true>(wa, wd, out, nblk, H, splits, st)
                  : launch_dw<false>(wa, wd, out, nblk, H, splits, st));
}

// Clusters of 4 the card holds at once: 0 forward f32, 1 forward bf16,
// 2 chain f32, 3 chain bf16, 4 dW1 f32, 5 dW1 bf16 (emit 0, no residual
// add, the residual in the weight dtype).
int svt_decoder90_max_clusters(int which) {
  static int c[6] = {0, 0, 0, 0, 0, 0};
  switch (which) {
    case 0: return cached_clusters(dec_fwd90_kernel<false, false, 0>, NT90,
                                   int(sizeof(Fwd90Smem<false>)), &c[0]);
    case 1: return cached_clusters(dec_fwd90_kernel<true, false, 0>, NT90,
                                   int(sizeof(Fwd90Smem<true>)), &c[1]);
    case 2: return cached_clusters(dec_chain90_kernel<false, false, false>,
                                   NT90, int(sizeof(Chain90Smem<false>)),
                                   &c[2]);
    case 3: return cached_clusters(dec_chain90_kernel<true, false, true>,
                                   NT90, int(sizeof(Chain90Smem<true>)),
                                   &c[3]);
    case 4: return cached_clusters(dec_dw90_kernel<false>, DW_NT,
                                   int(sizeof(Dw90Smem<false>)), &c[4]);
    case 5: return cached_clusters(dec_dw90_kernel<true>, DW_NT,
                                   int(sizeof(Dw90Smem<true>)), &c[5]);
    default: return 0;
  }
}

}  // extern "C"
