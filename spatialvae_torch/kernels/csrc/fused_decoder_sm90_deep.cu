// K1 and K2 on clusters past the default-shape kernels of
// fused_decoder_sm90.cu: a hidden width above 512 and two to four hidden
// layers (the route sends them from 288 wide for two, 448 for three and
// four), No <= 8, f32 and bf16 weights,
// with and without the residual add, every emit mode, both backward
// variants.  One launch per layer and direction, each a cluster product
// pass built from the same pieces (fused_decoder_sm90.cuh): W's multicast
// slab ring, TF32 (three products) or bf16 wgmma, A built slab by slab.
//
// Replaces, like fused_decoder_fwd.cu and fused_decoder_bwd.cu, the Pallas
// TPU kernels spatialvae_tpu/kernels/fused_decoder.py `_fwd_kernel` (:105)
// and `_bwd_kernel` (:196).  Per pixel p of image b, layer l = 1..Lh:
//
//   a0 = tanh(x0 w0 + x1 w1 + c);  a_l = tanh(cast(a_{l-1}) @ W_l + b_l
//   [+ a_{l-1}]);  y = sigmoid(cast(a_Lh) . wht^T + bht)
//   dz2 = g s (1 - s);  da_Lh = cast(dz2)^T . wht;  dh_l = da_l (1 - a_l^2)
//   da_{l-1} = cast(dh_l) . W_l^T [+ dh_l];  dh0 = da0 (1 - a0^2)
//   dW_l = sum_p cast(a_{l-1})^T cast(dh_l);  db_l, dWh^T, dbh, dfold:
//   column sums
//
// What bounds it on this card: the products, 2 HW H^2 per image per
// layer and product (Lh in the forward, 2 Lh in the backward): at galaxy
// B = 100 and H = 1,000, 819 GFLOP a forward layer, 5.0 ms as three TF32
// products at 495 TFLOP/s and 0.83 ms in bf16.  The tile kernels stream
// all of W from L2 for every 64-pixel block and, above 512, read every
// block's activations from a workspace in global memory at every k-step.
// Here:
//   - output column chunks: a product has Hr = 512 ceil(H / 512) output
//     rows, run as Hr / 512 chunks of the default kernels' 512 (four
//     warpgroups of 128 columns, a (64, 128) f32 accumulator each).  W's
//     slab stream is laid out chunk by chunk (fused_decoder.decoder_slabs:
//     each chunk's 512 rows over the whole K, in the default layout), so
//     the ring streams chunk after chunk of one tile unchanged, and A is
//     rebuilt for every chunk: for layer 1 from the fold (two FMAs and a
//     tanh a value, cheaper than a (64, Hp) tile kept in shared memory),
//     above it from the activation buffer;
//   - one pass per layer: a_{l-1} is a product's output, so it cannot be
//     rebuilt from a few numbers, and a (64, 512) f32 tile does not fit
//     beside the f32 ring (192 KiB).  The forward's pass for layer l writes
//     f32 a_l to a buffer (B, HW, H) in global memory (the emitting
//     forward's f32 residual is that buffer), from which the pass for layer
//     l + 1 builds its A slab by slab (cast and, for f32, TF32-split as
//     the chain builds cast(dh1) from a1), its loads a slab ahead, and
//     reads the residual add (a bf16 copy of a_l, half the bytes, timed
//     slower in turns on the card at Lh = 3, B = 100); the
//     last layer's epilogue runs the head, its No partial sums per pixel
//     carried across the chunks in shared memory (each slot one thread's,
//     added in chunk order) and the sigmoid after the last chunk;
//   - the backward, one chain pass per layer, l = Lh .. 1: A = cast(dh_l),
//     dh_l = da_l (1 - a_l^2) with da_Lh from the head on the CUDA cores
//     (K = No) and a lower da_l from the f32 buffer the pass above wrote;
//     the epilogue writes da_{l-1} (+ dh_l under the residual add) to the
//     other buffer, or for l = 1 computes dh0 and dfold's partials with a0
//     rebuilt from the fold as the default chain does.  The first chunk of
//     a tile also writes cast(dh_l)^T and takes db_l's (and at the top
//     dWh^T's) column partials; every chunk writes its rows of
//     cast(a_{l-1})^T.  Both land in K-major workspaces of Hr rows per
//     64-pixel block, from which dec_dww90 computes dW_l on 2 x 2 clusters
//     of (128, 128) output tiles (the default dW kernel with Hr rows and
//     ceil(H / 256)^2 tile quads); one workspace pair serves every layer.
// No float atomics and fixed-order sums: reruns are bit-identical.  Every
// op the plain version rounds is written with __f*_rn in its order.  The
// switches SVT_TF32_SPLIT, SVT_BF16_CASTS and SVT_DEC90_CUT act here as in
// fused_decoder_sm90.cu; three more build faulty copies for `chip_smoke.py
// --limits dec90`: SVT_DEEP_DROP_HEAD=1 drops the head's partial sums of a
// tile's last chunk, SVT_DEEP_STALE_A=1 makes every layer above the first
// read its A slabs from the layer input's first image (a stale buffer
// for every other image), SVT_DEEP_ONE_PASS=1 keeps one TF32 product in
// these kernels alone.

#include "fused_decoder_sm90.cuh"

#ifndef SVT_DEEP_DROP_HEAD
#define SVT_DEEP_DROP_HEAD 0
#endif
#ifndef SVT_DEEP_STALE_A
#define SVT_DEEP_STALE_A 0
#endif
#ifndef SVT_DEEP_ONE_PASS
#define SVT_DEEP_ONE_PASS 0
#endif

namespace {

using namespace svt;
using namespace sm90;

// The operands of these passes: K90's, with one TF32 product in the
// SVT_DEEP_ONE_PASS copy.
template <bool BF16, int SUBS = 1>
struct KD : K90<BF16, SUBS> {
  static constexpr bool SPLIT = K90<BF16, SUBS>::SPLIT && !SVT_DEEP_ONE_PASS;
};
template <bool BF16>
using FwdKD = KD<BF16, BF16 ? 2 : 1>;

// Output column chunks of a product over H rows, and its padded rows.
__host__ __device__ constexpr int chunks_of(int h) { return (h + KW - 1) / KW; }
__host__ __device__ constexpr int rows_of(int h) { return chunks_of(h) * KW; }

// Bytes of one 64-pixel block of a dW operand workspace of R rows.
template <bool BF16>
__host__ __device__ constexpr size_t ws_block(int R) {
  return size_t(R) * PT * (BF16 ? 2 : 4);
}

// Element i of a read-only float or bf16 input, as f32, through the
// non-coherent path (the compiler may then issue it ahead of stores).
template <bool IS_BF16>
__device__ __forceinline__ float ldg_elem(const void* p, size_t i) {
  if (IS_BF16)
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
  return __ldg(static_cast<const float*>(p) + i);
}

// lo, hi rounded to bf16 as one word (lo at the lower address).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Positions pos, pos + 1 (pos even) of row r of one block of a dW operand
// workspace of R rows: 64-byte K chunks of R swizzled rows.
template <bool BF16>
__device__ __forceinline__ void store_wsr_pair(uint8_t* blk, int R, int r,
                                               int pos, float v0, float v1) {
  constexpr int ESZ = BF16 ? 2 : 4;
  constexpr int per = SB / ESZ;                    // positions per chunk
  const size_t off = size_t(pos / per) * R * SB +
                     offset_sw64(r, (pos % per) * ESZ);
  if (BF16)
    *reinterpret_cast<__nv_bfloat162*>(blk + off) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(blk + off) = make_float2(v0, v1);
}

// ---------------------------------------------------------------------------
// K1: one layer's forward pass
// ---------------------------------------------------------------------------

struct Layer90Args {
  const float* fold;      // (B, 4, H)
  const float* coords;    // (HW, 2)
  const uint8_t* wslabs;  // W_l^T's chunked slab stream
  const float* bias;      // (H,) b_l f32
  const float* wht;       // (No, H) f32, the last layer's head
  const float* bht;       // (No,) f32
  const float* a_in;      // (B, HW, H) f32 a_{l-1}; layer 1: none (a0)
  float* a_out;           // (B, HW, H) f32 a_l, or null
  __nv_bfloat16* a_bf16;  // (B, HW, H) a_l rounded to bf16, or null
  float* y;               // (B, No, HW), the last layer
  int HW, H, No, tiles, total, nch, last;
};

template <bool BF16>
struct Layer90Smem {
  using C = FwdKD<BF16>;
  uint8_t ring[C::STAGES][C::SLAB];
  // the A slabs; after a chunk's product, its head weights and bias
  union {
    uint8_t a[C::NA][C::ASLAB];
    float head[(MAX_NO + 1) * KW];
  } u;
  float red[WG * MAX_NO * PT];       // the head's partials per warpgroup
  uint64_t full[C::STAGES], empty[C::STAGES];
};
static_assert(sizeof(Layer90Smem<false>) <= 232448, "shared memory, f32");
static_assert(sizeof(Layer90Smem<true>) <= 232448, "shared memory, bf16");

// The values of slab s of a_{l-1} this thread builds (zero past H, past HW
// and on a padding tile), loaded from the f32 buffer a slab before they
// are built, as the first layer's fold rows are: the loads of a slab in
// flight together, their latency behind the products.
template <bool BF16>
struct AInVals {
  float v[FwdKD<BF16>::PPT][2];
};
template <bool BF16>
__device__ __forceinline__ AInVals<BF16> load_a_in(const Layer90Args& a,
                                                  int b, int p0, bool valid,
                                                  int s) {
  using C = FwdKD<BF16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = s * C::KS + C::CW * (warp % C::CG) + lane % C::CW;
  const bool on = valid && col < a.H;
  const size_t img = SVT_DEEP_STALE_A ? 0 : size_t(b) * a.HW;
  AInVals<BF16> r;
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = p0 + pair_pixel(q, h);
      r.v[k][h] = on && pix < a.HW
                      ? __ldg(a.a_in + (img + pix) * a.H + col) : 0.f;
    }
  }
  return r;
}

// Slab s of cast(a_{l-1}) for the tile's pixels into `dst` from its
// loaded values.
template <bool BF16>
__device__ __forceinline__ void build_a_in(const AInVals<BF16>& r,
                                           uint8_t* dst) {
  using C = FwdKD<BF16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = C::CW * (warp % C::CG) + lane % C::CW;
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_a<C>(dst, pair_pixel(q, h), c, operand<BF16>(r.v[k][h]));
  }
}

// The epilogue of one output column chunk: bias, the residual add, tanh,
// the activation outputs, and on the last layer the head's partials.
template <bool BF16, bool RESID, bool FIRST>
__device__ __forceinline__ void layer_epilogue(const Layer90Args& a,
                                               Layer90Smem<BF16>& sm,
                                               float (&acc)[64], int b,
                                               int p0, bool valid, int ch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, n0 = ch * KW;
  // the chunk's head weights and bias to shared memory, zero past H
  float* wsm = sm.u.head;
  float* bsm = wsm + MAX_NO * KW;
  for (int i = tid; i < (MAX_NO + 1) * KW; i += NT90) {
    const int o = i / KW, n = n0 + i % KW;
    float v = 0.f;
    if (n < H)
      v = o == MAX_NO ? a.bias[n]
                      : (a.last && o < No) ? a.wht[size_t(o) * H + n] : 0.f;
    wsm[i] = v;
  }
  __syncthreads();

  // a_l = tanh(acc + b_l [+ a_{l-1}]) in place
  const int px0 = 16 * w + g, px1 = px0 + 8;
  const int pix0 = p0 + px0, pix1 = p0 + px1;
  const bool on0 = valid && pix0 < HW, on1 = valid && pix1 < HW;
  const size_t row0 = (size_t(b) * HW + pix0) * H;
  const size_t row1 = (size_t(b) * HW + pix1) * H;
  float xr[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (RESID && FIRST) {
    if (on0) xr[0][0] = a.coords[2 * pix0], xr[0][1] = a.coords[2 * pix0 + 1];
    if (on1) xr[1][0] = a.coords[2 * pix1], xr[1][1] = a.coords[2 * pix1 + 1];
  }
  const float* f = a.fold + size_t(b) * 4 * H;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int nc = acc_col(wg, t, j), n = n0 + nc, h = (j >> 1) & 1;
    float x = __fadd_rn(acc[j], bsm[nc]);
    if (RESID && n < H) {
      if (FIRST)
        x = __fadd_rn(x, tanhf(first_h0(xr[h][0], xr[h][1], f[n], f[H + n],
                                        f[2 * H + n])));
      else if (h ? on1 : on0)
        x = __fadd_rn(x, __ldg(a.a_in + (h ? row1 : row0) + n));
    }
    acc[j] = n < H ? tanhf(x) : 0.f;
  }
  if (a.a_out != nullptr || a.a_bf16 != nullptr) {
    // adjacent columns n, n + 1 of a row as one store where H is even
    const bool pairs = (H & 1) == 0;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int n = n0 + acc_col(wg, t, j), h = (j >> 1) & 1;
      if (!(h ? on1 : on0) || n >= H) continue;
      const size_t at = (h ? row1 : row0) + n;
      if (a.a_out != nullptr) {
        if (pairs)
          *reinterpret_cast<float2*>(a.a_out + at) =
              make_float2(acc[j], acc[j + 1]);
        else {
          a.a_out[at] = acc[j];
          if (n + 1 < H) a.a_out[at + 1] = acc[j + 1];
        }
      }
      if (a.a_bf16 != nullptr && (H & 3) != 0) {
        if (pairs)
          *reinterpret_cast<__nv_bfloat162*>(a.a_bf16 + at) =
              __floats2bfloat162_rn(acc[j], acc[j + 1]);
        else {
          a.a_bf16[at] = __float2bfloat16_rn(acc[j]);
          if (n + 1 < H) a.a_bf16[at + 1] = __float2bfloat16_rn(acc[j + 1]);
        }
      }
    }
  }
  if (a.a_bf16 != nullptr && (H & 3) == 0) {
    // a_l in bf16 a whole 32-byte sector of a row per quad and store: the
    // quad's lanes hold columns 8 nt + 2 t, + 1 of nt and nt + 1, and
    // exchange them so that lane t stores columns 8 nt + 4 t .. + 3
    const int src = (lane & ~3) + 2 * (t & 1);
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t p0 = pack_bf16(acc[4 * nt + 2 * h],
                                      acc[4 * nt + 2 * h + 1]);
        const uint32_t p1 = pack_bf16(acc[4 * nt + 4 + 2 * h],
                                      acc[4 * nt + 4 + 2 * h + 1]);
        const uint32_t a0 = __shfl_sync(0xffffffffu, p0, src);
        const uint32_t a1 = __shfl_sync(0xffffffffu, p0, src + 1);
        const uint32_t b0 = __shfl_sync(0xffffffffu, p1, src);
        const uint32_t b1 = __shfl_sync(0xffffffffu, p1, src + 1);
        const int n = n0 + 128 * wg + 8 * nt + 4 * t;
        if ((h ? on1 : on0) && n < H)
          *reinterpret_cast<uint2*>(a.a_bf16 + (h ? row1 : row0) + n) =
              t < 2 ? make_uint2(a0, a1) : make_uint2(b0, b1);
      }
    }
  }
  if (a.last && !(SVT_DEEP_DROP_HEAD && ch == a.nch - 1)) {
    // the head over this chunk's columns, as the default forward's, each
    // (warpgroup, output, pixel) slot added to in chunk order by the one
    // thread that owns it
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
        float* r = sm.red + (wg * MAX_NO + o) * PT;
        r[px0] = ch ? r[px0] + r0 : r0;
        r[px1] = ch ? r[px1] + r1 : r1;
      }
    }
  }
  __syncthreads();        // the head weights are read; A may be rebuilt
}

template <bool BF16, bool RESID, bool FIRST>
__global__ void __launch_bounds__(NT90, 1)
dec_layer90_kernel(const Layer90Args a, int nquads) {
  using C = FwdKD<BF16>;
  extern __shared__ __align__(1024) uint8_t smem90[];
  Layer90Smem<BF16>& sm = *reinterpret_cast<Layer90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int H = a.H, HW = a.HW, No = a.No;
  const int ntl = tiles_of_cta(nquads);
  const int nsk = slab_k(H) / C::KS;   // slabs of one chunk
  const int nslab = a.nch * nsk;       // the stream: chunk after chunk
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
    for (int ch = 0; ch < a.nch; ++ch) {
      const int base = (k * a.nch + ch) * nsk;
      FoldCol fc{0.f, 0.f, 0.f};
      AInVals<BF16> av;
      if (FIRST) {
        build_a0<BF16>(a, p0, valid, 0, fold_col<C>(a.fold, H, b, valid, 0),
                       sm.u.a[0]);
        fc = fold_col<C>(a.fold, H, b, valid, 1);
      } else {
        build_a_in<BF16>(load_a_in<BF16>(a, b, p0, valid, 0), sm.u.a[0]);
        av = load_a_in<BF16>(a, b, p0, valid, 1);
      }
      fence_proxy_async();
      __syncthreads();
      float acc[64];
      for (int s = 0; s < nsk; ++s) {
        const int seq = base + s;
        mma_slab90<C>(acc, sm.u.a[s % C::NA], ring.wait(seq), wg, s == 0);
        // as in the default forward: A slab s + 1 into the buffer of slab
        // s - 2, built while the tensor cores run slabs s - 1 and s
        if (s + 1 < nsk) {
          if (FIRST) {
            const FoldCol cur = fc;
            fc = fold_col<C>(a.fold, H, b, valid, s + 2);
            build_a0<BF16>(a, p0, valid, s + 1, cur,
                           sm.u.a[(s + 1) % C::NA]);
          } else {
            const AInVals<BF16> cur = av;
            av = load_a_in<BF16>(a, b, p0, valid, s + 2);
            build_a_in<BF16>(cur, sm.u.a[(s + 1) % C::NA]);
          }
          fence_proxy_async();
        }
        wgmma_wait<1>();
        if (s > 0) ring.release(seq - 1);
        __syncthreads();
        ring.refill(seq);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      ring.release(base + nsk - 1);
      __syncthreads();                  // every warpgroup's A reads done
      if (SVT_DEC90_CUT) {
        cut_store(acc, a.y + size_t(b) * No * HW + p0);
        continue;
      }
      layer_epilogue<BF16, RESID, FIRST>(a, sm, acc, b, p0, valid, ch);
    }
    if (a.last && !SVT_DEC90_CUT && tid < No * PT) {
      const int o = tid / PT, pp = tid % PT, pix = p0 + pp;
      float z = 0.f;
      for (int q = 0; q < WG; ++q) z += sm.red[(q * MAX_NO + o) * PT + pp];
      if (valid && pix < HW)
        a.y[(size_t(b) * No + o) * HW + pix] =
            1.f / (1.f + expf(-(z + a.bht[o])));
    }
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// K2: one layer's chain pass and dW_l
// ---------------------------------------------------------------------------

struct ChainL90Args {
  const float* fold;      // (Bc, 4, H)
  const float* coords;    // (HW, 2)
  const uint8_t* wslabs;  // W_l's chunked slab stream (rows: input unit)
  const float* wht;       // (No, H) f32
  const void* acts;       // a_l (Bc, HW, H), f32 or bf16
  const void* acts_in;    // a_{l-1} (Bc, HW, H), the same dtype; l >= 2
  const float* da_in;     // da_l (Bc, HW, H) f32 below the top layer
  float* da_out;          // da_{l-1} (Bc, HW, H) f32 above the bottom layer
  const float* y;         // (Bc, No, HW), the top layer
  const float* gy;        // (Bc, No, HW)
  float* part_fold;       // (Bc*tiles, 3, H), the bottom layer
  float* part_w;          // (Bc*tiles, Mw): db_1..db_Lh | dWh^T | dbh
  uint8_t* ws_a;          // (Bc*tiles) blocks of R rows: cast(a_{l-1})^T
  uint8_t* ws_dh;         // the same for cast(dh_l)^T
  int HW, H, No, tiles, total, nch, top, db_off, head_off, Mw;
};

template <bool BF16>
struct ChainL90Smem {
  using C = KD<BF16>;
  uint8_t ring[C::STAGES][C::SLAB];
  union {
    struct {
      uint8_t a[C::NA][C::ASLAB];
      float red[2][C::RED];           // db_l's and dWh^T's column partials
    } m;
    float fold3[3][4][KW];            // dfold's column partials per warp
  } u;
  float dz[MAX_NO * PT];
  float dzc[MAX_NO * PT];
  uint64_t full[C::STAGES], empty[C::STAGES];
};
static_assert(sizeof(ChainL90Smem<false>) <= 232448, "shared memory, f32");
static_assert(sizeof(ChainL90Smem<true>) <= 232448, "shared memory, bf16");

// Slab s of cast(dh_l) into `dst`; with `part` (a tile's first chunk) also
// its columns' db_l (and at the top dWh^T) partials into `red` and
// cast(dh_l)^T to the block's workspace of R rows.
template <bool BF16, bool ACT_BF16>
__device__ __forceinline__ void build_dhl(const ChainL90Args& a,
                                          const float* dzc, int b, int p0,
                                          bool valid, int s, bool part,
                                          uint8_t* dst, float* red,
                                          uint8_t* ws, int R) {
  using C = KD<BF16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = C::CW * (warp % C::CG) + lane % C::CW;
  const int j = s * C::KS + c;
  const bool on = valid && j < a.H;
  const int No = a.No;
  const bool top = a.top;
  float sdb = 0.f, swt[MAX_NO];
#pragma unroll
  for (int o = 0; o < MAX_NO; ++o) swt[o] = 0.f;
  // the slab's a_l and da_l loads first, all in flight together
  float als[C::PPT][2], das[C::PPT][2];
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pix = p0 + pair_pixel(q, h);
      const size_t at = (size_t(b) * a.HW + pix) * a.H + j;
      const bool in = on && pix < a.HW;
      als[k][h] = in ? ldg_elem<ACT_BF16>(a.acts, at) : 0.f;
      das[k][h] = in && !top ? __ldg(a.da_in + at) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
    float dh[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pair_pixel(q, h), pix = p0 + p;
      const float al = als[k][h];
      float v = 0.f;
      if (on && pix < a.HW)
        v = top ? dh1_of(al, dzc, a.wht, p, j, a.H, No)
                : __fmul_rn(das[k][h], __fsub_rn(1.f, __fmul_rn(al, al)));
      if (part) {
        sdb += v;
        if (top) {
          const float alc = operand<BF16>(al);
#pragma unroll
          for (int o = 0; o < MAX_NO; ++o)
            if (o < No) swt[o] = fmaf(dzc[o * PT + p], alc, swt[o]);
        }
      }
      dh[h] = operand<BF16>(v);
      store_a<C>(dst, p, c, dh[h]);
    }
    if (part && valid) store_wsr_pair<BF16>(ws, R, j, 2 * q, dh[0], dh[1]);
  }
  if (!part) return;
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

// The chain's epilogue of one chunk (rows i = n0 .. n0 + 511 of da_{l-1}):
// the residual add's + dh_l; then above the bottom layer da_{l-1} to its
// buffer and cast(a_{l-1})^T to the workspace, at the bottom dh0 with a0
// rebuilt, cast(a0)^T and dfold's column partials.
template <bool BF16, bool RESID, bool ACT_BF16, bool BOTTOM>
__device__ __forceinline__ void chainl_epilogue(const ChainL90Args& a,
                                                ChainL90Smem<BF16>& sm,
                                                float (&acc)[64], int tb,
                                                int b, int p0, bool valid,
                                                int ch, int R) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int H = a.H, HW = a.HW, No = a.No, n0 = ch * KW;
  const int px0 = 16 * w + g, px1 = px0 + 8;
  const int pix0 = p0 + px0, pix1 = p0 + px1;
  const bool on0 = valid && pix0 < HW, on1 = valid && pix1 < HW;
  const size_t row0 = (size_t(b) * HW + pix0) * H;
  const size_t row1 = (size_t(b) * HW + pix1) * H;
  uint8_t* wsa = a.ws_a + size_t(valid ? tb : 0) * ws_block<BF16>(R);
  if (RESID) {
    if (a.top) {
      // as the default chain: eight accumulator values at a time, each
      // da_Lh summed over the outputs in dh1_of's order
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
            const int i = n0 + acc_col(wg, t, j0 + u);
            const float wv = i < H ? __ldg(wo + i) : 0.f;
            da1[u] = fmaf((u >> 1) & 1 ? d1 : d0, wv, da1[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u, i = n0 + acc_col(wg, t, j), h = (j >> 1) & 1;
          if (i < H && (h ? on1 : on0)) {
            const float al = ldg_elem<ACT_BF16>(a.acts, (h ? row1 : row0) + i);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(da1[u], __fsub_rn(
                                           1.f, __fmul_rn(al, al))));
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int i = n0 + acc_col(wg, t, j), h = (j >> 1) & 1;
        if (i < H && (h ? on1 : on0)) {
          const size_t at = (h ? row1 : row0) + i;
          const float al = ldg_elem<ACT_BF16>(a.acts, at);
          acc[j] = __fadd_rn(acc[j], __fmul_rn(__ldg(a.da_in + at), __fsub_rn(
                                         1.f, __fmul_rn(al, al))));
        }
      }
    }
  }
  if (!BOTTOM) {
    // da_{l-1} to its buffer, adjacent columns as one store where H is
    // even; then cast(a_{l-1})^T, the pixel pair of each row
    const bool pairs = (H & 1) == 0;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int i = n0 + acc_col(wg, t, j), h = (j >> 1) & 1;
      if (!(h ? on1 : on0) || i >= H) continue;
      float* d = a.da_out + (h ? row1 : row0) + i;
      if (pairs) {
        *reinterpret_cast<float2*>(d) = make_float2(acc[j], acc[j + 1]);
      } else {
        d[0] = acc[j];
        if (i + 1 < H) d[1] = acc[j + 1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int i = n0 + acc_col(wg, t, 4 * nt);
      float ain[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool on = h ? on1 : on0;
        const size_t at = (h ? row1 : row0) + i;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ain[h][e] = on && i + e < H
                          ? operand<BF16>(ldg_elem<ACT_BF16>(a.acts_in,
                                                             at + e))
                          : 0.f;
      }
      if (valid) {
        store_wsr_pair<BF16>(wsa, R, i, 16 * w + 2 * g, ain[0][0], ain[1][0]);
        store_wsr_pair<BF16>(wsa, R, i + 1, 16 * w + 2 * g, ain[0][1],
                             ain[1][1]);
      }
    }
    __syncthreads();                  // the union is free for the next chunk
    return;
  }
  // the bottom layer: dh0 = (da0 [+ dh1]) (1 - a0^2) with a0 rebuilt,
  // cast(a0)^T to its workspace, dfold's column partials (the default
  // chain's epilogue at the chunk's columns)
  float xr[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  if (on0) xr[0][0] = a.coords[2 * pix0], xr[0][1] = a.coords[2 * pix0 + 1];
  if (on1) xr[1][0] = a.coords[2 * pix1], xr[1][1] = a.coords[2 * pix1 + 1];
  const float* f = a.fold + size_t(b) * 4 * H;
#pragma unroll
  for (int cq = 0; cq < 4; ++cq) {
    float s0[8], s1[8], s2[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nt = 4 * cq + u;
      const int i0 = n0 + acc_col(wg, t, 4 * nt);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + e;
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
        if (valid) store_wsr_pair<BF16>(wsa, R, i, 16 * w + 2 * g, a0c[0],
                                        a0c[1]);
      }
    }
    const int n = chunk_col(wg, t, g, cq);
    sm.u.fold3[0][w][n] = reduce_scatter8(s0);
    sm.u.fold3[1][w][n] = reduce_scatter8(s1);
    sm.u.fold3[2][w][n] = reduce_scatter8(s2);
  }
  __syncthreads();
  if (valid && n0 + tid < H) {
    float* pf = a.part_fold + size_t(tb) * 3 * H + n0;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      pf[r * H + tid] = sm.u.fold3[r][0][tid] + sm.u.fold3[r][1][tid] +
                        sm.u.fold3[r][2][tid] + sm.u.fold3[r][3][tid];
  }
  __syncthreads();                    // the union is free for the next chunk
}

template <bool BF16, bool RESID, bool ACT_BF16, bool BOTTOM>
__global__ void __launch_bounds__(NT90, 1)
dec_chainl90_kernel(const ChainL90Args a, int nquads) {
  using C = KD<BF16>;
  extern __shared__ __align__(1024) uint8_t smem90[];
  ChainL90Smem<BF16>& sm = *reinterpret_cast<ChainL90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int H = a.H, HW = a.HW, No = a.No;
  const int R = a.nch * KW;
  const int ntl = tiles_of_cta(nquads);
  const int nsk = slab_k(H) / C::KS;
  const int nslab = a.nch * nsk;
  const int kinds = a.top ? 1 + No : 1;     // db_l (and dWh^T) partials
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
    float* pw = a.part_w + size_t(valid ? tb : 0) * a.Mw;
    uint8_t* wsd = a.ws_dh + size_t(valid ? tb : 0) * ws_block<BF16>(R);
    if (a.top) {
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
        pw[a.head_off + No * H + tid] = s;
      }
    }
    for (int ch = 0; ch < a.nch; ++ch) {
      const bool part = ch == 0;
      const int base = (k * a.nch + ch) * nsk;
      build_dhl<BF16, ACT_BF16>(a, sm.dzc, b, p0, valid, 0, part,
                                sm.u.m.a[0], sm.u.m.red[0], wsd, R);
      fence_proxy_async();
      __syncthreads();
      // da_{l-1} = cast(dh_l) . W_l^T over the chunk's rows, the next slab
      // of cast(dh_l) built beside it
      float acc[64];
      for (int s = 0; s < nsk; ++s) {
        const int seq = base + s;
        mma_slab90<C>(acc, sm.u.m.a[s % C::NA], ring.wait(seq), wg, s == 0);
        if (s + 1 < nsk) {
          build_dhl<BF16, ACT_BF16>(a, sm.dzc, b, p0, valid, s + 1, part,
                                    sm.u.m.a[(s + 1) % C::NA],
                                    sm.u.m.red[(s + 1) & 1], wsd, R);
          fence_proxy_async();
        }
        if (part && tid < kinds * C::KS) {
          const int kind = tid / C::KS, c = tid % C::KS, j = s * C::KS + c;
          const float* r = sm.u.m.red[s & 1] + kind * C::KS + c;
          float v = 0.f;
          for (int pg = 0; pg < C::PG; ++pg)
            v += r[pg * (1 + MAX_NO) * C::KS];
          if (valid && j < H)
            pw[kind == 0 ? a.db_off + j : a.head_off + (kind - 1) * H + j] = v;
        }
        wgmma_wait<1>();
        if (s > 0) ring.release(seq - 1);
        __syncthreads();
        ring.refill(seq);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      ring.release(base + nsk - 1);
      __syncthreads();                  // every warpgroup's A reads done
      if (SVT_DEC90_CUT) {
        cut_store(acc, BOTTOM ? a.part_fold + size_t(valid ? tb : 0) * 3 * H
                              : a.da_out + size_t(b) * HW * H + p0);
        continue;
      }
      chainl_epilogue<BF16, RESID, ACT_BF16, BOTTOM>(a, sm, acc, tb, b, p0,
                                                     valid, ch, R);
    }
  }
  cluster_sync();
}

// dW_l = sum_p cast(a_{l-1})^T[i][p] cast(dh_l)^T[j][p] from workspaces of
// R rows per block: the default dW kernel (fused_decoder_sm90.cu
// dec_dw90_kernel) with R rows and NS x NS quads of (128, 128) output
// tiles, NS = ceil(H / 256): CTA rank r of cluster blockIdx.x / 4 (sup =
// that % NS^2, split = blockIdx.x / (4 NS^2)) takes i-tile 2 (sup / NS) +
// r % 2 and j-tile 2 (sup % NS) + r / 2.  Split `split` writes its partial
// at part + split * out_stride.
constexpr int DW_NT = 256;                 // two warpgroups of 64 rows
constexpr int DW_WARPS = DW_NT / 32;
constexpr int DW_OPB = 128 * SB;           // one operand's rows of a stage
constexpr int DW_STAGE = 2 * DW_OPB;       // A rows, then B rows
constexpr int DW_STAGES = 8;

template <bool BF16>
struct DwW90Smem {
  uint8_t ring[DW_STAGES][DW_STAGE];
  // f32: three split copies of a stage, [A hi | A lo | B hi | B lo]
  uint8_t split[BF16 ? 1 : 3][BF16 ? 16 : 2 * DW_STAGE];
  uint64_t full[DW_STAGES], empty[DW_STAGES];
};
static_assert(sizeof(DwW90Smem<false>) <= 232448, "shared memory, f32");

__host__ __device__ constexpr int dw_quads(int h) { return (h + 255) / 256; }

template <bool BF16>
__global__ void __launch_bounds__(DW_NT, 1)
dec_dww90_kernel(const uint8_t* __restrict__ ws_a,
                 const uint8_t* __restrict__ ws_dh, float* __restrict__ part,
                 int nblk, int H, int bps, long long out_stride) {
  using C = KD<BF16>;
  constexpr int S = DW_STAGES;
  extern __shared__ __align__(1024) uint8_t smem90[];
  DwW90Smem<BF16>& sm = *reinterpret_cast<DwW90Smem<BF16>*>(smem90);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int R = rows_of(H), ns = dw_quads(H), per_split = CS * ns * ns;
  const size_t blk_bytes = ws_block<BF16>(R), chunk_bytes = size_t(R) * SB;
  const uint32_t rank = cluster_rank();
  const int ci = rank & 1, cj = rank >> 1;
  const int split = blockIdx.x / per_split;
  const int sup = (blockIdx.x % per_split) / CS;
  const int i0 = (2 * (sup / ns) + ci) * 128, j0 = (2 * (sup % ns) + cj) * 128;
  const int blk0 = split * bps;
  const int total = max(0, min(nblk, blk0 + bps) - blk0) * C::CH;
  const uint16_t mask_a = uint16_t((1u << ci) | (1u << (ci + 2)));
  const uint16_t mask_b = uint16_t(3u << (2 * cj));

  auto fetch = [&](int idx) {
    const int st = idx % S;
    if (idx >= S) mbar_wait(&sm.empty[st], uint32_t(idx / S - 1) & 1u);
    mbar_expect_tx(&sm.full[st], DW_STAGE);
    const size_t base = size_t(blk0 + idx / C::CH) * blk_bytes +
                        size_t(idx % C::CH) * chunk_bytes;
    uint8_t* dst = sm.ring[st];
    bulk_multicast(dst + cj * (DW_OPB / 2),
                   ws_a + base + size_t(i0) * SB + cj * (DW_OPB / 2),
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
      // the stage's TF32 head and tail into split copy idx % 3
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
  float* out = part + size_t(split) * size_t(out_stride);
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

template <bool BF16, bool RESID, bool FIRST>
cudaError_t launch_layer(const Layer90Args& a, cudaStream_t st) {
  static int cache = 0;
  auto k = dec_layer90_kernel<BF16, RESID, FIRST>;
  const int smem = int(sizeof(Layer90Smem<BF16>));
  const int nquads = (a.total + CS - 1) / CS;
  const int ncl = min(nquads, cached_clusters(k, NT90, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT90, smem, CS, st, a,
                         nquads);
}

template <bool BF16, bool RESID, bool ACT_BF16, bool BOTTOM>
cudaError_t launch_chainl(const ChainL90Args& a, cudaStream_t st) {
  static int cache = 0;
  auto k = dec_chainl90_kernel<BF16, RESID, ACT_BF16, BOTTOM>;
  const int smem = int(sizeof(ChainL90Smem<BF16>));
  const int nquads = (a.total + CS - 1) / CS;
  const int ncl = min(nquads, cached_clusters(k, NT90, smem, &cache));
  if (ncl < 1) return cudaErrorInvalidConfiguration;
  return launch_clusters(k, unsigned(ncl * CS), NT90, smem, CS, st, a,
                         nquads);
}

template <bool BF16, bool RESID, bool ACT_BF16>
cudaError_t launch_chainl_at(const ChainL90Args& a, bool bottom,
                             cudaStream_t st) {
  return bottom ? launch_chainl<BF16, RESID, ACT_BF16, true>(a, st)
                : launch_chainl<BF16, RESID, ACT_BF16, false>(a, st);
}

// The calls these passes take: Lh = 1..4 hidden layers, No <= 8, one
// hidden layer wider than 512 (fused_decoder_sm90.cu takes the narrower)
// or more layers at any width: every "sm90" call of decoder_route that
// single_pass does not send to the default-shape kernels.  Which deep
// decoders are narrow enough to stay on the tile kernels is the route
// table's choice alone (fused_decoder.DEEP_MIN_WIDTH, a measurement:
// `chip_smoke.py --sweep dec90` times these passes below it too).
bool refused(int B, int HW, int H, int Lh, int No) {
  return B < 1 || HW < 1 || H < 1 || Lh < 1 || Lh > MAX_LH ||
         (Lh == 1 && H <= KW) || No < 1 || No > MAX_NO ||
         double(B) * ((HW + PT - 1) / PT) > 2147483647.0;
}

}  // namespace

extern "C" {

// Bytes of one 64-pixel block of each dW operand workspace of these
// passes: R = 512 ceil(H / 512) rows x 64 pixels of f32 or bf16 values.
long long svt_decoder90_deep_ws_block(int h, int bf16) {
  if (h < 1) return 0;
  return bf16 ? (long long)ws_block<true>(rows_of(h))
              : (long long)ws_block<false>(rows_of(h));
}

// K1's pass for hidden layer `layer` (1..Lh) of a chunk of B images
// (pointers at its first image): fold (B,4,H), coords (HW,2), wslabs
// W_l^T's chunked slab stream, bias b_l (H,), wht (No,H), bht (No,) f32;
// a_in the f32 a_{l-1} (B,HW,H) (layer >= 2); outputs a_out (f32) and
// a_bf16 (a_l rounded to bf16), either null, and at the last layer y
// (B,No,HW).  Refuses (cudaErrorInvalidValue) a call outside the route or
// without the buffers its layer needs.
int svt_decoder90_layer(const void* fold, const void* coords,
                        const void* wslabs, const void* bias, const void* wht,
                        const void* bht, const void* a_in, void* a_out,
                        void* a_bf16, void* y, int B, int HW, int H, int Lh,
                        int No, int layer, int resid, int bf16,
                        void* stream) {
  const bool last = layer == Lh;
  if (refused(B, HW, H, Lh, No) || layer < 1 || layer > Lh ||
      (layer > 1) != (a_in != nullptr) || (!last && a_out == nullptr) ||
      (last && y == nullptr))
    return int(cudaErrorInvalidValue);
  const int tiles = (HW + PT - 1) / PT;
  const Layer90Args a{static_cast<const float*>(fold),
                      static_cast<const float*>(coords),
                      static_cast<const uint8_t*>(wslabs),
                      static_cast<const float*>(bias),
                      static_cast<const float*>(wht),
                      static_cast<const float*>(bht),
                      static_cast<const float*>(a_in),
                      static_cast<float*>(a_out),
                      static_cast<__nv_bfloat16*>(a_bf16),
                      static_cast<float*>(y), HW, H, No, tiles, B * tiles,
                      chunks_of(H), int(last)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SVT_L90(B16, R)                                                  \
  (layer == 1 ? launch_layer<B16, R, true>(a, st)                        \
              : launch_layer<B16, R, false>(a, st))
  cudaError_t err;
  if (bf16)
    err = resid ? SVT_L90(true, true) : SVT_L90(true, false);
  else
    err = resid ? SVT_L90(false, true) : SVT_L90(false, false);
#undef SVT_L90
  return int(err);
}

// K2's chain pass for hidden layer `layer` (Lh .. 1, in that order) of a
// chunk of Bc images: wslabs W_l's chunked slab stream, wht (No,H) f32,
// acts a_l and acts_in a_{l-1} (Bc,HW,H) f32 or bf16 (act_bf16; acts_in
// for layer >= 2), da_in da_l (Bc,HW,H) f32 below the top, da_out
// da_{l-1} above the bottom, y and gy (Bc,No,HW) at the top; writes its
// columns of part_w (Bc*tiles, (Lh+No)*H+No), part_fold (Bc*tiles,3,H) at
// the bottom, and the dW_l operands ws_a, ws_dh (Bc*tiles blocks of
// svt_decoder90_deep_ws_block bytes).  Refuses a call outside the route or
// without the buffers its layer needs.
int svt_decoder90_chain_layer(const void* fold, const void* coords,
                              const void* wslabs, const void* wht,
                              const void* acts, const void* acts_in,
                              const void* da_in, void* da_out, const void* y,
                              const void* gy, void* part_fold, void* part_w,
                              void* ws_a, void* ws_dh, int Bc, int HW, int H,
                              int Lh, int No, int layer, int resid, int bf16,
                              int act_bf16, void* stream) {
  const bool top = layer == Lh, bottom = layer == 1;
  if (refused(Bc, HW, H, Lh, No) || layer < 1 || layer > Lh ||
      (act_bf16 && !bf16) || acts == nullptr || part_w == nullptr ||
      ws_a == nullptr || ws_dh == nullptr ||
      (top ? (y == nullptr || gy == nullptr) : da_in == nullptr) ||
      (bottom ? part_fold == nullptr
              : (da_out == nullptr || acts_in == nullptr)))
    return int(cudaErrorInvalidValue);
  const int tiles = (HW + PT - 1) / PT;
  const ChainL90Args a{static_cast<const float*>(fold),
                       static_cast<const float*>(coords),
                       static_cast<const uint8_t*>(wslabs),
                       static_cast<const float*>(wht), acts, acts_in,
                       static_cast<const float*>(da_in),
                       static_cast<float*>(da_out),
                       static_cast<const float*>(y),
                       static_cast<const float*>(gy),
                       static_cast<float*>(part_fold),
                       static_cast<float*>(part_w),
                       static_cast<uint8_t*>(ws_a),
                       static_cast<uint8_t*>(ws_dh), HW, H, No, tiles,
                       Bc * tiles, chunks_of(H), int(top),
                       (layer - 1) * H, Lh * H, (Lh + No) * H + No};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16)
    err = resid ? launch_chainl_at<false, true, false>(a, bottom, st)
                : launch_chainl_at<false, false, false>(a, bottom, st);
  else if (act_bf16)
    err = resid ? launch_chainl_at<true, true, true>(a, bottom, st)
                : launch_chainl_at<true, false, true>(a, bottom, st);
  else
    err = resid ? launch_chainl_at<true, true, false>(a, bottom, st)
                : launch_chainl_at<true, false, false>(a, bottom, st);
  return int(err);
}

// dW_l's split-K partials (H, H) f32 from the chain pass's workspaces of
// nblk blocks, split s at part + s * out_stride floats.
int svt_decoder90_dw_deep(const void* ws_a, const void* ws_dh, void* part,
                          int nblk, int H, int splits, long long out_stride,
                          int bf16, void* stream) {
  const long long grid = (long long)splits * CS * dw_quads(H) * dw_quads(H);
  if (nblk < 1 || H < 1 || splits < 1 || splits > nblk ||
      out_stride < (long long)H * H || grid > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const int bps = (nblk + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* wa = static_cast<const uint8_t*>(ws_a);
  const auto* wd = static_cast<const uint8_t*>(ws_dh);
  auto* out = static_cast<float*>(part);
  return int(bf16 ? launch_clusters(dec_dww90_kernel<true>, unsigned(grid),
                                    DW_NT, int(sizeof(DwW90Smem<true>)), CS,
                                    st, wa, wd, out, nblk, H, bps, out_stride)
                  : launch_clusters(dec_dww90_kernel<false>, unsigned(grid),
                                    DW_NT, int(sizeof(DwW90Smem<false>)), CS,
                                    st, wa, wd, out, nblk, H, bps,
                                    out_stride));
}

// Clusters of 4 the card holds at once: 0 layer pass f32, 1 layer pass
// bf16 (layer 1, no residual add), 2 chain pass f32, 3 chain pass bf16
// (the bottom layer, the residual in the weight dtype), 4 dW f32, 5 dW
// bf16.
int svt_decoder90_deep_max_clusters(int which) {
  static int c[6] = {0, 0, 0, 0, 0, 0};
  switch (which) {
    case 0: return cached_clusters(dec_layer90_kernel<false, false, true>,
                                   NT90, int(sizeof(Layer90Smem<false>)),
                                   &c[0]);
    case 1: return cached_clusters(dec_layer90_kernel<true, false, true>,
                                   NT90, int(sizeof(Layer90Smem<true>)),
                                   &c[1]);
    case 2: return cached_clusters(
                dec_chainl90_kernel<false, false, false, true>, NT90,
                int(sizeof(ChainL90Smem<false>)), &c[2]);
    case 3: return cached_clusters(
                dec_chainl90_kernel<true, false, true, true>, NT90,
                int(sizeof(ChainL90Smem<true>)), &c[3]);
    case 4: return cached_clusters(dec_dww90_kernel<false>, DW_NT,
                                   int(sizeof(DwW90Smem<false>)), &c[4]);
    case 5: return cached_clusters(dec_dww90_kernel<true>, DW_NT,
                                   int(sizeof(DwW90Smem<true>)), &c[5]);
    default: return 0;
  }
}

}  // extern "C"
