// The pieces that K1/K2's cluster kernels share: fused_decoder_sm90.cu
// (one hidden layer at most 512 wide) and fused_decoder_sm90_deep.cu (every
// other width and depth, one pass per layer).  The product's operands and
// their slab layout, the A slabs' element stores, W's multicast slab ring,
// the warpgroup's products of a slab, the walk of a CTA over its tiles, and
// the first layer's and the head's arithmetic in the plain version's op
// order.  fused_decoder_sm90.cu's header says what each does and why.

#pragma once

#include "decoder_tile.cuh"
#include "sm90.cuh"

#ifndef SVT_DEC90_CUT
#define SVT_DEC90_CUT 0
#endif

namespace {

using namespace svt;
using namespace sm90;

constexpr int CS = 4;              // CTAs per cluster
constexpr int KW = 512;            // output rows of every product (padded)
constexpr int SB = 64;             // K bytes of a slab row
constexpr int PART = KW * SB;      // one plane of a W slab: 32 KiB
constexpr int NT90 = 512;          // threads: four warpgroups
constexpr int WARPS90 = NT90 / 32;
constexpr int WG = 4;
constexpr int ATILE = PT * SB;     // one plane of an A slab: 4 KiB

// The operands of one product: BF16 or f32 weights, slabs of SUBS 64-byte
// K units (the host's stream is the units in K order, each its planes).
template <bool BF16, int SUBS = 1>
struct K90 {
  static constexpr int ESZ = BF16 ? 2 : 4;        // bytes of an operand
  static constexpr int PLANES = BF16 ? 1 : 2;     // hi (, lo)
  static constexpr bool SPLIT = !BF16 && SVT_TF32_SPLIT;
  static constexpr int UNIT = SB / ESZ;           // K values per unit
  static constexpr int KS = SUBS * UNIT;          // K values per slab
  static constexpr int SLAB = SUBS * PLANES * PART;
  static constexpr int STAGES = SUBS * PLANES == 2 ? 3 : 4;
  static constexpr int ASLAB = SUBS * PLANES * ATILE;
  static constexpr int NA = 3;                    // A slabs: see the loop
  // the build's thread map: a warp takes CW adjacent columns (16 bytes of a
  // row) of RPW pixel pairs; CG column groups, PG warps (pair groups) per
  // column group, PPT pairs per thread
  static constexpr int CW = 16 / ESZ;
  static constexpr int RPW = 32 / CW;
  static constexpr int CG = KS / CW;
  static constexpr int PG = WARPS90 / CG;
  static constexpr int PPT = (PT / 2) / (RPW * PG);
  static constexpr int RED = PG * (1 + MAX_NO) * KS;
  // bytes of one 64-pixel block of a dW1 operand workspace: the cast
  // values (f32 or bf16), split by the dW1 kernel
  static constexpr int WS_BLOCK = KW * PT * ESZ;
  static constexpr int CH = PT * ESZ / SB;        // its 64-byte K chunks
};
// The forward takes 128-byte slabs in bf16 (half the iterations of 64);
// the chain's shared memory holds only 64-byte ones beside its partials.
template <bool BF16>
using Fwd90K = K90<BF16, BF16 ? 2 : 1>;

// K of the slab streams: H up to a multiple of 64 (one or two slabs' K).
__host__ __device__ constexpr int slab_k(int h) { return (h + 63) / 64 * 64; }

// The pixel of pair q's half h: pairs hold pixels 16 w + g and 16 w + g + 8
// (q = 8 w + g), the rows one accumulator thread holds; a workspace stores
// pair q's pixels at positions 2 q and 2 q + 1.
__device__ __forceinline__ int pair_pixel(int q, int h) {
  return 16 * (q >> 3) + (q & 7) + 8 * h;
}

// The first layer's pre-activation in the plain version's op order.
__device__ __forceinline__ float first_h0(float x0, float x1, float w0,
                                          float w1, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, w0), __fmul_rn(x1, w1)), c);
}

// x as the product's operand planes: hi = rna(x), lo = rna(x - hi) (lo 0
// with one TF32 product).
template <bool SPLIT>
__device__ __forceinline__ void planes(float x, float& hi, float& lo) {
  uint32_t h, l = 0u;
  if (SPLIT)
    split(x, h, l);
  else
    h = tf32(x);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// Element (pixel p, column c of the slab) of an A slab: its 64-byte unit,
// then its planes.
template <typename C>
__device__ __forceinline__ void store_a(uint8_t* a, int p, int c, float v) {
  constexpr bool BF16 = C::ESZ == 2;
  const int off = (c / C::UNIT) * (C::PLANES * ATILE) +
                  offset_sw64(p, (c % C::UNIT) * C::ESZ);
  if (BF16) {
    *reinterpret_cast<__nv_bfloat16*>(a + off) = __float2bfloat16_rn(v);
  } else {
    float hi, lo;
    planes<C::SPLIT>(v, hi, lo);
    *reinterpret_cast<float*>(a + off) = hi;
    *reinterpret_cast<float*>(a + ATILE + off) = lo;
  }
}

// Positions pos, pos + 1 (pos even) of row r of one block of a dW1 operand
// workspace: 64-byte K chunks of 512 swizzled rows.
template <bool BF16>
__device__ __forceinline__ void store_ws_pair(uint8_t* blk, int r, int pos,
                                              float v0, float v1) {
  using C = K90<BF16>;
  const int per = SB / C::ESZ;                     // positions per chunk
  const size_t off = size_t(pos / per) * PART +
                     offset_sw64(r, (pos % per) * C::ESZ);
  if (BF16)
    *reinterpret_cast<__nv_bfloat162*>(blk + off) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(blk + off) = make_float2(v0, v1);
}

// The ring of W slabs of one CTA (K3's cluster ring with this kernel's slab
// size): its stream is the `nslab` slabs of `w` once for every tile it runs,
// each slab multicast to the cluster's four rings in quarters, one per CTA.
// Every warp of every CTA releases each slab it has read; thread 0 refills a
// stage once its slab is released cluster-wide, one slab behind the
// consumption, so S - 1 slabs are in flight.
template <int S, int SLABB>
struct Ring90 {
  uint8_t* buf;
  uint64_t* full;
  uint64_t* empty;
  const uint8_t* w;
  int nslab, total;
  uint32_t rank;

  __device__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS90 * CS);
    }
    fence_mbar_init();
  }
  __device__ void fetch(int seq) const {
    const int st = seq % S;
    if (seq >= S) mbar_wait(&empty[st], uint32_t(seq / S - 1) & 1u);
    mbar_expect_tx(&full[st], SLABB);
    constexpr int Q = SLABB / CS;
    bulk_multicast(buf + size_t(st) * SLABB + rank * Q,
                   w + size_t(seq % nslab) * SLABB + rank * Q, Q, &full[st],
                   uint16_t((1u << CS) - 1));
  }
  __device__ void start() const {
    if (threadIdx.x == 0)
      for (int s = 0; s < S && s < total; ++s) fetch(s);
  }
  __device__ const uint8_t* wait(int seq) const {
    mbar_wait(&full[seq % S], uint32_t(seq / S) & 1u);
    return buf + size_t(seq % S) * SLABB;
  }
  __device__ void release(int seq) const {
    release_cluster(&empty[seq % S], CS);
  }
  __device__ void refill(int seq) const {
    if (threadIdx.x == 0 && seq >= 1 && seq - 1 + S < total)
      fetch(seq - 1 + S);
  }
};

// The warpgroup's products of one slab: acc (+)= A slab . W slab rows
// 128 wg .. +127, two 32-byte K steps, committed as one group.
template <typename C>
__device__ __forceinline__ void mma_slab90(float (&acc)[64],
                                           const uint8_t* a_slab,
                                           const uint8_t* slab, int wg,
                                           bool first) {
  constexpr bool BF16 = C::ESZ == 2;
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 2 * C::KS / C::UNIT; ++i) {
    const int u = i / 2, kk = 32 * (i % 2);
    const int acc_in = first && i == 0 ? 0 : 1;
    const uint8_t* a = a_slab + u * (C::PLANES * ATILE);
    const uint8_t* b = slab + u * (C::PLANES * PART) + 128 * wg * SB + kk;
    if (BF16) {
      wgmma_bf16_n128(acc, gmma_desc_sw64(a + kk), gmma_desc_sw64(b),
                      acc_in);
    } else if (C::SPLIT) {
      wgmma_tf32_n128(acc, gmma_desc_sw64(a + ATILE + kk),
                      gmma_desc_sw64(b), acc_in);
      wgmma_tf32_n128(acc, gmma_desc_sw64(a + kk),
                      gmma_desc_sw64(b + PART), 1);
      wgmma_tf32_n128(acc, gmma_desc_sw64(a + kk), gmma_desc_sw64(b), 1);
    } else {
      wgmma_tf32_n128(acc, gmma_desc_sw64(a + kk), gmma_desc_sw64(b),
                      acc_in);
    }
  }
  wgmma_commit();
}

// The measurement copy's end of a tile (SVT_DEC90_CUT): the products'
// sum stored where a result would go, so the compiler keeps every product
// (with the accumulator unread it drops them), and no epilogue.
__device__ __forceinline__ void cut_store(const float (&acc)[64],
                                          float* out) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 64; ++j) s += acc[j];
  if (threadIdx.x == 0) *out = s;
}

// The flattened (image, 64-pixel block) of tile k of this CTA: CTA `rank`
// of cluster c runs block 4 q + rank of quads q = c, c + clusters, ...; a
// block index past the last (the last quad's padding) is a tile that runs
// the products and writes nothing.
__device__ __forceinline__ int block_of(int k, uint32_t rank) {
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  return (cid + k * ncl) * CS + int(rank);
}
__device__ __forceinline__ int tiles_of_cta(int nquads) {
  const int cid = blockIdx.x / CS, ncl = gridDim.x / CS;
  return cid < nquads ? (nquads - 1 - cid) / ncl + 1 : 0;
}

// The fold row values (w0, w1, c) of this thread's column of slab s, zero
// past H and on a padding tile: loaded an iteration before the slab is
// built, so their latency hides behind the products.
struct FoldCol {
  float w0, w1, c;
};
template <typename C>
__device__ __forceinline__ FoldCol fold_col(const float* __restrict__ fold,
                                            int H, int b, bool valid, int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = s * C::KS + C::CW * (warp % C::CG) + lane % C::CW;
  const float* f = fold + size_t(b) * 4 * H + col;
  if (!valid || col >= H) return {0.f, 0.f, 0.f};
  return {f[0], f[H], f[2 * H]};
}

// Slab s of cast(a0) for the tile's pixels p0 .. p0+63 of image b into
// `dst` (zero past H, past HW and on a padding tile), from its column's fold
// values fc; `a` holds coords, H and HW.
template <bool BF16, typename Args>
__device__ __forceinline__ void build_a0(const Args& a, int p0,
                                         bool valid, int s, FoldCol fc,
                                         uint8_t* dst) {
  using C = Fwd90K<BF16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = C::CW * (warp % C::CG) + lane % C::CW;
  const bool on = valid && s * C::KS + c < a.H;
  const float w0 = fc.w0, w1 = fc.w1, cb = fc.c;
#pragma unroll
  for (int k = 0; k < C::PPT; ++k) {
    const int q = C::RPW * (warp / C::CG) + lane / C::CW + k * C::RPW * C::PG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pair_pixel(q, h), pix = p0 + p;
      float v = 0.f;
      if (on && pix < a.HW)
        v = operand<BF16>(tanhf(first_h0(a.coords[2 * pix],
                                         a.coords[2 * pix + 1], w0, w1, cb)));
      store_a<C>(dst, p, c, v);
    }
  }
}

// da1 (1 - a1^2) at (pixel p of the tile, column j) from a1 as stored, in
// the plain version's order; dzc: cast(dz2) of the tile.
__device__ __forceinline__ float dh1_of(float a1, const float* dzc,
                                        const float* __restrict__ wht, int p,
                                        int j, int H, int No) {
  float da1 = 0.f;
  for (int o = 0; o < No; ++o)
    da1 = fmaf(dzc[o * PT + p], __ldg(wht + size_t(o) * H + j), da1);
  return __fmul_rn(da1, __fsub_rn(1.f, __fmul_rn(a1, a1)));
}

}  // namespace
