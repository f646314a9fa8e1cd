// Attention at head dims above 256 (any multiple of 128): the kernels that
// B1, B2, B5 and B6 launch for such heads, on hopper_attention.cuh's
// primitives. The head-dim-128 and -256 designs hold a whole row of Q, of
// each K/V tile and of the output in a CTA; from 384 on those no longer
// fit in shared memory and registers, so this design cuts the work again:
//
//  * a CTA (one warpgroup, 128 threads) owns 64 query rows of one (batch,
//    head) and one slab of 128 output columns; the grid walks (row tile,
//    slab, head, batch), row tiles fastest;
//  * for each 64-key tile it computes S = Q K^T over the whole head dim in
//    chunks of 64 columns (bf16) or 128 bytes (int8): each chunk of Q
//    (64 rows) and of K (64 keys) is one 8 KB TMA box, in a ring of 2
//    stages, so the next chunk loads while wgmma m64n64 runs on this one;
//  * the online softmax and O += P V (wgmma m64n128k16, V's 128-column slab
//    of the tile read MN-major) as in the 128 design.
//
// Each slab recomputes S: the Q K^T work is D / 128 times that of one pass,
// and Q is read again for every key tile (from L2). This is the simple
// design; it is not fast (PERF.md).
//
// Modes: kDense (B1, B2: keys 0 .. Lk, masked at k_len), kSparse (B5: the
// key blocks of the query block's list; keys past a block's end do not
// count), kInt8 (B6: int8 Q K^T accumulated in s32, each logit s times
// (q scale * k scale) * (softmax scale * log2 e), the plain version's
// order).
//
// Every mode also runs fp32 (kF32, TF32 P.V) on the V^T workspace of the
// pre-pass (tf32_prep.cuh): V^T's slab as two 32-key spans of [128
// columns, 32 keys] read K-major by m64n128k8 steps with P from registers
// (probs_to_a_tf32). kDense and kSparse take the rounded Q and K in chunks
// of 32 columns (128 bytes, the same 8 KB boxes) by m64n64k8 steps; kInt8
// keeps its int8 Q and K chunks and s32 products. In kSparse a tile's
// first key, kidx * blk + a multiple of 64, is a multiple of 8 (blk is),
// so the pre-pass's order of each 8 keys holds in every tile.
#pragma once

#include "hopper_attention.cuh"

namespace flexam {
namespace hopper {
namespace wide {

enum Mode { kDense = 0, kSparse = 1, kInt8 = 2 };

constexpr int kRows = 64;                 // query rows a CTA
constexpr int kKeys = 64;                 // keys a tile
constexpr int kSlab = 128;                // output columns a CTA
constexpr int kThreads = 128;             // one warpgroup
constexpr float kNegInf = -__builtin_huge_valf();
constexpr uint32_t kChunkBytes = 64 * 128;           // 64 rows x 128 bytes
constexpr uint32_t kStageBytes = 2 * kChunkBytes;    // a Q and a K chunk
// V's slab of a tile: [64 keys, 128] bf16 (16 KB), or V^T's [128, 64 keys]
// fp32 (32 KB)
template <bool kF32>
__host__ __device__ constexpr uint32_t v_bytes() {
  return kKeys * kSlab * (kF32 ? 4 : 2);
}
template <bool kF32>
constexpr size_t smem_bytes() {
  return 1024 + 2 * kStageBytes + v_bytes<kF32>() + 3 * 8;
}

struct Params {
  const int* k_len;  // kDense, kInt8: [B] or null
  const int* kidx;   // kSparse: [nq, max_nnz]
  const int* nnz;    // kSparse: [nq]
  const float* qs;   // kInt8: [B, H, Lq] scale of each query row
  const float* ks;   // kInt8: [B, H, Lk] scale of each key
  void* o;           // [B, Lq, H, D], bf16 (fp32 for kF32)
  int B, H, D, Lq, Lk;
  int blk, max_nnz, q_tiles, k_tiles;  // kSparse: tiles of a block
  float scale_log2;  // softmax scale * log2(e)
};

// Work item `wi`: first query row q0, rows at or past q_end not stored,
// output slab, head, batch, query block (kSparse), valid keys (kDense,
// kInt8) and key tiles.
struct Item {
  int q0, q_end, slab, h, b, qb, valid, n_tiles;
};

template <int kMode, int kMaxTiles>
__device__ __forceinline__ Item item_of(const Params& a, int wi) {
  const int n_slabs = a.D / kSlab;
  Item w;
  int rest;
  if (kMode == kSparse) {
    const int per = (a.Lq / a.blk) * a.q_tiles;
    const int item = wi % per;
    rest = wi / per;
    w.qb = item / a.q_tiles;
    w.q0 = w.qb * a.blk + (item % a.q_tiles) * kRows;
    w.q_end = (w.qb + 1) * a.blk;
    w.valid = 0;
    w.n_tiles = a.nnz[w.qb] * a.k_tiles;
  } else {
    const int n_qt = (a.Lq + kRows - 1) / kRows;
    w.q0 = (wi % n_qt) * kRows;
    rest = wi / n_qt;
    w.qb = 0;
    w.q_end = a.Lq;
    w.valid = a.k_len ? max(0, min(a.k_len[rest / n_slabs / a.H], a.Lk))
                      : a.Lk;
    w.n_tiles = ((w.valid > 0 ? w.valid : a.Lk) + kKeys - 1) / kKeys;
    if (kMaxTiles > 0) w.n_tiles = min(w.n_tiles, kMaxTiles);
  }
  w.slab = rest % n_slabs;
  w.h = (rest / n_slabs) % a.H;
  w.b = rest / (n_slabs * a.H);
  return w;
}

// First key of tile t.
template <int kMode>
__device__ __forceinline__ int tile_key0(const Params& a, const Item& w,
                                         int t) {
  if (kMode == kSparse)
    return a.kidx[w.qb * a.max_nnz + t / a.k_tiles] * a.blk +
           (t % a.k_tiles) * kKeys;
  return t * kKeys;
}

template <int kMode, int kMaxTiles, bool kF32 = false>
__device__ __forceinline__ void wide_cta(const CUtensorMap* tq,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const Params& a) {
  constexpr uint32_t kVBytes = v_bytes<kF32>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t stage0 = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t v_s = stage0 + 2 * kStageBytes;
  const uint32_t bars = v_s + kVBytes;
  const uint32_t v_full = bars + 16;
  auto full = [&](int s) { return bars + 8u * s; };

  const Item w = item_of<kMode, kMaxTiles>(a, blockIdx.x);
  // chunks of 128 bytes of a row: 128 int8, 64 bf16 or 32 fp32 columns
  const int n_chunks =
      kMode == kInt8 ? a.D / 128 : (kF32 ? a.D / 32 : a.D / 64);
  const int total = w.n_tiles * n_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 3;

  // chunk g of the walk: Q's and tile g / n_chunks's K columns of chunk
  // g % n_chunks, into stage g % 2 (thread 0)
  auto load_chunk = [&](int g) {
    const int s = g & 1, c = g % n_chunks;
    const int k0 = tile_key0<kMode>(a, w, g / n_chunks);
    const uint32_t dst = stage0 + s * kStageBytes;
    mbar_arrive_expect_tx(full(s), kStageBytes);
    if (kMode == kInt8) {
      tma_load_i8_tile<1, 64>(dst, tq, full(s), w.h, w.q0, w.b, 128 * c);
      tma_load_i8_tile<1, 64>(dst + kChunkBytes, tk, full(s), w.h, k0, w.b,
                              128 * c);
    } else if (kF32) {
      tma_load_span_tile<1, 64, 32>(dst, tq, full(s), w.h, w.q0, w.b, 32 * c);
      tma_load_span_tile<1, 64, 32>(dst + kChunkBytes, tk, full(s), w.h, k0,
                                    w.b, 32 * c);
    } else {
      tma_load_bf16_tile<1, 64>(dst, tq, full(s), w.h, w.q0, w.b, 64 * c);
      tma_load_bf16_tile<1, 64>(dst + kChunkBytes, tk, full(s), w.h, k0,
                                w.b, 64 * c);
    }
  };
  // V's slab of tile t: two 64-column spans; in fp32, V^T's [B, D, H, Lkp]
  // rows of the slab, two 32-key spans
  auto load_v = [&](int t) {
    mbar_arrive_expect_tx(v_full, kVBytes);
    if (kF32)
      tma_load_span_tile<2, kSlab, 32>(v_s, tv, v_full, w.h, kSlab * w.slab,
                                       w.b, tile_key0<kMode>(a, w, t));
    else
      tma_load_bf16_tile<2, 64>(v_s, tv, v_full, w.h,
                                tile_key0<kMode>(a, w, t), w.b,
                                kSlab * w.slab);
  };

  if (tid == 0) {
    mbar_init(full(0), 1);
    mbar_init(full(1), 1);
    mbar_init(v_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_chunk(0);
    if (total > 1) load_chunk(1);
    load_v(0);
  }

  const int r_a = w.q0 + warp * 16 + (lane >> 2), r_b = r_a + 8;
  float qs_a = 1.f, qs_b = 1.f;
  const float* ks = nullptr;
  if (kMode == kInt8) {
    const float* qs = a.qs + ((size_t)w.b * a.H + w.h) * a.Lq;
    qs_a = r_a < a.Lq ? qs[r_a] : 1.f;
    qs_b = r_b < a.Lq ? qs[r_b] : 1.f;
    ks = a.ks + ((size_t)w.b * a.H + w.h) * a.Lk;
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < w.n_tiles; ++t) {
    // S accumulates from zero over the chunks (only one of sc, si is used)
    float sc[32];
    int si[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (kMode == kInt8)
        si[i] = 0;
      else
        sc[i] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int g = t * n_chunks + c, s = g & 1;
      const uint32_t qa = stage0 + s * kStageBytes, ka = qa + kChunkBytes;
      mbar_wait(full(s), (g >> 1) & 1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kMode == kInt8)
          wgmma_m64n64k32_s8_ss(si, sw128_desc(qa + 32 * k, 16, 1024),
                                sw128_desc(ka + 32 * k, 16, 1024));
        else if (kF32)
          wgmma_m64n64k8_tf32_ss(sc, sw128_desc(qa + 32 * k, 16, 1024),
                                 sw128_desc(ka + 32 * k, 16, 1024), 1);
        else
          wgmma_m64n64k16_ss(sc, sw128_desc(qa + 32 * k, 16, 1024),
                             sw128_desc(ka + 32 * k, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (kMode == kInt8)
        fence_regs(si);
      else
        fence_regs(sc);
      // every warp is done with stage s before it is loaded again
      __syncthreads();
      if (tid == 0 && g + 2 < total) load_chunk(g + 2);
    }

    // logits: keys before `keep` (from the tile's first key) scaled, keys
    // before `live` masked to -1e30, the rest (past Lk, or past a key
    // block's end) count not at all
    const int k0 = tile_key0<kMode>(a, w, t);
    int keep, live;
    if (kMode == kSparse) {
      keep = live = a.blk - (t % a.k_tiles) * kKeys;
    } else {
      keep = w.valid - t * kKeys;
      live = a.Lk - t * kKeys;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      float x;
      if (kMode == kInt8)
        x = col < live
                ? __int2float_rn(si[i]) *
                      ((((i & 2) ? qs_b : qs_a) * ks[k0 + col]) * a.scale_log2)
                : 0.f;
      else
        x = sc[i] * a.scale_log2;
      sc[i] = col < keep ? x : (col < live ? kNeg : kNegInf);
    }
    float al_a, al_b, sum_a, sum_b;
    softmax_tile_rows(sc, 1.f, 1.f, m_a, m_b, al_a, al_b, sum_a, sum_b);
    rescale_rows(o, al_a, al_b);
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    uint32_t p[kF32 ? 8 : 4][4];
    if constexpr (kF32)
      probs_to_a_tf32(sc, p);
    else
      probs_to_a(sc, p);

    // O += P V over the tile's 64 keys: bf16 in 4 steps of 16, V [keys,
    // 128] with the columns contiguous, MN-major, the two 64-column spans
    // 8 KB apart; fp32 in 8 steps of 8, V^T [128, keys] K-major, the two
    // 32-key spans 16 KB apart
    mbar_wait(v_full, t & 1);
    wgmma_fence();
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k8_tf32_rs(
            o, p[kk],
            sw128_desc(v_s + (kk >> 2) * kSlab * 128 + (kk & 3) * 32, 16,
                       1024));
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_rs_tb(o, p[kk],
                               sw128_desc(v_s + kk * 16 * 128, kChunkBytes,
                                          1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    __syncthreads();
    if (tid == 0 && t + 1 < w.n_tiles) load_v(t + 1);
  }

  // acc / sum (bf16, or fp32) into the slab's columns of [B, Lq, H, D];
  // rows at or past q_end are not written
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const size_t stride = (size_t)a.H * a.D;
  const size_t off = (size_t)w.b * a.Lq * stride + (size_t)w.h * a.D +
                     kSlab * w.slab + 2 * quad;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if constexpr (kF32) {
      float* base = static_cast<float*>(a.o) + off;
      if (r_a < w.q_end)
        *reinterpret_cast<float2*>(base + r_a * stride + 8 * j) =
            make_float2(o[4 * j] / l_a, o[4 * j + 1] / l_a);
      if (r_b < w.q_end)
        *reinterpret_cast<float2*>(base + r_b * stride + 8 * j) =
            make_float2(o[4 * j + 2] / l_b, o[4 * j + 3] / l_b);
    } else {
      bf16* base = static_cast<bf16*>(a.o) + off;
      if (r_a < w.q_end)
        *reinterpret_cast<uint32_t*>(base + r_a * stride + 8 * j) =
            pack_bf16(o[4 * j] / l_a, o[4 * j + 1] / l_a);
      if (r_b < w.q_end)
        *reinterpret_cast<uint32_t*>(base + r_b * stride + 8 * j) =
            pack_bf16(o[4 * j + 2] / l_b, o[4 * j + 3] / l_b);
    }
  }
}

// Work items of a launch.
template <int kMode>
inline long long n_items(const Params& a) {
  const long long per = kMode == kSparse
                            ? (long long)(a.Lq / a.blk) * a.q_tiles
                            : (a.Lq + kRows - 1) / kRows;
  return per * (a.D / kSlab) * a.H * a.B;
}

// Launch `kernel` (a __global__ wrapper of wide_cta) over every item of
// `a`, with maps over q, k (int8 for kInt8, else bf16, or fp32 for kF32)
// and v (bf16; for kF32 the V^T workspace [B, D, H, Lkp]) built here.
// Returns a cudaError_t.
template <int kMode, bool kF32 = false, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           const Params& a, void* stream, int Lkp = 0) {
  constexpr size_t kSmem = smem_bytes<kF32>();
  CUtensorMap tq, tk, tv;
  bool ok;
  if (kMode == kInt8)
    ok = make_bl_hd_map_i8(&tq, q, a.B, a.Lq, a.H, a.D, kRows) &&
         make_bl_hd_map_i8(&tk, k, a.B, a.Lk, a.H, a.D, kKeys);
  else if (kF32)
    ok = make_bl_hd_map_f32(&tq, q, a.B, a.Lq, a.H, a.D, 64) &&
         make_bl_hd_map_f32(&tk, k, a.B, a.Lk, a.H, a.D, 64);
  else
    ok = make_bl_hd_map(&tq, q, a.B, a.Lq, a.H, a.D, 64) &&
         make_bl_hd_map(&tk, k, a.B, a.Lk, a.H, a.D, 64);
  ok = ok && (kF32 ? make_bl_hd_map_f32(&tv, v, a.B, a.D, a.H, Lkp, 64)
                   : make_bl_hd_map(&tv, v, a.B, a.Lk, a.H, a.D, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items = n_items<kMode>(a);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)items, kThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace wide
}  // namespace hopper
}  // namespace flexam
