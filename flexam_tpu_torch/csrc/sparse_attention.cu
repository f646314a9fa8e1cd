// Block-sparse attention for video self-attention: kernel B5 of the port.
//
// Replaces flexam_tpu/ops/sparse_attention.py:_sparse_kernel. The token
// stream is cut into blocks of `blk` tokens (a frame, or `group` merged
// frames, of the DiT's video tokens, and the ref block); query block i
// attends to the key blocks kidx[i, :nnz[i]] only (the policy of
// ops/sparse_attention.py:video_sparse_policy), with exact softmax over
// those keys.
//
// Math, as in the TPU kernel and B1: logits in fp32 from bf16 q.k with
// log2(e) folded into the scale; online softmax in fp32 with exp2 over the
// active blocks in list order; probabilities cast to bf16 for P.V; the
// output is acc / sum.
//
// Layout: q, k, v, o [B, L, H, D] bf16, contiguous, D == 128, L = nq * blk;
// kidx [nq, max_nnz] and nnz [nq] int32 on the device, and one int32 of
// scratch on the device for the work counter, which the entry point zeroes
// on the stream before the launch.
//
// What bounds it on an H100: at 23,296 tokens with the w=2 policy (26
// blocks of 896, 147 active pairs) the work is 4*B*H*pairs*blk^2*D =
// 2.9e12 flops against about 0.6 GB of q/k/v/o: the tensor cores bound it.
//
// Design: B1's kernel (flash_attention.cu, on hopper_attention.cuh) with
// the producer walking a block list in place of a range of key tiles.
//  * a work item is 128 query rows (a row tile) of one query block of one
//    (batch, head), row tiles fastest, then query blocks; the items of one
//    (batch, head) are consecutive, so the CTAs running at one time share
//    that head's K/V in L2 (13 % faster than (batch, head) fastest). A
//    persistent CTA on each SM takes the next item from `counter` (an
//    atomic add by its producer) whenever it starts one: items differ in
//    length by up to 9x (3 to 26 key blocks), and taking every
//    gridDim.x-th item left some CTAs running 5-10 % longer than the rest.
//    (Walking the blocks with the most key blocks first changed nothing
//    measurable.)
//  * the producer thread loads the item's Q rows, then for each listed key
//    block kidx[qb, j] its ceil(blk / 128) key tiles, from row kidx * blk,
//    into B1's 3-stage K/V ring; the two consumer warpgroups run B1's
//    wgmma pipeline (Q K_t^T issued before P_{t-1} V_{t-1}), and skip the
//    accumulator's rescale when no row of a warp has a new maximum.
//  * `blk` is a multiple of 8 only: a key block's last tile may hold the
//    next block's keys (TMA loads them: they lie inside L), which get the
//    logit -1e30; the rows of an item past its block's end belong to the
//    next block and are computed but not stored. At 512x896 (blk 896 =
//    7 x 128) no edge falls inside a tile.

#include "hopper_attention.cuh"

namespace {

using flexam::bf16;
using namespace flexam::hopper;

constexpr int kD = 128;                 // head dim
constexpr int kBM = 128;                // query rows an item (2 x 64)
constexpr int kBN = 128;                // keys a tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kThreads = 3 * 128;       // producer + 2 consumer warpgroups
constexpr int kBoxRows = 64;            // TMA box: 64 rows x 64 columns
constexpr uint32_t kHalfBytes = 128 * 64 * sizeof(bf16);         // 16 KB
constexpr uint32_t kTileBytes = 2 * kHalfBytes;                  // 32 KB
constexpr uint32_t kBarBytes = 8 * (2 + 3 * kStages);
// + the current work item, handed from the producer to the consumers
constexpr size_t kSmemBytes =
    1024 + kTileBytes * (1 + 2 * kStages) + kBarBytes + 16;

struct Params {
  const int* kidx;   // [nq, max_nnz]
  const int* nnz;    // [nq]
  int* counter;      // the next work item to hand out
  bf16* o;           // [B, L, H, D]
  int B, H, L, blk, max_nnz, tiles, n_items;  // tiles: 128-row tiles a block
  float scale_log2;  // softmax scale * log2(e)
};

// Work item `wi`: row tile `t` of query block `qb` for head h, batch b,
// with nnz[qb] key blocks of `tiles` key tiles each (n_items = nq * tiles
// items a (batch, head)).
struct Work {
  int qb, t, h, b, nb, n_tiles;
};

__device__ __forceinline__ Work work_item(const Params& a, int wi) {
  const int item = wi % a.n_items;
  const int bh = wi / a.n_items;
  Work w;
  w.qb = item / a.tiles;
  w.t = item % a.tiles;
  w.h = bh % a.H;
  w.b = bh / a.H;
  w.nb = a.nnz[w.qb];
  w.n_tiles = w.nb * a.tiles;
  return w;
}

__global__ void __launch_bounds__(kThreads, 1)
    sparse_attention_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kTileBytes;                      // + s * kTileBytes
  const uint32_t v_s = q_s + (1 + kStages) * kTileBytes;
  const uint32_t bars = q_s + (1 + 2 * kStages) * kTileBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };
  const uint32_t item_s = bars + kBarBytes;
  volatile int* item_gen = reinterpret_cast<volatile int*>(
      smem + (item_s - smem_u32(smem)));
  const int n_work = a.n_items * a.B * a.H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Both roles walk the same work items and count key tiles across them
  // (`it`), which gives each tile's stage and barrier phase.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0;; ++n) {
        // the next item, and its Q, once both consumers' last Q.K^T of
        // this one has landed; past the last item, q_full completes with
        // no bytes and the consumers stop
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        const int wi = atomicAdd(a.counter, 1);
        *item_gen = wi;
        if (wi >= n_work) {
          mbar_arrive(q_full);
          break;
        }
        const Work w = work_item(a, wi);
        mbar_arrive_expect_tx(q_full, kTileBytes);
        tma_load_bf16_tile(q_s, &tq, q_full, w.h, w.qb * a.blk + w.t * kBM,
                           w.b);
        const int* kb = a.kidx + w.qb * a.max_nnz;
        for (int j = 0; j < w.nb; ++j) {
          const int row0 = kb[j] * a.blk;
          for (int t = 0; t < a.tiles; ++t, ++it) {
            const int s = it % kStages;
            if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
            mbar_arrive_expect_tx(k_full(s), kTileBytes);
            tma_load_bf16_tile(k_s + s * kTileBytes, &tk, k_full(s), w.h,
                               row0 + t * kBN, w.b);
            mbar_arrive_expect_tx(v_full(s), kTileBytes);
            tma_load_bf16_tile(v_s + s * kTileBytes, &tv, v_full(s), w.h,
                               row0 + t * kBN, w.b);
          }
        }
      }
    }
  } else {
    // consumer c: rows 64c .. 64c + 63 of each item
    regs_alloc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int quad = lane & 3;
    const uint32_t q_c = q_s + c * (kHalfBytes / 2);   // its rows, in each half

    // S = Q K^T over D in 8 steps of 16 (4 per 64-column half), issued
    auto issue_qk = [&](float (&sc)[64], int stage) {
      const uint32_t ks = k_s + stage * kTileBytes;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t off = (k >> 2) * kHalfBytes + (k & 3) * 32;
        wgmma_m64n128k16_ss(sc, sw128_desc(q_c + off, 16, 1024),
                            sw128_desc(ks + off, 16, 1024), k);
      }
      wgmma_commit();
    };
    // O += P V over a tile's keys in 8 steps of 16, issued; V is [keys, D]
    // with D contiguous: MN-major, the two D halves 16 KB apart
    auto issue_pv = [&](float (&o)[64], uint32_t (&p)[8][4], int stage) {
      const uint32_t vs = v_s + stage * kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs_tb(o, p[kk],
                               sw128_desc(vs + kk * 16 * 128, kHalfBytes, 1024));
      wgmma_commit();
    };

    // keys of a block's last tile: the rest belong to the next block
    const int edge_keys = a.blk - (a.tiles - 1) * kBN;
    float o[64], sc[64];
    uint32_t p[8][4];
    float m_a, m_b, l_a, l_b, al_a, al_b, sum_a, sum_b;
    int it = 0;
    for (int n = 0;; ++n) {
      mbar_wait(q_full, n & 1);
      const int wi = *item_gen;
      if (wi >= n_work) break;
      const Work w = work_item(a, wi);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      m_a = m_b = kNeg;

      // Probabilities of key tile t in sc, in place. On a block's last
      // tile, when the block ends inside it, keys past the block's end are
      // the next block's: logit -1e30.
      int tb = 0;   // the tile's index within its key block
      auto tile_probs = [&]() {
        float scale = a.scale_log2;
        if (tb == a.tiles - 1 && edge_keys < kBN) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int key = 8 * (i >> 2) + 2 * quad + (i & 1);
            sc[i] = key < edge_keys ? sc[i] * scale : kNeg;
          }
          scale = 1.f;
        }
        softmax_tile(sc, scale, m_a, m_b, al_a, al_b, sum_a, sum_b);
        tb = tb == a.tiles - 1 ? 0 : tb + 1;
      };

      // Tile 0 alone; then, for each next tile t, Q K_t^T is issued before
      // P_{t-1} V_{t-1} (B1's schedule).
      mbar_wait(k_full(it % kStages), (it / kStages) & 1);
      wgmma_fence();
      issue_qk(sc, it % kStages);
      wgmma_wait<0>();
      fence_regs(sc);
      if (w.n_tiles == 1) mbar_arrive(q_empty);
      tile_probs();
      l_a = sum_a;
      l_b = sum_b;
      probs_to_a(sc, p);
      for (int t = 1; t < w.n_tiles; ++t) {
        const int cur = it + t, prev = cur - 1;
        mbar_wait(k_full(cur % kStages), (cur / kStages) & 1);
        mbar_wait(v_full(prev % kStages), (prev / kStages) & 1);
        wgmma_fence();
        issue_qk(sc, cur % kStages);
        issue_pv(o, p, prev % kStages);
        wgmma_wait<1>();
        fence_regs(sc);
        if (t == w.n_tiles - 1) mbar_arrive(q_empty);
        tile_probs();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        fence_regs(sc);
        mbar_arrive(empty(prev % kStages));
        // a factor of exactly 1 for every row of the warp (no new maximum)
        // leaves the accumulator as it is
        if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f))
          rescale_rows(o, al_a, al_b);
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
        probs_to_a(sc, p);
      }
      const int last = it + w.n_tiles - 1;
      mbar_wait(v_full(last % kStages), (last / kStages) & 1);
      wgmma_fence();
      issue_pv(o, p, last % kStages);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(last % kStages));
      it += w.n_tiles;

      // acc / sum as bf16, straight from registers to [B, L, H, D]: rows
      // at or past the query block's end are not written
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      const int r_a = w.t * kBM + 64 * c + warp * 16 + (lane >> 2);
      const int r_b = r_a + 8;
      const size_t stride = (size_t)a.H * kD;
      bf16* base = a.o + ((size_t)w.b * a.L + (size_t)w.qb * a.blk) * stride +
                   w.h * kD + 2 * quad;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (r_a < a.blk)
          *reinterpret_cast<uint32_t*>(base + r_a * stride + 8 * j) =
              pack_bf16(o[4 * j] / l_a, o[4 * j + 1] / l_a);
        if (r_b < a.blk)
          *reinterpret_cast<uint32_t*>(base + r_b * stride + 8 * j) =
              pack_bf16(o[4 * j + 2] / l_b, o[4 * j + 3] / l_b);
      }
    }
  }
}

}  // namespace

extern "C" {

// B5. Returns a cudaError_t (0 on a clean launch). `counter` is one int32
// of scratch on the device; it is zeroed here, on `stream`, before the
// launch, so no call depends on what an earlier one left there.
int flexam_sparse_attention(const void* q, const void* k, const void* v, void* o,
                            const void* kidx, const void* nnz, void* counter,
                            int B, int H, int nq, int blk, int max_nnz, int D,
                            float scale_log2, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || nq <= 0 || blk <= 0 || max_nnz <= 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(o) % 16) return (int)cudaErrorInvalidValue;
  const int L = nq * blk;
  CUtensorMap tq, tk, tv;
  if (!make_bl_hd_map(&tq, q, B, L, H, kBoxRows) ||
      !make_bl_hd_map(&tk, k, B, L, H, kBoxRows) ||
      !make_bl_hd_map(&tv, v, B, L, H, kBoxRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int tiles = (blk + kBM - 1) / kBM;
  const Params a{static_cast<const int*>(kidx), static_cast<const int*>(nnz),
                 static_cast<int*>(counter), static_cast<bf16*>(o), B, H,
                 L, blk, max_nnz, tiles, nq * tiles, scale_log2};
  const long long n_work = (long long)nq * tiles * H * B;
  const int grid = (int)(n_work < sms ? n_work : sms);
  if ((err = cudaMemsetAsync(counter, 0, sizeof(int),
                             static_cast<cudaStream_t>(stream))) != cudaSuccess)
    return (int)err;
  sparse_attention_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
