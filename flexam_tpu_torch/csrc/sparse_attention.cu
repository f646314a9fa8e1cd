// Block-sparse attention for video self-attention: kernel B5 of the port.
//
// Replaces flexam_tpu/ops/sparse_attention.py:_sparse_kernel. The token
// stream is cut into blocks of `blk` tokens (a frame, or `group` merged
// frames, of the DiT's video tokens, and the ref block); query block i
// attends to the key blocks kidx[i, :nnz[i]] only (the policy of
// ops/sparse_attention.py:video_sparse_policy), with exact softmax over
// those keys.
//
// Math, as in the TPU kernel and B1: logits in fp32 from q.k with log2(e)
// folded into the scale; online softmax in fp32 with exp2 over the active
// blocks in list order; probabilities cast to the input's dtype for P.V;
// the output is acc / sum in the input's dtype.
//
// Dtypes: bf16 (bf16 wgmma) and fp32, on TF32 wgmma as B1's fp32 instances
// (flash_attention.cu): the pre-pass (tf32_prep.cuh) rounds q and k to
// tf32 and writes V^T rounded, into workspaces the wrapper allocates, and
// the probabilities are rounded in registers.
//
// Layout: q, k, v, o [B, L, H, D], contiguous, D any multiple of 128,
// L = nq * blk;
// kidx [nq, max_nnz] and nnz [nq] int32 on the device, and one int32 of
// scratch on the device for the work counter, which the entry point zeroes
// on the stream before the launch.
//
// What bounds it on an H100: at 23,296 tokens with the w=2 policy (26
// blocks of 896, 147 active pairs) the work is 4*B*H*pairs*blk^2*D =
// 2.9e12 flops against about 0.6 GB of q/k/v/o (1.1 GB in fp32): the
// tensor cores bound it (2.9 ms at 989 TFLOP/s bf16, 5.9 ms at 495 TF32).
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
//    block kidx[qb, j] its ceil(blk / kBN) key tiles, from row kidx * blk,
//    into B1's K/V ring; the two consumer warpgroups run B1's wgmma
//    pipeline (Q K_t^T issued before P_{t-1} V_{t-1}), and skip the
//    accumulator's rescale when no row of a warp has a new maximum.
//  * in bf16 D = 128 and 256 are instances of this design with B1's tiles
//    (at 256: 64-key tiles, so a listed block is ceil(blk / 64) of them, in
//    a ring of 2 stages), in fp32 D = 128 (B1's F32Plan: 64-key K and V^T
//    tiles); every other D runs hopper_wide.cuh's.
//  * `blk` is a multiple of 8 only: a key block's last tile may hold the
//    next block's keys (TMA loads them: they lie inside L), which get the
//    logit -1e30; the rows of an item past its block's end belong to the
//    next block and are computed but not stored. At 512x896 (blk 896 =
//    7 x 128) no edge falls inside a tile. In fp32 a key tile's V^T is
//    read from key kidx * blk + a multiple of 64 of the V^T workspace, a
//    multiple of 8, so each 8 keys keep the pre-pass's order; its padding
//    to 64 keys lies at the sequence's end only (a tile past it reads TMA's
//    zero fill).

#include "hopper_attention.cuh"
#include "hopper_wide.cuh"
#include "tf32_prep.cuh"

namespace {

using flexam::bf16;
using namespace flexam::hopper;

constexpr int kBM = 128;                // query rows an item (2 x 64)
constexpr int kThreads = 3 * 128;       // producer + 2 consumer warpgroups
constexpr int kBoxRows = 64;            // TMA box: 64 rows x 128 bytes

// The bytes a CTA on plan S takes: B1's tiles and barriers, + the current
// work item, handed from the producer to the consumers
template <typename S>
constexpr size_t smem_bytes() {
  return S::kSmemBytes + 16;
}

struct Params {
  const int* kidx;   // [nq, max_nnz]
  const int* nnz;    // [nq]
  int* counter;      // the next work item to hand out
  void* o;           // [B, L, H, D], bf16 or fp32
  int B, H, L, blk, max_nnz;
  int q_tiles, k_tiles, n_items;  // 128-row / key tiles a block; nq * q_tiles
  float scale_log2;  // softmax scale * log2(e)
};

// Work item `wi`: row tile `t` of query block `qb` for head h, batch b,
// with nnz[qb] key blocks of `k_tiles` key tiles each (n_items = nq *
// q_tiles items a (batch, head)).
struct Work {
  int qb, t, h, b, nb, n_tiles;
};

__device__ __forceinline__ Work work_item(const Params& a, int wi) {
  const int item = wi % a.n_items;
  const int bh = wi / a.n_items;
  Work w;
  w.qb = item / a.q_tiles;
  w.t = item % a.q_tiles;
  w.h = bh % a.H;
  w.b = bh / a.H;
  w.nb = a.nnz[w.qb];
  w.n_tiles = w.nb * a.k_tiles;
  return w;
}

// B5 on the plan S (Bf16Plan<kD>, or F32Plan on the pre-pass's rounded q,
// k and its V^T workspace, which tv maps).
template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_attention_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params a) {
  constexpr int kD = S::kD;
  constexpr int kBN = S::kBN, kStages = S::kStages, kSpans = S::kSpans;
  constexpr uint32_t kKVBytes = S::kKVBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;                      // + s * kKVBytes
  const uint32_t v_s = k_s + kStages * kKVBytes;
  const uint32_t bars = v_s + kStages * kKVBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };
  const uint32_t item_s = bars + S::kBarBytes;
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
        mbar_arrive_expect_tx(q_full, S::kQBytes);
        tma_load_span_tile<kSpans, kBM, S::kCols>(
            q_s, &tq, q_full, w.h, w.qb * a.blk + w.t * kBM, w.b);
        const int* kb = a.kidx + w.qb * a.max_nnz;
        for (int j = 0; j < w.nb; ++j) {
          const int row0 = kb[j] * a.blk;
          for (int t = 0; t < a.k_tiles; ++t, ++it) {
            const int s = it % kStages;
            if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
            mbar_arrive_expect_tx(k_full(s), kKVBytes);
            tma_load_span_tile<kSpans, kBN, S::kCols>(
                k_s + s * kKVBytes, &tk, k_full(s), w.h, row0 + t * kBN, w.b);
            mbar_arrive_expect_tx(v_full(s), kKVBytes);
            if constexpr (S::kF32)
              // V^T [B, D, H, Lkp]: the tile's keys as columns from key
              // row0 + t * kBN (a multiple of 8, so the pre-pass's order
              // of each 8 keys holds), all kD rows
              tma_load_span_tile<kBN / 32, kD, 32>(v_s + s * kKVBytes, &tv,
                                                   v_full(s), w.h, 0, w.b,
                                                   row0 + t * kBN);
            else
              tma_load_span_tile<kSpans, kBN, 64>(v_s + s * kKVBytes, &tv,
                                                  v_full(s), w.h,
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
    const uint32_t q_c = q_s + c * 64 * 128;   // its rows, in each span

    // S = Q K^T over D in steps of 32 bytes (4 per 128-byte span), issued
    auto issue_qk = [&](float (&sc)[kBN / 2], int stage) {
      const uint32_t ks = k_s + stage * kKVBytes;
#pragma unroll
      for (int k = 0; k < S::kQKSteps; ++k) {
        const uint32_t col = (k & 3) * 32;
        const uint64_t da =
            sw128_desc(q_c + (k >> 2) * S::kQSpanBytes + col, 16, 1024);
        const uint64_t db =
            sw128_desc(ks + (k >> 2) * S::kKVSpanBytes + col, 16, 1024);
        if constexpr (S::kF32)
          wgmma_m64n64k8_tf32_ss(sc, da, db, k);
        else
          wgmma_qk(sc, da, db, k);
      }
      wgmma_commit();
    };
    // O += P V over a tile's keys in steps of kPVKeys, issued. bf16: a
    // wgmma for every 128 columns of D; V is [keys, D] with D contiguous,
    // MN-major, the 64-column spans kKVSpanBytes apart. fp32: V^T is
    // [D, keys] with keys contiguous, K-major, the 32-key spans
    // kVtSpanBytes apart.
    auto issue_pv = [&](float (&o)[kD / 128][64],
                        uint32_t (&p)[kBN / S::kPVKeys][4], int stage) {
      const uint32_t vs = v_s + stage * kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / S::kPVKeys; ++kk) {
        if constexpr (S::kF32) {
          wgmma_m64n128k8_tf32_rs(
              o[0], p[kk],
              sw128_desc(vs + (kk >> 2) * S::kVtSpanBytes + (kk & 3) * 32, 16,
                         1024));
        } else {
#pragma unroll
          for (int h = 0; h < kD / 128; ++h)
            wgmma_m64n128k16_rs_tb(
                o[h], p[kk],
                sw128_desc(vs + 2 * h * S::kKVSpanBytes + kk * 16 * 128,
                           S::kKVSpanBytes, 1024));
        }
      }
      wgmma_commit();
    };
    // the probabilities as P.V's A fragments (bf16, or tf32 rounded)
    auto to_a = [&](const float (&sc)[kBN / 2],
                    uint32_t (&p)[kBN / S::kPVKeys][4]) {
      if constexpr (S::kF32)
        probs_to_a_tf32(sc, p);
      else
        probs_to_a(sc, p);
    };

    // keys of a block's last tile: the rest belong to the next block
    const int edge_keys = a.blk - (a.k_tiles - 1) * kBN;
    float o[kD / 128][64], sc[kBN / 2];
    uint32_t p[kBN / S::kPVKeys][4];
    float m_a, m_b, l_a, l_b, al_a, al_b, sum_a, sum_b;
    int it = 0;
    for (int n = 0;; ++n) {
      mbar_wait(q_full, n & 1);
      const int wi = *item_gen;
      if (wi >= n_work) break;
      const Work w = work_item(a, wi);
#pragma unroll
      for (int h = 0; h < kD / 128; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
      m_a = m_b = kNeg;

      // Probabilities of key tile t in sc, in place. On a block's last
      // tile, when the block ends inside it, keys past the block's end are
      // the next block's: logit -1e30.
      int tb = 0;   // the tile's index within its key block
      auto tile_probs = [&]() {
        float scale = a.scale_log2;
        if (tb == a.k_tiles - 1 && edge_keys < kBN) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int key = 8 * (i >> 2) + 2 * quad + (i & 1);
            sc[i] = key < edge_keys ? sc[i] * scale : kNeg;
          }
          scale = 1.f;
        }
        softmax_tile(sc, scale, m_a, m_b, al_a, al_b, sum_a, sum_b);
        tb = tb == a.k_tiles - 1 ? 0 : tb + 1;
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
      to_a(sc, p);
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
#pragma unroll
        for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
        fence_regs(p);
        fence_regs(sc);
        mbar_arrive(empty(prev % kStages));
        // a factor of exactly 1 for every row of the warp (no new maximum)
        // leaves the accumulator as it is
        if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
          for (int h = 0; h < kD / 128; ++h) rescale_rows(o[h], al_a, al_b);
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
        to_a(sc, p);
      }
      const int last = it + w.n_tiles - 1;
      mbar_wait(v_full(last % kStages), (last / kStages) & 1);
      wgmma_fence();
      issue_pv(o, p, last % kStages);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
      mbar_arrive(empty(last % kStages));
      it += w.n_tiles;

      // acc / sum in the output's dtype, straight from registers to
      // [B, L, H, D]: a quad writes 16 (bf16) or 32 (fp32) contiguous bytes
      // of a row; rows at or past the query block's end are not written
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      const int r_a = w.t * kBM + 64 * c + warp * 16 + (lane >> 2);
      const int r_b = r_a + 8;
      const size_t stride = (size_t)a.H * kD;
      const size_t off = ((size_t)w.b * a.L + (size_t)w.qb * a.blk) * stride +
                         w.h * kD + 2 * quad;
#pragma unroll
      for (int h = 0; h < kD / 128; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const size_t col = off + 128 * h + 8 * j;
          if constexpr (S::kF32) {
            float* base = static_cast<float*>(a.o) + col;
            if (r_a < a.blk)
              *reinterpret_cast<float2*>(base + r_a * stride) =
                  make_float2(o[h][4 * j] / l_a, o[h][4 * j + 1] / l_a);
            if (r_b < a.blk)
              *reinterpret_cast<float2*>(base + r_b * stride) =
                  make_float2(o[h][4 * j + 2] / l_b, o[h][4 * j + 3] / l_b);
          } else {
            bf16* base = static_cast<bf16*>(a.o) + col;
            if (r_a < a.blk)
              *reinterpret_cast<uint32_t*>(base + r_a * stride) =
                  pack_bf16(o[h][4 * j] / l_a, o[h][4 * j + 1] / l_a);
            if (r_b < a.blk)
              *reinterpret_cast<uint32_t*>(base + r_b * stride) =
                  pack_bf16(o[h][4 * j + 2] / l_b, o[h][4 * j + 3] / l_b);
          }
        }
    }
  }
}

// B5 at the head dims the plans above do not take (hopper_wide.cuh): bf16
// from 384 on, fp32 from 256 on.
template <bool kF32>
__global__ void __launch_bounds__(wide::kThreads, 1)
    sparse_attention_wide_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const wide::Params a) {
  wide::wide_cta<wide::kSparse, 0, kF32>(&tq, &tk, &tv, a);
}

// Launch B5 on plan S over q, k, v (bf16), or over the pre-pass's rounded
// q, k and the V^T workspace with Lkp keys (F32Plan).
template <typename S>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* kidx, const void* nnz, void* counter, int B, int H,
           int nq, int blk, int max_nnz, float scale_log2, void* stream,
           int Lkp = 0) {
  constexpr int kD = S::kD;
  constexpr size_t kSmem = smem_bytes<S>();
  const int L = nq * blk;
  CUtensorMap tq, tk, tv;
  const bool ok =
      S::kF32 ? make_bl_hd_map_f32(&tq, q, B, L, H, kD, kBoxRows) &&
                    make_bl_hd_map_f32(&tk, k, B, L, H, kD, kBoxRows) &&
                    make_bl_hd_map_f32(&tv, v, B, kD, H, Lkp, kBoxRows)
              : make_bl_hd_map(&tq, q, B, L, H, kD, kBoxRows) &&
                    make_bl_hd_map(&tk, k, B, L, H, kD, kBoxRows) &&
                    make_bl_hd_map(&tv, v, B, L, H, kD, kBoxRows);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_attention_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int q_tiles = (blk + kBM - 1) / kBM;
  const int k_tiles = (blk + S::kBN - 1) / S::kBN;
  const Params a{static_cast<const int*>(kidx), static_cast<const int*>(nnz),
                 static_cast<int*>(counter), o, B, H, L, blk, max_nnz,
                 q_tiles, k_tiles, nq * q_tiles, scale_log2};
  const long long n_work = (long long)nq * q_tiles * H * B;
  const int grid = (int)(n_work < sms ? n_work : sms);
  if ((err = cudaMemsetAsync(counter, 0, sizeof(int),
                             static_cast<cudaStream_t>(stream))) != cudaSuccess)
    return (int)err;
  sparse_attention_kernel<S><<<grid, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                                    a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int nq, int blk, int max_nnz, int D,
               const void* o) {
  return D <= 0 || D % 128 || B <= 0 || H <= 0 || nq <= 0 || blk <= 0 ||
         max_nnz <= 0 || reinterpret_cast<uintptr_t>(o) % 16;
}

wide::Params wide_params(const void* kidx, const void* nnz, void* o, int B,
                         int H, int nq, int blk, int max_nnz, int D,
                         float scale_log2) {
  wide::Params a{};
  a.kidx = static_cast<const int*>(kidx);
  a.nnz = static_cast<const int*>(nnz);
  a.o = o;
  a.B = B;
  a.H = H;
  a.D = D;
  a.Lq = a.Lk = nq * blk;
  a.blk = blk;
  a.max_nnz = max_nnz;
  a.q_tiles = (blk + wide::kRows - 1) / wide::kRows;
  a.k_tiles = (blk + wide::kKeys - 1) / wide::kKeys;
  a.scale_log2 = scale_log2;
  return a;
}

}  // namespace

extern "C" {

// B5 in bf16. Returns a cudaError_t (0 on a clean launch);
// cudaErrorInvalidValue for a D that is not a positive multiple of 128.
// `counter` is one int32 of scratch on the device; it is zeroed here, on
// `stream`, before the launch, so no call depends on what an earlier one
// left there (the kernel for D >= 384 takes its items from the grid and
// does not use it).
int flexam_sparse_attention(const void* q, const void* k, const void* v, void* o,
                            const void* kidx, const void* nnz, void* counter,
                            int B, int H, int nq, int blk, int max_nnz, int D,
                            float scale_log2, void* stream) {
  if (bad_shape(B, H, nq, blk, max_nnz, D, o))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch<Bf16Plan<128>>(q, k, v, o, kidx, nnz, counter, B, H, nq,
                                 blk, max_nnz, scale_log2, stream);
  if (D == 256)
    return launch<Bf16Plan<256>>(q, k, v, o, kidx, nnz, counter, B, H, nq,
                                 blk, max_nnz, scale_log2, stream);
  return wide::launch<wide::kSparse>(
      sparse_attention_wide_kernel<false>, q, k, v,
      wide_params(kidx, nnz, o, B, H, nq, blk, max_nnz, D, scale_log2),
      stream);
}

// B5 in fp32 (TF32 wgmma): the pre-pass (tf32_prep.cuh) into qw, kw
// (workspaces shaped as q and k) and vt (B * D * H * Lkp floats, Lkp =
// nq * blk rounded up to 64), all 16-byte aligned, then F32Plan at D = 128
// or the wide design's fp32 mode above it; `counter` as in bf16. Returns a
// cudaError_t.
int flexam_sparse_attention_f32(const void* q, const void* k, const void* v,
                                void* qw, void* kw, void* vt, void* o,
                                const void* kidx, const void* nnz,
                                void* counter, int B, int H, int nq, int blk,
                                int max_nnz, int D, float scale_log2,
                                void* stream) {
  if (bad_shape(B, H, nq, blk, max_nnz, D, o) || (long long)B * H > 65535 ||
      misaligned16(q, k, v, qw, kw, vt))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = nq * blk, Lkp = padded_keys(L);
  round_tf32_async(q, qw, (long long)B * L * H * D, st);
  round_tf32_async(k, kw, (long long)B * L * H * D, st);
  transpose_v_async(v, vt, B, H, L, D, Lkp, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (D == 128)
    return launch<F32Plan>(qw, kw, vt, o, kidx, nnz, counter, B, H, nq, blk,
                           max_nnz, scale_log2, stream, Lkp);
  return wide::launch<wide::kSparse, true>(
      sparse_attention_wide_kernel<true>, qw, kw, vt,
      wide_params(kidx, nnz, o, B, H, nq, blk, max_nnz, D, scale_log2),
      stream, Lkp);
}

}  // extern "C"
