// Hopper (sm_90a) building blocks for the port's attention kernels: TMA
// tensor maps and loads, mbarriers, wgmma (bf16, tf32 and s8), register
// reallocation, and the online softmax on wgmma accumulator fragments.
// Used by B1/B2 (flash_attention.cu), B5 (sparse_attention.cu) and B6
// (int8_attention.cu), in bf16 and fp32. Outputs leave by plain stores
// from registers: a persistent CTA frees its Q buffer for the next item's
// load instead of staging the output there (B1 at head dim 128 and B2 at
// 128 and 256 and in fp32 stage O in room of their own for TMA stores,
// tma_store_4d).
//
// Tiles in shared memory use the 128-byte swizzle: a [rows, D] bf16 tile
// is D / 64 column spans of [rows, 64] (128 bytes a row), one after
// another, each 1024-byte aligned; a [rows, D] fp32 tile is D / 32 such
// spans and a [rows, D] int8 tile D / 128 (128 bytes a row). Inside a span, the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8). TMA writes that layout (CU_TENSOR_MAP_SWIZZLE_128B)
// and wgmma reads it through descriptors with layout type 1.
//
// Fragments: a warpgroup (4 warps, 128 threads) owns 64 rows. In a wgmma
// m64nN f32 accumulator d[N / 2], register i of lane l in warp w holds row
// 16w + l/4 (+8 when i % 4 >= 2) and column 8(i/4) + 2(l%4) + (i%2), the
// mma.sync C layout repeated over N/8 column blocks.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "attention_tiles.cuh"
#include "common.cuh"

namespace flexam {
namespace hopper {

// the masked-key logit, bf16 packing and quad reductions of
// attention_tiles.cuh (a wgmma fragment's rows sit in quads as an mma.sync
// fragment's do)
using attn::kNeg;
using attn::pack_bf16;
using attn::quad_max;
using attn::quad_sum;

// The tile plans of B1, B2 and B5 (flash_attention.cu, sparse_attention.cu:
// one CTA of 128 query rows, a ring of K and V tiles).
//
// bf16 at head dim kD (128 or 256): kBN keys a K/V tile in a ring of
// kStages (at 256 a 128-key tile is 64 KB, which leaves no room for two
// stages beside Q: 64 keys and 2 stages), each tile kD / 64 spans of 64
// columns (128-byte rows); Q K^T in kD / 16 wgmma steps of 16 (32 bytes),
// P.V in steps of 16 keys. K and V of a stage share one empty barrier.
// B5 and B6 run it at 128 and 256 (B1 and B2 run SplitPlan below).
template <int kD_>
struct Bf16Plan {
  static constexpr bool kF32 = false;
  static constexpr bool kSplitRing = false;
  static constexpr bool kRoundQ = false;
  static constexpr bool kStageO = false;
  static constexpr uint32_t kOStageBytes = 0;
  static constexpr int kD = kD_;
  static constexpr int kBN = kD == 128 ? 128 : 64;
  static constexpr int kStages = kD == 128 ? 3 : 2;
  static constexpr int kSpans = kD / 64;
  static constexpr int kCols = 64;                 // columns a span
  static constexpr int kKVBox = 64;                // TMA box rows of K, V
  static constexpr uint32_t kQSpanBytes = 128 * 128;              // 16 KB
  static constexpr uint32_t kKVSpanBytes = kBN * 128;
  static constexpr uint32_t kQBytes = kSpans * kQSpanBytes;
  static constexpr uint32_t kKVBytes = kSpans * kKVSpanBytes;
  static constexpr uint32_t kBarBytes = 8 * (2 + 3 * kStages);
  // Q, the K and V rings and their barriers, 1024-byte aligned
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static constexpr int kQKSteps = kD / 16;
  static constexpr int kPVKeys = 16;               // keys a P.V step
};

// Room for O staged for TMA stores (kStageO): 16 KB a consumer, two
// [64 rows, 128 bytes] spans, which a round of the epilogue fills and two
// TMA stores empty (128 bf16 or 64 fp32 columns a round).
constexpr uint32_t kOStageRoom = 2 * 2 * 64 * 128;

// B1 and B2 in bf16 with K and V in rings of their own (kSplitRing): kBN
// keys a K/V tile, each ring kStages stages with its own empty barriers, so
// a K slot frees as soon as its Q K^T has landed and a V slot once its P.V
// has. A K/V span is one TMA box of kBN rows (kKVBox). S over kBN keys is
// an m64n(kBN) fragment. kStageO: O leaves through kOStageRoom of shared
// memory by TMA stores. Instances (flash_attention.cu):
//  * B1 at 256, SplitPlan<256, 80, 2>: Q 64 KB + 2 x (K + V of 40 KB),
//    224 KB; O 128 + S 40 + P 20 registers;
//  * B2 at 256, SplitPlan<256, 64, 2, true>: 192 KB and 32 KB of O;
//  * B1 and B2 at 128, SplitPlan<128, 128, 2, true>: Q 32 KB, 2 stages of
//    128-key tiles (K + V 64 KB a stage) and 32 KB of O, 192 KB.
template <int kD_, int kBN_, int kStages_, bool kStageO_ = false>
struct SplitPlan {
  static constexpr bool kF32 = false;
  static constexpr bool kSplitRing = true;
  static constexpr bool kRoundQ = false;
  static constexpr bool kStageO = kStageO_;
  static constexpr uint32_t kOStageBytes = kStageO ? kOStageRoom : 0;
  static constexpr int kD = kD_;
  static constexpr int kBN = kBN_;
  static constexpr int kStages = kStages_;
  static constexpr int kSpans = kD / 64;
  static constexpr int kCols = 64;
  static constexpr int kKVBox = kBN;               // TMA box rows of K and V
  static constexpr uint32_t kQSpanBytes = 128 * 128;
  static constexpr uint32_t kKVSpanBytes = kBN * 128;
  static constexpr uint32_t kQBytes = kSpans * kQSpanBytes;
  static constexpr uint32_t kKVBytes = kSpans * kKVSpanBytes;
  // q_full, q_empty; k_full, v_full, v_empty, k_empty a stage
  static constexpr uint32_t kBarBytes = 8 * (2 + 4 * kStages);
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kOStageBytes + kBarBytes;
  static constexpr int kQKSteps = kD / 16;
  static constexpr int kPVKeys = 16;
  static_assert(kBN % 16 == 0 && kKVSpanBytes % 1024 == 0 && kBN <= 256,
                "whole P.V steps; 1024-byte aligned spans; one TMA box");
  static_assert(kSmemBytes <= 232448, "one CTA an SM");
};

// B1 and B2 at head dim 256: 2 stages of kBN-key tiles
template <int kBN, bool kStageO = false>
using D256Plan = SplitPlan<256, kBN, 2, kStageO>;

// fp32 at D = 128 (TF32): the same bytes as bf16 at 256 (a 128-byte span
// holds 32 fp32). Q [128, 128] as four 32-column spans (64 KB), K tiles
// [64 keys, 128] (four spans, 32 KB) and V^T tiles [128 columns, 64 keys]
// (two 32-key spans of 16 KB, read from the pre-pass's V^T workspace,
// tf32_prep.cuh) in a ring of 2 stages. S over 64 keys is 16 steps of
// wgmma m64n64k8 (32 bytes of D a step, as bf16's k16); P.V 8 steps of
// m64n128k8 with P from registers (probs_to_a_tf32). A consumer holds O
// (64), S (32) and P (32) registers. B1 and B5 run it.
struct F32Plan {
  static constexpr bool kF32 = true;
  static constexpr bool kSplitRing = false;
  static constexpr bool kRoundQ = false;
  static constexpr bool kStageO = false;
  static constexpr uint32_t kOStageBytes = 0;
  static constexpr int kD = 128;
  static constexpr int kBN = 64;
  static constexpr int kStages = 2;
  static constexpr int kSpans = 4;
  static constexpr int kCols = 32;
  static constexpr int kKVBox = 64;                // TMA box rows of K, V^T
  static constexpr uint32_t kQSpanBytes = 128 * 128;
  static constexpr uint32_t kKVSpanBytes = kBN * 128;   // K: [64, 32]
  static constexpr uint32_t kVtSpanBytes = kD * 128;    // V^T: [128, 32]
  static constexpr uint32_t kQBytes = kSpans * kQSpanBytes;
  static constexpr uint32_t kKVBytes = kSpans * kKVSpanBytes;  // = V^T tile
  static constexpr uint32_t kBarBytes = 8 * (2 + 3 * kStages);
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static constexpr int kQKSteps = kD * 4 / 32;
  static constexpr int kPVKeys = 8;
};
static_assert(F32Plan::kKVBytes == (F32Plan::kBN / 32) * F32Plan::kVtSpanBytes,
              "a V^T tile fills a K tile's stage");

// B2 in fp32 at D = 128: F32Plan's tiles with K and V^T in rings of their
// own (kSplitRing, as SplitPlan's), O staged for TMA stores in kOStageRoom
// (a consumer's 32 KB of fp32 O in two rounds of 64 columns), and Q read
// as the caller gave it and rounded to tf32 in shared memory by the
// consumers (kRoundQ: no pre-pass over q, B2's largest operand). 225 KB.
struct F32SplitPlan : F32Plan {
  static constexpr bool kSplitRing = true;
  static constexpr bool kRoundQ = true;
  static constexpr bool kStageO = true;
  static constexpr uint32_t kOStageBytes = kOStageRoom;
  static constexpr uint32_t kBarBytes = 8 * (2 + 4 * kStages);
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + kOStageBytes + kBarBytes;
  static_assert(kSmemBytes <= 232448, "one CTA an SM");
};

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime so
// the library needs no -lcuda. Null where it is missing.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 4-D map over a [B, L, H, D] tensor of `type` (elements of `bytes`
// bytes), dims innermost first (D, H, L, B), with boxes of (one
// 128-byte-swizzle span of 128 / bytes columns, 1 head, box_rows rows,
// 1 batch). Rows past L (or before 0) read as zeros and are not written:
// the ragged edge of L stays inside its batch. Returns false if the map is
// refused (e.g. a pointer not 16-byte aligned).
inline bool make_span_map(CUtensorMap* map, CUtensorMapDataType type,
                          int bytes, const void* base, int B, int L, int H,
                          int D, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t row = (cuuint64_t)D * bytes;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {row, row * H, row * H * L};   // bytes, dims 1..3
  cuuint32_t box[4] = {(cuuint32_t)(128 / bytes), 1, (cuuint32_t)box_rows, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides,
                      box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// bf16 [B, L, H, D]: boxes of 64 columns.
inline bool make_bl_hd_map(CUtensorMap* map, const void* base, int B, int L,
                           int H, int D, int box_rows) {
  return make_span_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, B, L,
                       H, D, box_rows);
}

// fp32 [B, L, H, D]: boxes of 32 columns. The Vt workspace of the fp32
// kernels, [B, D, H, Lkp], is mapped as this with L = D and D = Lkp: its
// boxes are 32 keys of box_rows head-dim rows.
inline bool make_bl_hd_map_f32(CUtensorMap* map, const void* base, int B,
                               int L, int H, int D, int box_rows) {
  return make_span_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, B, L,
                       H, D, box_rows);
}

// int8 [B, L, H, D]: boxes of 128 columns. The bytes are copied as they
// are (UINT8 is the map type TMA has for one-byte elements).
inline bool make_bl_hd_map_i8(CUtensorMap* map, const void* base, int B,
                              int L, int H, int D, int box_rows) {
  return make_span_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, B, L, H,
                       D, box_rows);
}

// ---------------------------------------------------------------------------
// Device: shared-memory addresses, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// Make barrier inits visible to the other threads and to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and announce `bytes` of TMA traffic that will complete the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D map into shared memory; completes bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows row0 .. row0 + kRows - 1 of head h, batch b of a [B, L, H, D] map
// with kBox-row boxes into a swizzled tile at dst: kSpans spans of kCols
// columns (128 bytes: 64 bf16 or 32 fp32) from column col0 on, each
// [kRows, kCols] (kRows * 128 bytes) and made of kRows / kBox boxes.
template <int kSpans, int kRows, int kCols = 64, int kBox = 64>
__device__ __forceinline__ void tma_load_span_tile(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int h,
                                                   int row0, int b,
                                                   int col0 = 0) {
  static_assert(kRows % kBox == 0, "whole boxes");
#pragma unroll
  for (int span = 0; span < kSpans; ++span)
#pragma unroll
    for (int part = 0; part < kRows / kBox; ++part)
      tma_load_4d(dst + span * kRows * 128 + part * kBox * 128, map, bar,
                  col0 + kCols * span, h, row0 + kBox * part, b);
}

// One box of shared memory at src into a 4-D map at (c0, c1, c2, c3), in
// the bulk group this thread commits next; rows past the map's extent are
// not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's committed bulk stores have read their shared
// memory (kRead) or are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's plain shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15) over `n` threads.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrive at named barrier `id` over `n` threads without waiting.
__device__ __forceinline__ void named_barrier_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Named barrier `id` over `n` threads that also returns, to each of them,
// whether any of them passed a non-zero `pred`.
__device__ __forceinline__ int named_barrier_or(int id, int n, int pred) {
  int any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n"
      " bar.red.or.pred q, %2, %3, p;\n selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(any) : "r"(pred), "r"(id), "r"(n) : "memory");
  return any;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2_f32(uint32_t addr, float x,
                                                 float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y) : "memory");
}

template <int kSpans, int kRows>
__device__ __forceinline__ void tma_load_bf16_tile(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int h,
                                                   int row0, int b,
                                                   int col0 = 0) {
  tma_load_span_tile<kSpans, kRows, 64>(dst, map, bar, h, row0, b, col0);
}

// The same from a [B, L, H, D] int8 map whose boxes are kRows rows: kSpans
// spans of 128 bytes (columns) from byte col0 on, one box each.
template <int kSpans, int kRows>
__device__ __forceinline__ void tma_load_i8_tile(uint32_t dst,
                                                 const CUtensorMap* map,
                                                 uint32_t bar, int h,
                                                 int row0, int b,
                                                 int col0 = 0) {
#pragma unroll
  for (int span = 0; span < kSpans; ++span)
    tma_load_4d(dst + span * kRows * 128, map, bar, col0 + 128 * span, h,
                row0, b);
}

// ---------------------------------------------------------------------------
// Device: register reallocation between warpgroups
// ---------------------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand in shared memory. K-major
// (rows of 128 bytes along K): `lbo` is unused, `sbo` = 1024 (8 rows).
// MN-major: `lbo` = bytes from one 64-element column block to the next
// along M/N, `sbo` = 1024 (8 rows along K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Tell the compiler that d changes here, so no read or write of it moves
// across an asynchronous wgmma's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for the A fragments of a register-A wgmma, which it reads until
// its wait.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The same for an s32 accumulator.
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 64 registers of an accumulator fragment as asm operands with
// constraint c ("+f", "+r" or "=r").
#define FLEXAM_REGS64(c, d)                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),      \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),      \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),    \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),    \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),    \
      c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),    \
      c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),    \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),    \
      c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])

#define FLEXAM_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A B for a 64 x 128 x 16 step, A and B both K-major in shared
// memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLEXAM_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FLEXAM_REGS64("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x 128 x 16 step, A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B MN-major in shared memory
// (transposed: B[k][n] with n contiguous).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLEXAM_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLEXAM_REGS64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A 64 x 128 x 32 step of int8 operands, s32 accumulate (exact): A and B
// both K-major in shared memory, the only layout int8 wgmma takes. One
// step is 32 bytes of K, as bf16's k16, so a descriptor advances as in
// wgmma_m64n128k16_ss. The first step of a product writes d (d = A B,
// "=r": the old d is dead, so its registers are free up to this step);
// the others add to it.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss_first(int (&d)[64],
                                                             uint64_t da,
                                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FLEXAM_D64
      ", %64, %65, p;\n}\n"
      : FLEXAM_REGS64("=r", d)
      : "l"(da), "l"(db), "n"(0));
}

__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FLEXAM_D64
      ", %64, %65, p;\n}\n"
      : FLEXAM_REGS64("+r", d)
      : "l"(da), "l"(db), "n"(1));
}

// The 32 registers of an m64n64 accumulator fragment.
#define FLEXAM_REGS32(c, d)                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),      \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),      \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),    \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),    \
      c(d[29]), c(d[30]), c(d[31])

#define FLEXAM_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"

// d (+)= A B for a 64 x 64 x 16 step, A and B both K-major in shared
// memory (S over a 64-key tile). `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLEXAM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLEXAM_REGS32("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The 40 registers of an m64n80 accumulator fragment.
#define FLEXAM_REGS40(c, d)                                                    \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),      \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),      \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),    \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),    \
      c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),    \
      c(d[36]), c(d[37]), c(d[38]), c(d[39])

#define FLEXAM_D40                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

// d (+)= A B for a 64 x 80 x 16 step, A and B both K-major in shared
// memory (S over an 80-key tile, D256Plan<80>). `accumulate` 0 overwrites
// d.
__device__ __forceinline__ void wgmma_m64n80k16_ss(float (&d)[40], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " FLEXAM_D40
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : FLEXAM_REGS40("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 64 x 8 step of tf32 operands, A and B both
// K-major in shared memory (fp32 S over a 64-key tile). A step is 32 bytes
// of K, as bf16's k16, so a descriptor advances as in wgmma_m64n64k16_ss.
// The tensor core reads the operands' top 19 bits (tf32): the fp32 kernels
// round them to nearest beforehand (round_tf32). `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32],
                                                       uint64_t da,
                                                       uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FLEXAM_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : FLEXAM_REGS32("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for a 64 x 128 x 8 step of tf32 operands, A from registers
// (probs_to_a_tf32's fragment), B K-major in shared memory: tf32 wgmma has
// no transposed operand, so B is V^T (rows of the output's columns, keys
// contiguous).
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64],
                                                        const uint32_t (&a)[4],
                                                        uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FLEXAM_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : FLEXAM_REGS64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// A 64 x 64 x 32 step of int8 operands, s32 accumulate, both K-major in
// shared memory: the first step of a product writes d, the others add.
__device__ __forceinline__ void wgmma_m64n64k32_s8_ss_first(int (&d)[32],
                                                            uint64_t da,
                                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FLEXAM_D32
      ", %32, %33, p;\n}\n"
      : FLEXAM_REGS32("=r", d)
      : "l"(da), "l"(db), "n"(0));
}

__device__ __forceinline__ void wgmma_m64n64k32_s8_ss(int (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " FLEXAM_D32
      ", %32, %33, p;\n}\n"
      : FLEXAM_REGS32("+r", d)
      : "l"(da), "l"(db), "n"(1));
}

// S (+)= Q K^T for one k-step, by the S fragment's width: 128 keys
// (m64n128k16), 80 keys (m64n80k16) or 64 keys (m64n64k16).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  wgmma_m64n128k16_ss(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_qk(float (&d)[40], uint64_t da,
                                         uint64_t db, int accumulate) {
  wgmma_m64n80k16_ss(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  wgmma_m64n64k16_ss(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_qk_s8_first(int (&d)[64], uint64_t da,
                                                  uint64_t db) {
  wgmma_m64n128k32_s8_ss_first(d, da, db);
}
__device__ __forceinline__ void wgmma_qk_s8_first(int (&d)[32], uint64_t da,
                                                  uint64_t db) {
  wgmma_m64n64k32_s8_ss_first(d, da, db);
}
__device__ __forceinline__ void wgmma_qk_s8(int (&d)[64], uint64_t da,
                                            uint64_t db) {
  wgmma_m64n128k32_s8_ss(d, da, db);
}
__device__ __forceinline__ void wgmma_qk_s8(int (&d)[32], uint64_t da,
                                            uint64_t db) {
  wgmma_m64n64k32_s8_ss(d, da, db);
}

#undef FLEXAM_REGS64
#undef FLEXAM_D64
#undef FLEXAM_REGS32
#undef FLEXAM_D32
#undef FLEXAM_REGS40
#undef FLEXAM_D40

// ---------------------------------------------------------------------------
// Device: softmax on a 64 x 128 accumulator fragment
// ---------------------------------------------------------------------------

// 2^x by the SFU alone (results below 2^-126 flush to zero: probabilities
// that small add nothing a bf16 P.V can hold).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax step of a tile of 2N keys (an m64n(2N) fragment
// s[N]), up to the accumulator: s holds this thread's values of rows
// a = l/4 and b = l/4 + 8 of its warp, whose logits are s * `scale_a` /
// s * `scale_b` (or, with scales 1, logits already scaled and masked); the
// scales are positive. Raises the running maxima m_a / m_b, turns s into
// exp2(scale * s - m) in place, and returns the factors al_* that the
// accumulator and the sums must take and this thread's share of the
// tile's row sums. Scaling by a positive factor keeps the max, so the max
// is taken on s and scaled once; the exponent is one FFMA.
template <int N>
__device__ __forceinline__ void softmax_tile_rows(float (&s)[N], float scale_a,
                                                  float scale_b, float& m_a,
                                                  float& m_b, float& al_a,
                                                  float& al_b, float& sum_a,
                                                  float& sum_b) {
  float mx_a = s[0], mx_b = s[2];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(m_a, quad_max(mx_a) * scale_a);
  mx_b = fmaxf(m_b, quad_max(mx_b) * scale_b);
  al_a = ex2(m_a - mx_a);
  al_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  sum_a = sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale_a, -mx_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_a, -mx_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_b, -mx_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_b, -mx_b));
    sum_a += s[4 * j] + s[4 * j + 1];
    sum_b += s[4 * j + 2] + s[4 * j + 3];
  }
}

// The same with one scale for both rows (B1, B2, B5: the softmax scale).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float scale,
                                             float& m_a, float& m_b,
                                             float& al_a, float& al_b,
                                             float& sum_a, float& sum_b) {
  softmax_tile_rows(s, scale, scale, m_a, m_b, al_a, al_b, sum_a, sum_b);
}

// An s32 product as an fp32, exactly, for |s| < 2^22: s + 1.5 * 2^23 as
// an integer is the fp32 bit pattern of 12582912 + s (the exponent stays
// 2^23), and the subtraction is exact. One IADD and one FADD on full-rate
// pipes, not the quarter-rate I2F. B6's products are at most
// 127^2 * D in size: 2,064,512 at D = 128, 4,129,024 at D = 256; wider
// heads convert by I2F.
__device__ __forceinline__ float s32_to_f32_small(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.0f;
}

// Rows a / b of a 64 x 2N accumulator times al_a / al_b.
template <int N>
__device__ __forceinline__ void rescale_rows(float (&o)[N], float al_a,
                                             float al_b) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
}

// Probabilities of a 64 x 2N fragment as bf16 A fragments of the P.V
// product's N/8 k-steps of 16 keys: columns 8j.. are keys 16(j/2) +
// 8(j%2).. of k-step j/2 (the mma.sync m16n8k16 A layout of each warp's
// rows).
template <int N>
__device__ __forceinline__ void probs_to_a(const float (&s)[N],
                                           uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    p[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

// An fp32 value rounded to tf32 (10 mantissa bits, to nearest, ties away
// from zero), as the fp32 bit pattern with the low 13 bits zero.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// The 64 bytes at addr, addr + stride, addr + 2 stride, addr + 3 stride
// (16 each) of shared memory rounded to tf32 in place, as round_tf32 rounds
// (the pre-pass's bits): four loads, then four stores.
__device__ __forceinline__ void round_tf32_shared(uint32_t addr,
                                                  uint32_t stride) {
  float x[16];
  asm volatile(
      "ld.shared.v4.f32 {%0, %1, %2, %3}, [%16];\n"
      "ld.shared.v4.f32 {%4, %5, %6, %7}, [%17];\n"
      "ld.shared.v4.f32 {%8, %9, %10, %11}, [%18];\n"
      "ld.shared.v4.f32 {%12, %13, %14, %15}, [%19];\n"
      : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]), "=f"(x[4]),
        "=f"(x[5]), "=f"(x[6]), "=f"(x[7]), "=f"(x[8]), "=f"(x[9]),
        "=f"(x[10]), "=f"(x[11]), "=f"(x[12]), "=f"(x[13]), "=f"(x[14]),
        "=f"(x[15])
      : "r"(addr), "r"(addr + stride), "r"(addr + 2 * stride),
        "r"(addr + 3 * stride)
      : "memory");
  uint32_t r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = round_tf32(x[i]);
  asm volatile(
      "st.shared.v4.b32 [%0], {%4, %5, %6, %7};\n"
      "st.shared.v4.b32 [%1], {%8, %9, %10, %11};\n"
      "st.shared.v4.b32 [%2], {%12, %13, %14, %15};\n"
      "st.shared.v4.b32 [%3], {%16, %17, %18, %19};\n"
      ::"r"(addr), "r"(addr + stride), "r"(addr + 2 * stride),
        "r"(addr + 3 * stride), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]),
        "r"(r[4]), "r"(r[5]), "r"(r[6]), "r"(r[7]), "r"(r[8]), "r"(r[9]),
        "r"(r[10]), "r"(r[11]), "r"(r[12]), "r"(r[13]), "r"(r[14]),
        "r"(r[15])
      : "memory");
}

// Probabilities of a 64 x 2N fragment as the tf32 A fragments of the P.V
// product's N/4 k-steps of 8 keys. A tf32 A fragment gives lane l of a
// warp k columns l%4 and l%4 + 4 of its rows l/4 and l/4 + 8; the
// accumulator gives it keys 2(l%4) and 2(l%4) + 1 of each 8. So k column
// c of a step stands for key 2c (c < 4) or 2(c - 4) + 1 of the step's 8
// keys: V^T's keys are stored in that order within each 8 (the Vt
// workspace the fp32 kernels' pre-pass writes), and each probability goes
// to the register that holds its own key, rounded to nearest.
template <int N>
__device__ __forceinline__ void probs_to_a_tf32(const float (&s)[N],
                                                uint32_t (&p)[N / 4][4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    p[j][0] = round_tf32(s[4 * j]);        // row l/4,     key 8j + 2(l%4)
    p[j][1] = round_tf32(s[4 * j + 2]);    // row l/4 + 8, key 8j + 2(l%4)
    p[j][2] = round_tf32(s[4 * j + 1]);    // row l/4,     key 8j + 2(l%4) + 1
    p[j][3] = round_tf32(s[4 * j + 3]);    // row l/4 + 8, key 8j + 2(l%4) + 1
  }
}

}  // namespace hopper
}  // namespace flexam
