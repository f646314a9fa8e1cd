// Hopper (sm_90a) building blocks for the port's attention kernels: TMA
// tensor maps and loads/stores, mbarriers, wgmma, register reallocation,
// and the online softmax on wgmma accumulator fragments. Used by B1/B2
// (flash_attention.cu); written so that B5 and B6 can adopt them.
// Outputs leave by plain stores from registers: a persistent CTA frees its
// Q buffer for the next item's load instead of staging the output there.
//
// Tiles in shared memory use the 128-byte swizzle: a [rows, 128] bf16 tile
// is two column halves of [rows, 64] (128 bytes a row), each 1024-byte
// aligned; inside a half, the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). TMA writes that layout (CU_TENSOR_MAP_SWIZZLE_128B) and
// wgmma reads it through descriptors with layout type 1.
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

// the masked-key logit, bf16 packing and quad reductions of the mma.sync
// tile code (a wgmma fragment's rows sit in the same quads)
using attn::kNeg;
using attn::pack_bf16;
using attn::quad_max;
using attn::quad_sum;

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

// A 4-D map over a [B, L, H, 128] bf16 tensor, dims innermost first
// (128, H, L, B), with boxes of (64 columns, 1 head, box_rows rows, 1 batch)
// and the 128-byte swizzle. Rows past L (or before 0) read as zeros and
// are not written: the ragged edge of L stays inside its batch. Returns
// false if the map is refused (e.g. a pointer not 16-byte aligned).
inline bool make_bl_hd_map(CUtensorMap* map, const void* base, int B, int L,
                           int H, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t row = 128 * sizeof(bf16);
  cuuint64_t dims[4] = {128, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {row, row * H, row * H * L};   // bytes, dims 1..3
  cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
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
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define FLEXAM_ACC64(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),         \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),         \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),         \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

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
      : FLEXAM_ACC64(d)
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
      : FLEXAM_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FLEXAM_ACC64
#undef FLEXAM_D64

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

// The online-softmax step of a 128-key tile, up to the accumulator: s holds
// this thread's raw q.k of rows a = l/4 and b = l/4 + 8 of its warp, whose
// logits are s * `scale` (or, with scale 1, logits already scaled and
// masked). Raises the running maxima m_a / m_b, turns s into
// exp2(scale * s - m) in place, and returns the factors al_* that the
// accumulator and the sums must take and this thread's share of the tile's
// row sums. Scaling by a positive factor keeps the max, so the max is taken
// on s and scaled once; the exponent is one FFMA.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float scale,
                                             float& m_a, float& m_b,
                                             float& al_a, float& al_b,
                                             float& sum_a, float& sum_b) {
  float mx_a = s[0], mx_b = s[2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(m_a, quad_max(mx_a) * scale);
  mx_b = fmaxf(m_b, quad_max(mx_b) * scale);
  al_a = ex2(m_a - mx_a);
  al_b = ex2(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  sum_a = sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], scale, -mx_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale, -mx_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale, -mx_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale, -mx_b));
    sum_a += s[4 * j] + s[4 * j + 1];
    sum_b += s[4 * j + 2] + s[4 * j + 3];
  }
}

// Rows a / b of a 64 x 128 accumulator times al_a / al_b.
__device__ __forceinline__ void rescale_rows(float (&o)[64], float al_a,
                                             float al_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= al_a;
    o[4 * j + 1] *= al_a;
    o[4 * j + 2] *= al_b;
    o[4 * j + 3] *= al_b;
  }
}

// Probabilities of a 64 x 128 fragment as bf16 A fragments of the P.V
// product's 8 k-steps of 16 keys: columns 8j.. are keys 16(j/2) + 8(j%2)..
// of k-step j/2 (the mma.sync m16n8k16 A layout of each warp's rows).
__device__ __forceinline__ void probs_to_a(const float (&s)[64],
                                           uint32_t (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    p[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

}  // namespace hopper
}  // namespace flexam
