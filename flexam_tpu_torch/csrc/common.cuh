// Helpers shared by the port's CUDA kernels (plain C interface, no PyTorch
// headers, so that one `nvcc -shared` call builds every kernel in seconds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flexam {

typedef __nv_bfloat16 bf16;

// Round a float to bf16 and back: the value an op computed in bf16 holds.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 held in a 32-bit word (the lower address in the low half).
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// bf16x2 products and sums, each rounded once to bf16 (no contraction into
// an FMA). For bf16 operands they equal the fp32 product or sum rounded to
// bf16, as the plain version computes them: fp32 holds a product of two
// 8-bit significands exactly, and rounding a sum first to fp32 (24 bits)
// then to bf16 (8 bits) never differs from rounding it once (24 >= 2*8+2).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2_rn(*reinterpret_cast<__nv_bfloat162*>(&a),
                                *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2_rn(*reinterpret_cast<__nv_bfloat162*>(&a),
                                *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Sum over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Row-streaming kernels (B3, B4): one warp holds a whole token row in
// registers, as 16-byte vectors of 8 bf16, lane l owning vectors l, l + 32,
// l + 64, ... A kernel is instantiated for NV vectors a lane (rows of up to
// 256 * NV features); the row's width need not fill the last round.
// ---------------------------------------------------------------------------

#define FLEXAM_ROW_VECTORS(X) X(1) X(2) X(4) X(6) X(8) X(12) X(16) X(20) X(24) X(32)
constexpr int kMaxRowVectors = 32;      // rows of up to 8192 features

// The smallest instantiated NV that holds a row of D features, 0 if none.
inline int row_vectors(int D) {
  const int need = (D + 255) / 256;
#define FLEXAM_PICK(n) if (need <= n) return n;
  FLEXAM_ROW_VECTORS(FLEXAM_PICK)
#undef FLEXAM_PICK
  return 0;
}

// The four 32-bit words of a 16-byte vector, and back.
__device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ uint4 vec(const uint32_t (&w)[4]) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's vectors of one row, all loads issued before any is used; the
// vectors past the row's end are zero.
template <int NV>
__device__ __forceinline__ void load_row(const bf16* row, int lane, int nvec,
                                         uint4 (&v)[NV]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < nvec ? p[c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// fp32 rows (B3 and B4 in fp32): a row of up to 8192 fp32 is 32 KB, twice
// what a warp holds in registers, so a CTA of kRowThreads threads holds one
// row at a time: thread t owns 16-byte vectors (4 fp32) t, t + 256, ... NV
// of them (rows of up to 1024 * NV features); sums run in each thread's
// registers, then through warp shuffles, then over the 8 warps in shared
// memory, in a fixed order.
// ---------------------------------------------------------------------------

#define FLEXAM_ROW_VECTORS_F32(X) X(1) X(2) X(3) X(4) X(6) X(8)
constexpr int kRowThreads = 256;

// The smallest instantiated fp32 NV that holds a row of D features, 0 if
// none.
inline int row_vectors_f32(int D) {
  const int need = (D / 4 + kRowThreads - 1) / kRowThreads;
#define FLEXAM_PICK(n) if (need <= n) return n;
  FLEXAM_ROW_VECTORS_F32(FLEXAM_PICK)
#undef FLEXAM_PICK
  return 0;
}

// This thread's vectors of one fp32 row, all loads issued before any is
// used; the vectors past the row's end are zero.
template <int NV>
__device__ __forceinline__ void load_row_f32(const float* row, int nvec,
                                             float4 (&v)[NV]) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + kRowThreads * i;
    v[i] = c < nvec ? p[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Sum of v over the CTA's kRowThreads threads; every thread gets the same
// value. `red` is kRowThreads / 32 floats of shared memory, free again on
// return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kRowThreads / 32; ++w) t = __fadd_rn(t, red[w]);
  __syncthreads();
  return t;
}

// x-extent of a persistent grid whose y-extent is `batches`: as many CTAs as
// the card holds at once, shared among the batches, and no more than `need`.
template <typename Kernel>
inline int persistent_ctas(Kernel kernel, int threads, size_t smem, int batches,
                           int need) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int x = (sms * (per_sm > 0 ? per_sm : 1)) / batches;
  return x < 1 ? 1 : (x < need ? x : need);
}

}  // namespace flexam
