// The pre-pass of the fp32 attention kernels (B1, B2, B5 and B6 in fp32 on
// TF32 wgmma): the operands rounded to tf32 and V transposed, into
// workspaces the wrappers allocate.
//
// The tensor core reads a tf32 operand's top 19 bits, which truncates; the
// kernels round every operand to nearest first. q and k (B1, B2, B5) are
// rounded into copies of their own layout. V is written as V^T [B, D, H,
// Lkp], rounded: tf32 wgmma takes no transposed operand, so P.V reads V^T
// K-major, keys contiguous. Lkp is Lk rounded up to kKeyPad (keys at or
// past Lk are zeros), and each aligned 8 keys are stored in the order (0,
// 2, 4, 6, 1, 3, 5, 7) that probs_to_a_tf32's fragments need
// (hopper_attention.cuh). B6 takes V^T only: its q and k are int8.
//
// The pass reads each operand once and writes it once more: about 0.17 ms
// of HBM time for q, k and v at the flagship shape (B 2, L 11,648, H 24,
// D 128), 0.09 ms for V alone at the long clip's 23,296 tokens.
#pragma once

#include "hopper_attention.cuh"

namespace flexam {
namespace hopper {

// V^T's keys are padded to a multiple of this: whole 64-key tiles of the
// D = 128 plans and of the wide design
constexpr int kKeyPad = 64;

inline int padded_keys(int Lk) {
  return (Lk + kKeyPad - 1) / kKeyPad * kKeyPad;
}

// The pass's kernels and their launchers have internal linkage (static):
// each source that includes this header gets its own copy.

constexpr int kPrepThreads = 256;

// y = x rounded to tf32, over n4 float4 vectors (grid-stride).
static __global__ void __launch_bounds__(kPrepThreads)
    round_tf32_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                      long long n4) {
  for (long long i = blockIdx.x * (long long)kPrepThreads + threadIdx.x;
       i < n4; i += (long long)gridDim.x * kPrepThreads) {
    const float4 t = x[i];
    y[i] = make_float4(__uint_as_float(round_tf32(t.x)),
                       __uint_as_float(round_tf32(t.y)),
                       __uint_as_float(round_tf32(t.z)),
                       __uint_as_float(round_tf32(t.w)));
  }
}

// V^T: vt[b, d, h, p] = tf32(v[b, key(p), h, d]) for p < Lkp, 0 for keys at
// or past Lk, where key(p) takes each 8 keys in the order (0, 2, 4, 6, 1,
// 3, 5, 7). A block moves 32 keys x 32 columns of one (b, h) through shared
// memory: it reads along d and writes along keys, 128 contiguous bytes a
// warp both ways.
static __global__ void __launch_bounds__(kPrepThreads)
    transpose_v_kernel(const float* __restrict__ v, float* __restrict__ vt,
                       int H, int Lk, int D, int Lkp) {
  __shared__ float tile[32][33];
  const int n_kt = Lkp / 32;
  const int key0 = (blockIdx.x % n_kt) * 32, d0 = (blockIdx.x / n_kt) * 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += kPrepThreads / 32) {
    const int key = key0 + i;
    tile[i][tx] =
        key < Lk ? v[(((size_t)b * Lk + key) * H + h) * D + d0 + tx] : 0.f;
  }
  __syncthreads();
  const int g = tx & 7;
  const int src = (tx & ~7) | (g < 4 ? 2 * g : 2 * (g - 4) + 1);
  for (int i = ty; i < 32; i += kPrepThreads / 32)
    vt[(((size_t)b * D + d0 + i) * H + h) * Lkp + key0 + tx] =
        __uint_as_float(round_tf32(tile[src][i]));
}

// Blocks of a grid-stride pass over n4 vectors.
static inline int prep_blocks(long long n4) {
  const long long need = (n4 + kPrepThreads - 1) / kPrepThreads;
  return (int)(need < 8192 ? (need > 0 ? need : 1) : 8192);
}

// Whether any of the pointers is off a 16-byte boundary.
template <typename... T>
inline bool misaligned16(const T*... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) % 16 != 0) || ...);
}

// y = x rounded to tf32, n floats (a multiple of 4), on `stream`.
static inline void round_tf32_async(const void* x, void* y, long long n,
                                    cudaStream_t stream) {
  const long long n4 = n / 4;
  round_tf32_kernel<<<prep_blocks(n4), kPrepThreads, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
}

// vt [B, D, H, Lkp] from v [B, Lk, H, D] (above), on `stream`. B * H must
// be at most 65535 (the grid's y).
static inline void transpose_v_async(const void* v, void* vt, int B, int H,
                                     int Lk, int D, int Lkp,
                                     cudaStream_t stream) {
  transpose_v_kernel<<<dim3((Lkp / 32) * (D / 32), B * H), kPrepThreads, 0,
                       stream>>>(static_cast<const float*>(v),
                                 static_cast<float*>(vt), H, Lk, D, Lkp);
}

}  // namespace hopper
}  // namespace flexam
