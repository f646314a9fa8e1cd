// RMSNorm over the full hidden dim + interleaved-pair RoPE: kernel B3.
//
// Replaces flexam_tpu/ops/fused.py:_rmsnorm_rope_kernel (B3) and its 2-D
// layout twin :_rmsnorm_rope_kernel_2d (B3'): both compute one function, and
// which layout suits the vector unit was a TPU matter.
//
// Per token row of x [B, S, D] bf16 or fp32 (D = heads * dh):
//   1. inv = 1 / sqrt(mean(x^2) + eps) over all D features, in fp32;
//   2. y = bf16(x * inv) * bf16(gamma), the product taken in bf16 (fp32:
//      y = (x * inv) * gamma in fp32, the casts no-ops);
//   3. pair j of each head (y[2j], y[2j+1]) rotated in fp32 by the half
//      tables cos/sin [L_rot, dh/2] (token s < L_rot; later tokens pass
//      through), then cast to x's dtype.
// Multiplies and adds use the _rn intrinsics so that nvcc does not contract
// them into FMAs: the result then rounds as the plain PyTorch version does.
//
// What bounds it on an H100: it reads x and writes the output once (4 bytes
// a feature) and does a few flops per byte, so memory bandwidth does, and
// HBM stays busy only with tens of KB in flight on each SM. The design
// streams rows:
//   * one warp a token row, held in registers as 16-byte vectors (all of a
//     lane's loads issued before any is used); the sum of squares reduced by
//     warp shuffles (no block barrier); 16-byte stores;
//   * persistent CTAs, gridDim.y = batch; gamma is read once per CTA into
//     shared memory (each lane reads its own columns' 16-byte vectors of
//     it; held in registers beside the row, it took 209 registers at
//     D = 3072, one CTA an SM, and spilled at 5120);
//   * bf16(x * inv) * gamma as one bf16x2 multiply a pair;
//   * a lane's 8 columns are 4 consecutive rotation pairs of one head (dh a
//     multiple of 8), so its cos and sin are one float4 each from the
//     token's table row; the column's table offset is computed once per CTA.
//
// fp32 (rmsnorm_rope_f32_kernel): a row is twice the bytes, more than a
// warp's registers hold at 8192 features, so a CTA of 256 threads holds a
// row (common.cuh), each thread 16-byte vectors of 4 features (2 rotation
// pairs) and gamma's for its columns in registers for the CTA's life; the
// next row's loads go out before this row is reduced.

#include "common.cuh"

namespace {

using flexam::bf16;

constexpr int kThreads = 256;       // 8 warps, a token row each at a time

template <int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rope_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    bf16* __restrict__ out, int S, int D, int half_dh, int L_rot,
                    float eps) {
  __shared__ uint4 g_smem[NV * 32];
  const int b = blockIdx.y;
  const int nvec = D >> 3;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (kThreads / 32);
  int s = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);

  uint4 xv[NV];
  if (s < S) flexam::load_row<NV>(x + ((size_t)b * S + s) * D, lane, nvec, xv);
  int j0[NV];                       // table offset of each vector's first pair
#pragma unroll
  for (int i = 0; i < NV; ++i) j0[i] = ((lane + 32 * i) * 4) % half_dh;
  for (int c = threadIdx.x; c < nvec; c += kThreads)
    g_smem[c] = reinterpret_cast<const uint4*>(gamma)[c];
  __syncthreads();

  while (s < S) {
    bf16* orow = out + ((size_t)b * S + s) * D;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint32_t w[4];
      flexam::words(xv[i], w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = flexam::bf16_lo(w[k]), hi = flexam::bf16_hi(w[k]);
        ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(lo, lo), __fmul_rn(hi, hi)));
      }
    }
    const float inv = 1.f / sqrtf(flexam::warp_sum(ss) / (float)D + eps);
    const bool rotate = s < L_rot;
    const float* crow = cos_t + (size_t)s * half_dh;
    const float* srow = sin_t + (size_t)s * half_dh;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c >= nvec) continue;
      uint32_t w[4], g[4];
      flexam::words(xv[i], w);
      flexam::words(g_smem[c], g);
      // bf16(x * inv) * gamma in bf16x2
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = flexam::mul_bf16x2(
            flexam::pack_bf16(__fmul_rn(flexam::bf16_lo(w[k]), inv),
                              __fmul_rn(flexam::bf16_hi(w[k]), inv)), g[k]);
      if (rotate) {
        const float4 cv = __ldg(reinterpret_cast<const float4*>(crow + j0[i]));
        const float4 sv = __ldg(reinterpret_cast<const float4*>(srow + j0[i]));
        const float cs[4] = {cv.x, cv.y, cv.z, cv.w}, sn[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float ye = flexam::bf16_lo(w[p]), yo = flexam::bf16_hi(w[p]);
          w[p] = flexam::pack_bf16(__fsub_rn(__fmul_rn(ye, cs[p]), __fmul_rn(yo, sn[p])),
                                   __fadd_rn(__fmul_rn(ye, sn[p]), __fmul_rn(yo, cs[p])));
        }
      }
      reinterpret_cast<uint4*>(orow)[c] = flexam::vec(w);
    }

    s += stride;
    if (s < S) flexam::load_row<NV>(x + ((size_t)b * S + s) * D, lane, nvec, xv);
  }
}

template <int NV>
__global__ void __launch_bounds__(flexam::kRowThreads)
rmsnorm_rope_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ cos_t,
                        const float* __restrict__ sin_t, float* __restrict__ out,
                        int S, int D, int half_dh, int L_rot, float eps) {
  __shared__ float red[flexam::kRowThreads / 32];
  const int b = blockIdx.y;
  const int nvec = D >> 2;
  int s = blockIdx.x;

  float4 xv[NV], g[NV];
  int j0[NV];                       // table offset of each vector's first pair
  if (s < S) flexam::load_row_f32<NV>(x + ((size_t)b * S + s) * D, nvec, xv);
  flexam::load_row_f32<NV>(gamma, nvec, g);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    j0[i] = ((threadIdx.x + flexam::kRowThreads * i) * 2) % half_dh;

  while (s < S) {
    const int next = s + gridDim.x;
    float4 xn[NV];
    if (next < S) flexam::load_row_f32<NV>(x + ((size_t)b * S + next) * D, nvec, xn);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 v = xv[i];
      ss = __fadd_rn(ss, __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                                   __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w))));
    }
    const float inv = 1.f / sqrtf(flexam::block_sum(ss, red) / (float)D + eps);
    const bool rotate = s < L_rot;
    float* orow = out + ((size_t)b * S + s) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + flexam::kRowThreads * i;
      if (c >= nvec) continue;
      float y[4] = {__fmul_rn(__fmul_rn(xv[i].x, inv), g[i].x),
                    __fmul_rn(__fmul_rn(xv[i].y, inv), g[i].y),
                    __fmul_rn(__fmul_rn(xv[i].z, inv), g[i].z),
                    __fmul_rn(__fmul_rn(xv[i].w, inv), g[i].w)};
      if (rotate) {
        const float2 cv = __ldg(reinterpret_cast<const float2*>(cos_t + (size_t)s * half_dh + j0[i]));
        const float2 sv = __ldg(reinterpret_cast<const float2*>(sin_t + (size_t)s * half_dh + j0[i]));
        const float cs[2] = {cv.x, cv.y}, sn[2] = {sv.x, sv.y};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float ye = y[2 * p], yo = y[2 * p + 1];
          y[2 * p] = __fsub_rn(__fmul_rn(ye, cs[p]), __fmul_rn(yo, sn[p]));
          y[2 * p + 1] = __fadd_rn(__fmul_rn(ye, sn[p]), __fmul_rn(yo, cs[p]));
        }
      }
      reinterpret_cast<float4*>(orow)[c] = make_float4(y[0], y[1], y[2], y[3]);
    }
    s = next;
#pragma unroll
    for (int i = 0; i < NV; ++i) xv[i] = xn[i];
  }
}

template <int NV>
int launch_f32(const void* x, const void* gamma, const void* cos_t, const void* sin_t,
               void* out, int B, int S, int D, int dh, int L_rot, float eps,
               cudaStream_t stream) {
  const int gx = flexam::persistent_ctas(rmsnorm_rope_f32_kernel<NV>,
                                         flexam::kRowThreads, 0, B, S);
  rmsnorm_rope_f32_kernel<NV><<<dim3(gx, B), flexam::kRowThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<float*>(out), S, D, dh / 2, L_rot, eps);
  return (int)cudaGetLastError();
}

template <int NV>
int launch(const void* x, const void* gamma, const void* cos_t, const void* sin_t,
           void* out, int B, int S, int D, int dh, int L_rot, float eps,
           cudaStream_t stream) {
  const int gx = flexam::persistent_ctas(rmsnorm_rope_kernel<NV>, kThreads, 0, B,
                                         (S + kThreads / 32 - 1) / (kThreads / 32));
  rmsnorm_rope_kernel<NV><<<dim3(gx, B), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), S, D, dh / 2, L_rot, eps);
  return (int)cudaGetLastError();
}

bool bad_args(const void* x, const void* gamma, const void* cos_t,
              const void* sin_t, void* out, int B, int S, int D, int dh,
              int L_rot) {
  return B <= 0 || S <= 0 || D <= 0 || dh <= 0 || dh % 8 != 0 || D % dh != 0 ||
         B > 65535 || L_rot < 0 ||
         ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)cos_t |
          (uintptr_t)sin_t | (uintptr_t)out) % 16 != 0;
}

}  // namespace

extern "C" {

// B3. x/gamma/out bf16, x and out [B, S, D]; cos/sin fp32 [L_rot, dh/2].
// dh a multiple of 8 dividing D, D up to 8192; every pointer 16-byte
// aligned. Returns a cudaError_t (0 on a clean launch).
int flexam_rmsnorm_rope(const void* x, const void* gamma, const void* cos_t,
                        const void* sin_t, void* out, int B, int S, int D, int dh,
                        int L_rot, float eps, void* stream) {
  if (bad_args(x, gamma, cos_t, sin_t, out, B, S, D, dh, L_rot))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flexam::row_vectors(D)) {
#define FLEXAM_CASE(n) \
  case n:              \
    return launch<n>(x, gamma, cos_t, sin_t, out, B, S, D, dh, L_rot, eps, st);
    FLEXAM_ROW_VECTORS(FLEXAM_CASE)
#undef FLEXAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B3 in fp32: x/gamma/out fp32, the rest as flexam_rmsnorm_rope.
int flexam_rmsnorm_rope_f32(const void* x, const void* gamma, const void* cos_t,
                            const void* sin_t, void* out, int B, int S, int D,
                            int dh, int L_rot, float eps, void* stream) {
  if (bad_args(x, gamma, cos_t, sin_t, out, B, S, D, dh, L_rot))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flexam::row_vectors_f32(D)) {
#define FLEXAM_CASE(n) \
  case n:              \
    return launch_f32<n>(x, gamma, cos_t, sin_t, out, B, S, D, dh, L_rot, eps, st);
    FLEXAM_ROW_VECTORS_F32(FLEXAM_CASE)
#undef FLEXAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
