// RMSNorm over the full hidden dim + interleaved-pair RoPE: kernel B3.
//
// Replaces flexam_tpu/ops/fused.py:_rmsnorm_rope_kernel (B3) and its 2-D
// layout twin :_rmsnorm_rope_kernel_2d (B3'): both compute one function, and
// which layout suits the vector unit was a TPU matter.
//
// Per token row of x [B, S, D] bf16 (D = heads * dh):
//   1. inv = 1 / sqrt(mean(x^2) + eps) over all D features, in fp32;
//   2. y = bf16(x * inv) * bf16(gamma), the product taken in bf16;
//   3. pair j of each head (y[2j], y[2j+1]) rotated in fp32 by the half
//      tables cos/sin [L_rot, dh/2] (token s < L_rot; later tokens pass
//      through), then cast to bf16.
// Each thread owns whole pairs, so the rotation needs no shuffle, and the
// tables are read as they are (no sign-folded full-width expansion).
// Multiplies and adds use the _rn intrinsics so that nvcc does not contract
// them into FMAs: the result then rounds as the plain PyTorch version does.
//
// What bounds it on an H100: it reads x and writes the output once (4 bytes
// a feature) and does a few flops per byte, so memory bandwidth bounds it.
// One block per token row; the row is read once for the sum of squares and
// once more (from L1) for the output.

#include "common.cuh"

namespace {

using flexam::bf16;
using flexam::round_bf16;

__global__ void rmsnorm_rope_kernel(const bf16* __restrict__ x,
                                    const bf16* __restrict__ gamma,
                                    const float* __restrict__ cos_t,
                                    const float* __restrict__ sin_t,
                                    bf16* __restrict__ out, int S, int D, int half_dh,
                                    int L_rot, float eps) {
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const int s = row % S;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * D);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D);
  const int pairs = D / 2;

  float ss = 0.f;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const float2 v = __bfloat1622float2(xr[p]);
    ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
  }
  ss = flexam::block_sum(ss, scratch);
  const float inv = 1.f / sqrtf(ss / (float)D + eps);
  const bool rotate = s < L_rot;

  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const float2 v = __bfloat1622float2(xr[p]);
    const float2 g = __bfloat1622float2(g2[p]);
    const float ye = round_bf16(__fmul_rn(round_bf16(__fmul_rn(v.x, inv)), g.x));
    const float yo = round_bf16(__fmul_rn(round_bf16(__fmul_rn(v.y, inv)), g.y));
    if (rotate) {
      const int j = p % half_dh;
      const float c = cos_t[(size_t)s * half_dh + j];
      const float sn = sin_t[(size_t)s * half_dh + j];
      orow[p] = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(ye, c), __fmul_rn(yo, sn)),
                                      __fadd_rn(__fmul_rn(ye, sn), __fmul_rn(yo, c)));
    } else {
      orow[p] = __floats2bfloat162_rn(ye, yo);
    }
  }
}

}  // namespace

extern "C" {

// B3. x/gamma/out bf16, x and out [rows = B * S, D]; cos/sin fp32
// [L_rot, dh/2]. Returns a cudaError_t (0 on a clean launch).
int flexam_rmsnorm_rope(const void* x, const void* gamma, const void* cos_t,
                        const void* sin_t, void* out, int rows, int S, int D, int dh,
                        int L_rot, float eps, void* stream) {
  if (rows <= 0 || S <= 0 || D <= 0 || dh <= 0 || dh % 2 != 0 || D % dh != 0)
    return (int)cudaErrorInvalidValue;
  rmsnorm_rope_kernel<<<rows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<bf16*>(out), S, D, dh / 2, L_rot, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
