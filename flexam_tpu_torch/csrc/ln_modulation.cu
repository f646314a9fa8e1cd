// Affine-free LayerNorm + AdaLN modulation: kernel B4, in two modes.
//
// Replaces flexam_tpu/ops/fused.py:_ln_mod_binary_kernel (binary mode, the
// TI2V binary-timestep path) and :_ln_mod_bcast_kernel (broadcast mode, a
// scalar timestep). The exact math is flexam_tpu/ops/fused.py:_ln_mod_unfused:
//   ln  = bf16((x - mean) / sqrt(var + eps))      mean, var in fp32 over D
//   sh  = m * shift[b, 0] + (1 - m) * shift[b, 1]   (fp32; binary mode, m =
//         mask[b, s] picks the t branch where 1, the t = 0 branch where 0)
//   sh  = shift[b]                                  (broadcast mode)
//   out = ln * (1 + bf16(sc)) + bf16(sh)            each op rounded to bf16
// Multiplies and adds use the _rn intrinsics (no FMA contraction) so the
// kernel rounds where the plain PyTorch version does.
//
// What bounds it on an H100: it reads x and writes the output once (4 bytes a
// feature) plus the fp32 shift/scale rows, which stay in L2, so memory
// bandwidth bounds it. One block per token row, a two-pass mean and variance
// over the row (the second read comes from L1), then the output.

#include "common.cuh"

namespace {

using flexam::bf16;
using flexam::round_bf16;

__global__ void ln_mod_kernel(const bf16* __restrict__ x, const float* __restrict__ shift,
                              const float* __restrict__ scale,
                              const float* __restrict__ mask, bf16* __restrict__ out,
                              int S, int D, float eps) {
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const int b = row / S;
  const bf16* xr = x + (size_t)row * D;
  bf16* orow = out + (size_t)row * D;

  float sum = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) sum = __fadd_rn(sum, __bfloat162float(xr[i]));
  const float mean = flexam::block_sum(sum, scratch) / (float)D;
  float sq = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = __fsub_rn(__bfloat162float(xr[i]), mean);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float rstd = 1.f / sqrtf(flexam::block_sum(sq, scratch) / (float)D + eps);

  const float m = mask ? mask[row] : 1.f;
  const float* sh0 = mask ? shift + (size_t)b * 2 * D : shift + (size_t)b * D;
  const float* sc0 = mask ? scale + (size_t)b * 2 * D : scale + (size_t)b * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float ln = round_bf16(__fmul_rn(__fsub_rn(__bfloat162float(xr[i]), mean), rstd));
    float sh = sh0[i], sc = sc0[i];
    if (mask) {
      sh = __fadd_rn(__fmul_rn(m, sh), __fmul_rn(__fsub_rn(1.f, m), sh0[D + i]));
      sc = __fadd_rn(__fmul_rn(m, sc), __fmul_rn(__fsub_rn(1.f, m), sc0[D + i]));
    }
    const float one_sc = round_bf16(__fadd_rn(1.f, round_bf16(sc)));
    const float y = round_bf16(__fmul_rn(ln, one_sc));
    orow[i] = __float2bfloat16_rn(__fadd_rn(y, round_bf16(sh)));
  }
}

}  // namespace

extern "C" {

// B4. x/out bf16 [rows = B * S, D]. Binary mode: mask [B, S] fp32,
// shift/scale [B, 2, D] fp32. Broadcast mode: mask null, shift/scale [B, D]
// fp32. Returns a cudaError_t (0 on a clean launch).
int flexam_ln_modulation(const void* x, const void* shift, const void* scale,
                         const void* mask, void* out, int rows, int S, int D, float eps,
                         void* stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  ln_mod_kernel<<<rows, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(shift),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<bf16*>(out), S, D, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
