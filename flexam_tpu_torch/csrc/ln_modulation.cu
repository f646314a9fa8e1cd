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
// x may also be fp32: the casts are then no-ops and every op rounds to fp32
// (ln_mod_f32_kernel).
// Multiplies and adds use the _rn intrinsics (no FMA contraction) so the
// kernel rounds where the plain PyTorch version does.
//
// What bounds it on an H100: it reads x and writes the output once (4 bytes a
// feature), so memory bandwidth does, and HBM stays busy only with tens of KB
// in flight on each SM. The design streams rows:
//   * one warp a token row, held in registers as 16-byte vectors (all of a
//     lane's loads issued before any is used, and the next row's before
//     this one is reduced, up to 6144 features); mean and variance
//     two-pass from the registers, reduced by warp shuffles (no block
//     barrier);
//   * ln rounded to bf16 in pairs, then ln * (1 + sc) and + sh as bf16x2
//     operations, each rounded once, as the plain version's bf16 ops are;
//   * persistent CTAs, gridDim.y = batch, so each CTA stages its batch's
//     terms once, in shared memory, in the form a row uses them: bf16(sh)
//     and bf16(1 + bf16(sc)) of each branch. A token whose mask is exactly 1
//     or 0 takes its branch's staged terms (the fp32 mix then equals that
//     branch's term); any other mask value mixes the fp32 terms as above;
//   * the terms are read through their strides (the last dim contiguous), so
//     a strided view of the modulation tensor needs no copy first.
//
// fp32 (ln_mod_f32_kernel): a CTA of 256 threads holds a row (common.cuh),
// each thread 16-byte vectors of 4 features; the same two-pass mean and
// variance, and the same staged terms, sh and 1 + sc of each branch in
// fp32; the next row's loads go out before this row is reduced.

#include "common.cuh"

namespace {

using flexam::bf16;
using flexam::round_bf16;

constexpr int kThreads = 256;       // 8 warps, a token row each at a time

template <int NV>
__global__ void __launch_bounds__(kThreads)
ln_mod_kernel(const bf16* __restrict__ x, const float* __restrict__ shift,
              const float* __restrict__ scale, const float* __restrict__ mask,
              bf16* __restrict__ out, int S, int D, int sh_b, int sh_r, int sc_b,
              int sc_r, float eps) {
  extern __shared__ uint4 terms[];   // [branch][bf16(sh), bf16(1 + sc)][D / 8]
  constexpr bool kPrefetch = NV <= 24;  // two rows of 32 vectors spill
  const int b = blockIdx.y;
  const int nvec = D >> 3;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (kThreads / 32);
  int s = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const float* shb = shift + (size_t)b * sh_b;
  const float* scb = scale + (size_t)b * sc_b;

  // the first row's loads go out before the terms are staged
  uint4 xv[NV];
  float m = 1.f;
  if (s < S) {
    flexam::load_row<NV>(x + ((size_t)b * S + s) * D, lane, nvec, xv);
    if (mask) m = mask[(size_t)b * S + s];
  }
  const int branches = mask ? 2 : 1;
  for (int i = threadIdx.x; i < branches * nvec; i += kThreads) {
    const int br = i / nvec, c = i - br * nvec;
    const float* sh = shb + (size_t)br * sh_r + 8 * c;
    const float* sc = scb + (size_t)br * sc_r + 8 * c;
    uint32_t hs[4], hc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hs[k] = flexam::pack_bf16(sh[2 * k], sh[2 * k + 1]);
      hc[k] = flexam::pack_bf16(__fadd_rn(1.f, round_bf16(sc[2 * k])),
                                __fadd_rn(1.f, round_bf16(sc[2 * k + 1])));
    }
    terms[2 * br * nvec + c] = flexam::vec(hs);
    terms[(2 * br + 1) * nvec + c] = flexam::vec(hc);
  }
  __syncthreads();

  while (s < S) {
    // the next row's loads go out before this row is reduced, where two
    // rows fit in registers
    const int next = s + stride;
    uint4 xn[NV];
    float mn = 1.f;
    if (kPrefetch && next < S) {
      flexam::load_row<NV>(x + ((size_t)b * S + next) * D, lane, nvec, xn);
      if (mask) mn = mask[(size_t)b * S + next];
    }
    bf16* orow = out + ((size_t)b * S + s) * D;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint32_t w[4];
      flexam::words(xv[i], w);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sum = __fadd_rn(__fadd_rn(sum, flexam::bf16_lo(w[k])), flexam::bf16_hi(w[k]));
    }
    const float mean = flexam::warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i >= nvec) continue;
      uint32_t w[4];
      flexam::words(xv[i], w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dl = __fsub_rn(flexam::bf16_lo(w[k]), mean);
        const float dh = __fsub_rn(flexam::bf16_hi(w[k]), mean);
        sq = __fadd_rn(__fadd_rn(sq, __fmul_rn(dl, dl)), __fmul_rn(dh, dh));
      }
    }
    const float rstd = 1.f / sqrtf(flexam::warp_sum(sq) / (float)D + eps);
    const int br = m == 1.f ? 0 : 1;
    const bool mix = m != 1.f && m != 0.f;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c >= nvec) continue;
      uint32_t w[4], sh[4], sc1[4];
      flexam::words(xv[i], w);
      if (!mix) {
        flexam::words(terms[2 * br * nvec + c], sh);
        flexam::words(terms[(2 * br + 1) * nvec + c], sc1);
      } else {
        const float* a = shb + 8 * c;
        const float* g = scb + 8 * c;
        const float u = __fsub_rn(1.f, m);
        float hs[8], hc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          hs[k] = __fadd_rn(__fmul_rn(m, a[k]), __fmul_rn(u, a[sh_r + k]));
          hc[k] = __fadd_rn(1.f, round_bf16(__fadd_rn(__fmul_rn(m, g[k]),
                                                      __fmul_rn(u, g[sc_r + k]))));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sh[k] = flexam::pack_bf16(hs[2 * k], hs[2 * k + 1]);
          sc1[k] = flexam::pack_bf16(hc[2 * k], hc[2 * k + 1]);
        }
      }
      // ln rounded to bf16, then ln * (1 + sc) and + sh in bf16x2
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t ln =
            flexam::pack_bf16(__fmul_rn(__fsub_rn(flexam::bf16_lo(w[k]), mean), rstd),
                              __fmul_rn(__fsub_rn(flexam::bf16_hi(w[k]), mean), rstd));
        w[k] = flexam::add_bf16x2(flexam::mul_bf16x2(ln, sc1[k]), sh[k]);
      }
      reinterpret_cast<uint4*>(orow)[c] = flexam::vec(w);
    }

    s = next;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < NV; ++i) xv[i] = xn[i];
      m = mn;
    } else if (s < S) {
      flexam::load_row<NV>(x + ((size_t)b * S + s) * D, lane, nvec, xv);
      if (mask) m = mask[(size_t)b * S + s];
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(flexam::kRowThreads)
ln_mod_f32_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                  const float* __restrict__ scale, const float* __restrict__ mask,
                  float* __restrict__ out, int S, int D, int sh_b, int sh_r,
                  int sc_b, int sc_r, float eps) {
  extern __shared__ float4 terms_f32[];  // [branch][sh, 1 + sc][D / 4]
  __shared__ float red[flexam::kRowThreads / 32];
  const int b = blockIdx.y;
  const int nvec = D >> 2;
  int s = blockIdx.x;
  const float* shb = shift + (size_t)b * sh_b;
  const float* scb = scale + (size_t)b * sc_b;

  float4 xv[NV];
  float m = 1.f;
  if (s < S) {
    flexam::load_row_f32<NV>(x + ((size_t)b * S + s) * D, nvec, xv);
    if (mask) m = mask[(size_t)b * S + s];
  }
  const int branches = mask ? 2 : 1;
  for (int i = threadIdx.x; i < branches * nvec; i += flexam::kRowThreads) {
    const int br = i / nvec, c = i - br * nvec;
    const float* sh = shb + (size_t)br * sh_r + 4 * c;
    const float* sc = scb + (size_t)br * sc_r + 4 * c;
    terms_f32[2 * br * nvec + c] = make_float4(sh[0], sh[1], sh[2], sh[3]);
    terms_f32[(2 * br + 1) * nvec + c] =
        make_float4(__fadd_rn(1.f, sc[0]), __fadd_rn(1.f, sc[1]),
                    __fadd_rn(1.f, sc[2]), __fadd_rn(1.f, sc[3]));
  }
  __syncthreads();

  while (s < S) {
    const int next = s + gridDim.x;
    float4 xn[NV];
    float mn = 1.f;
    if (next < S) {
      flexam::load_row_f32<NV>(x + ((size_t)b * S + next) * D, nvec, xn);
      if (mask) mn = mask[(size_t)b * S + next];
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      sum = __fadd_rn(sum, __fadd_rn(__fadd_rn(xv[i].x, xv[i].y),
                                     __fadd_rn(xv[i].z, xv[i].w)));
    const float mean = flexam::block_sum(sum, red) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (threadIdx.x + flexam::kRowThreads * i >= nvec) continue;
      const float d0 = __fsub_rn(xv[i].x, mean), d1 = __fsub_rn(xv[i].y, mean);
      const float d2 = __fsub_rn(xv[i].z, mean), d3 = __fsub_rn(xv[i].w, mean);
      sq = __fadd_rn(sq, __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                   __fadd_rn(__fmul_rn(d2, d2), __fmul_rn(d3, d3))));
    }
    const float rstd = 1.f / sqrtf(flexam::block_sum(sq, red) / (float)D + eps);
    const int br = m == 1.f ? 0 : 1;
    const bool mix = m != 1.f && m != 0.f;
    float* orow = out + ((size_t)b * S + s) * D;

#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + flexam::kRowThreads * i;
      if (c >= nvec) continue;
      float4 sh4, sc4;
      if (!mix) {
        sh4 = terms_f32[2 * br * nvec + c];
        sc4 = terms_f32[(2 * br + 1) * nvec + c];
      } else {
        const float* a = shb + 4 * c;
        const float* g = scb + 4 * c;
        const float u = __fsub_rn(1.f, m);
        float hs[4], hc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hs[k] = __fadd_rn(__fmul_rn(m, a[k]), __fmul_rn(u, a[sh_r + k]));
          hc[k] = __fadd_rn(1.f, __fadd_rn(__fmul_rn(m, g[k]), __fmul_rn(u, g[sc_r + k])));
        }
        sh4 = make_float4(hs[0], hs[1], hs[2], hs[3]);
        sc4 = make_float4(hc[0], hc[1], hc[2], hc[3]);
      }
      const float4 v = xv[i];
      reinterpret_cast<float4*>(orow)[c] = make_float4(
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mean), rstd), sc4.x), sh4.x),
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.y, mean), rstd), sc4.y), sh4.y),
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.z, mean), rstd), sc4.z), sh4.z),
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.w, mean), rstd), sc4.w), sh4.w));
    }
    s = next;
#pragma unroll
    for (int i = 0; i < NV; ++i) xv[i] = xn[i];
    m = mn;
  }
}

template <int NV>
int launch_f32(const void* x, const void* shift, const void* scale, const void* mask,
               void* out, int B, int S, int D, int sh_b, int sh_r, int sc_b, int sc_r,
               float eps, cudaStream_t stream) {
  const size_t smem = (mask ? 2 : 1) * 2 * (size_t)D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_mod_f32_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gx = flexam::persistent_ctas(ln_mod_f32_kernel<NV>, flexam::kRowThreads,
                                         smem, B, S);
  ln_mod_f32_kernel<NV><<<dim3(gx, B), flexam::kRowThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(shift),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<float*>(out), S, D, sh_b, sh_r, sc_b, sc_r, eps);
  return (int)cudaGetLastError();
}

template <int NV>
int launch(const void* x, const void* shift, const void* scale, const void* mask,
           void* out, int B, int S, int D, int sh_b, int sh_r, int sc_b, int sc_r,
           float eps, cudaStream_t stream) {
  const size_t smem = (mask ? 2 : 1) * 2 * (size_t)D * sizeof(bf16);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(ln_mod_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int gx = flexam::persistent_ctas(ln_mod_kernel<NV>, kThreads, smem, B,
                                         (S + kThreads / 32 - 1) / (kThreads / 32));
  ln_mod_kernel<NV><<<dim3(gx, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(shift),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<bf16*>(out), S, D, sh_b, sh_r, sc_b, sc_r, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B4. x/out bf16 [B, S, D], 16-byte aligned, D a multiple of 8 up to 8192.
// Binary mode: mask [B, S] fp32, shift/scale fp32 [B, 2, D] read at
// shift[b * sh_b + branch * sh_r + d] (scale likewise). Broadcast mode: mask
// null, shift/scale [B, D] at shift[b * sh_b + d] (sh_r, sc_r unused).
// Returns a cudaError_t (0 on a clean launch).
int flexam_ln_modulation(const void* x, const void* shift, const void* scale,
                         const void* mask, void* out, int B, int S, int D, int sh_b,
                         int sh_r, int sc_b, int sc_r, float eps, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || B > 65535 ||
      ((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flexam::row_vectors(D)) {
#define FLEXAM_CASE(n) \
  case n:              \
    return launch<n>(x, shift, scale, mask, out, B, S, D, sh_b, sh_r, sc_b, sc_r, eps, st);
    FLEXAM_ROW_VECTORS(FLEXAM_CASE)
#undef FLEXAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B4 in fp32: x/out fp32, the rest as flexam_ln_modulation.
int flexam_ln_modulation_f32(const void* x, const void* shift, const void* scale,
                             const void* mask, void* out, int B, int S, int D,
                             int sh_b, int sh_r, int sc_b, int sc_r, float eps,
                             void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D % 8 != 0 || B > 65535 ||
      ((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (flexam::row_vectors_f32(D)) {
#define FLEXAM_CASE(n) \
  case n:              \
    return launch_f32<n>(x, shift, scale, mask, out, B, S, D, sh_b, sh_r, sc_b, sc_r, eps, st);
    FLEXAM_ROW_VECTORS_F32(FLEXAM_CASE)
#undef FLEXAM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
