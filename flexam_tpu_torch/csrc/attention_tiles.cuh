// mma.sync tile code shared by the port's attention kernels B5
// (sparse_attention.cu) and B6 (int8_attention.cu). B1/B2 (Hopper kernels,
// hopper_attention.cuh) take only its masked-key logit, bf16 packing and
// quad reductions.
//
// One warp owns 16 query rows; a block of 4 warps owns a 64-row query tile.
// Keys stream through shared memory in 64-key tiles (rows padded to 136
// bf16, so the mma fragment loads and the ldmatrix.trans V loads are
// bank-conflict free). Logits live in registers as mma C fragments:
// s[j][e] is key n0 + 8j + 2*tig + (e & 1) of row g (e < 2) or g + 8
// (e >= 2), with g = lane / 4 and tig = lane % 4.
#pragma once

#include "common.cuh"

namespace flexam {
namespace attn {

constexpr int kD = 128;             // head dim
constexpr int kBM = 64;             // query rows per block
constexpr int kBN = 64;             // keys per tile
constexpr int kWarps = kBM / 16;    // one warp per 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;        // padded smem row (bf16 elements)
constexpr float kNeg = -1e30f;      // logit of a masked key

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy a [kBN, kD] tile of one head (rows n0.., zero past `rows`) into
// padded shared memory, 16 bytes a thread per step (a row is 256 bytes,
// read by 16 neighbouring threads).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int n0,
                                          int rows, int row_stride) {
  constexpr int kChunks = kBN * kD / 8;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c >> 4, col = (c & 15) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(n0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

// The warp's 16 query rows as mma A fragments, 8 k-steps of 16 over D;
// rows at or past `rows` are zero.
__device__ __forceinline__ void load_q(uint32_t qa[8][4], const bf16* qh,
                                       int row0, int rows, int row_stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int col = ks * 16 + tig * 2;
    const bf16* pa = qh + (size_t)ra * row_stride + col;
    const bf16* pb = qh + (size_t)rb * row_stride + col;
    qa[ks][0] = ra < rows ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
    qa[ks][1] = rb < rows ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
    qa[ks][2] = ra < rows ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
    qa[ks][3] = rb < rows ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
  }
}

// s = (Q K^T) * scale_log2 for the warp's 16 rows x the tile's 64 keys,
// masked at and past `valid` keys.
__device__ __forceinline__ void tile_logits(float s[8][4], const uint32_t qa[8][4],
                                            const bf16* ks_tile, int n0, int valid,
                                            float scale_log2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const bf16* kp = ks_tile + (j * 8 + g) * kLds + ks * 16 + tig * 2;
      mma_16816(s[j], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + j * 8 + tig * 2 + (e & 1);
      s[j][e] = key < valid ? s[j][e] * scale_log2 : kNeg;
    }
  }
}

// acc += P V over one 64-key tile; p[j] holds probabilities in C layout,
// cast to bf16 for the product.
__device__ __forceinline__ void tile_pv(float acc[16][4], const float p[8][4],
                                        const bf16* vs_tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int nt = 0; nt < 16; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs_tile + vrow * kLds + (nt + (lane >> 4)) * 8);
      mma_16816(acc[nt], a, b[0], b[1]);
      mma_16816(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero_acc(float acc[16][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// One online-softmax step over a tile of exp2-domain logits: raise the
// running maxima m0/m1 (rows g, g + 8), rescale this thread's share of the
// sums l0/l1 and the accumulator, and turn s into exp2(s - m).
__device__ __forceinline__ void online_softmax(float s[8][4], float acc[16][4],
                                               float& m0, float& m1,
                                               float& l0, float& l1) {
  float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = exp2f(s[j][0] - mn0);
    s[j][1] = exp2f(s[j][1] - mn0);
    s[j][2] = exp2f(s[j][2] - mn1);
    s[j][3] = exp2f(s[j][3] - mn1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    acc[nt][0] *= al0;
    acc[nt][1] *= al0;
    acc[nt][2] *= al1;
    acc[nt][3] *= al1;
  }
}

// Write acc / l (rows g and g + 8 of the warp's 16, from row0) as bf16 to
// oh, a head's base in the [*, L, H, D] output; rows at or past `rows` are
// not written. l0/l1 are the rows' full sums.
__device__ __forceinline__ void store_rows(bf16* oh, int row_stride,
                                           const float acc[16][4], float l0,
                                           float l1, int row0, int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (ra < rows)
      *reinterpret_cast<uint32_t*>(oh + (size_t)ra * row_stride + col) =
          pack_bf16(acc[nt][0] / l0, acc[nt][1] / l0);
    if (rb < rows)
      *reinterpret_cast<uint32_t*>(oh + (size_t)rb * row_stride + col) =
          pack_bf16(acc[nt][2] / l1, acc[nt][3] / l1);
  }
}

}  // namespace attn
}  // namespace flexam
