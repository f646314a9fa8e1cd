// SageAttention-style attention with int8 Q K^T: kernel B6 of the port.
//
// Replaces flexam_tpu/ops/int8_attention.py:_int8_flash_kernel. As there,
// the wrapper (ops/int8_attention.py) smooths k by its per-(batch, head)
// mean and quantizes q and k to int8 with one absmax scale per (batch,
// head, block of rows) before the launch; this kernel gets the int8 tensors
// and the scales expanded to one per query row and one per key, so a
// 64-row tile that straddles two quantization blocks (1,456 rows at 23,296
// tokens is 22.75 tiles) still uses each row's and each key's own scale.
//
// Math, as in the TPU kernel: int32 logits from int8 q.k (mma.sync
// m16n8k32 s8.s8.s32, exact), dequantized by (q_scale * k_scale) *
// (softmax scale * log2 e) in that order, masked to -1e30 at and past the
// key count or k_len; online softmax in fp32 with exp2; probabilities cast
// to bf16 for P.V (bf16 mma, fp32 accumulate); the output is acc / sum.
//
// Layout: q8, k8 are [B, L, H, D] int8, v and o [B, L, H, D] bf16, D == 128,
// contiguous; qs [B, H, Lq] and ks [B, H, Lk] fp32.
//
// What bounds it on an H100: at 23,296 tokens (B 2, H 24) Q K^T is
// 6.7e12 int8 operations (3.4 ms at 1,979 TOP/s) and P.V 6.7e12 bf16
// flops (6.7 ms at 989 TFLOP/s), against about 0.5 GB of q/k/v/o: the
// tensor cores bound it. The design is B1's: 4 warps of 16 query rows,
// 64-key tiles of K (int8, rows padded to 144 bytes so the fragment loads
// are conflict free) and V (bf16, ldmatrix.trans) staged in shared memory.
// No wgmma, TMA or warp specialisation yet.

#include "attention_tiles.cuh"

namespace {

using flexam::bf16;
using namespace flexam::attn;

constexpr int kLdsI8 = kD + 16;     // padded smem row of int8 K (bytes)

struct I8Args {
  const int8_t* q;   // [B, Lq, H, D]
  const int8_t* k;   // [B, Lk, H, D]
  const bf16* v;     // [B, Lk, H, D]
  bf16* o;           // [B, Lq, H, D]
  const float* qs;   // [B, H, Lq] scale of each query row
  const float* ks;   // [B, H, Lk] scale of each key
  const int* k_len;  // [B] or null
  int B, H, Lq, Lk;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void mma_16832_s8(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A [kBN, kD] int8 tile (rows n0.., zero past `rows`) into padded shared
// memory, 16 bytes a thread per step.
__device__ __forceinline__ void load_tile_i8(int8_t* dst, const int8_t* src,
                                             int n0, int rows, int row_stride) {
  constexpr int kChunks = kBN * kD / 16;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c >> 3, col = (c & 7) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(n0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLdsI8 + col) = val;
  }
}

// The warp's 16 int8 query rows as m16n8k32 A fragments, 4 k-steps of 32.
__device__ __forceinline__ void load_q_i8(uint32_t qa[4][4], const int8_t* qh,
                                          int row0, int rows, int row_stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int col = ks * 32 + tig * 4;
    const int8_t* pa = qh + (size_t)ra * row_stride + col;
    const int8_t* pb = qh + (size_t)rb * row_stride + col;
    qa[ks][0] = ra < rows ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
    qa[ks][1] = rb < rows ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
    qa[ks][2] = ra < rows ? *reinterpret_cast<const uint32_t*>(pa + 16) : 0u;
    qa[ks][3] = rb < rows ? *reinterpret_cast<const uint32_t*>(pb + 16) : 0u;
  }
}

// B6: one block per (q tile, head, batch); online softmax over key tiles.
__global__ void __launch_bounds__(kThreads) int8_attention_kernel(I8Args a) {
  __shared__ __align__(16) int8_t ks8[kBN * kLdsI8];
  __shared__ __align__(16) bf16 vs[kBN * kLds];
  __shared__ float ksc[kBN];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int stride = a.H * kD;
  const size_t head_q = (size_t)b * a.Lq * stride + h * kD;
  const size_t head_k = (size_t)b * a.Lk * stride + h * kD;
  const float* qs = a.qs + ((size_t)b * a.H + h) * a.Lq;
  const float* ks = a.ks + ((size_t)b * a.H + h) * a.Lk;
  const int row0 = blockIdx.x * kBM + warp * 16;
  const int valid = a.k_len ? min(a.k_len[b], a.Lk) : a.Lk;

  uint32_t qa[4][4];
  load_q_i8(qa, a.q + head_q, row0, a.Lq, stride);
  const float qs0 = row0 + g < a.Lq ? qs[row0 + g] : 0.f;
  const float qs1 = row0 + g + 8 < a.Lq ? qs[row0 + g + 8] : 0.f;

  float acc[16][4];
  zero_acc(acc);
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  for (int n0 = 0; n0 < a.Lk; n0 += kBN) {
    __syncthreads();
    load_tile_i8(ks8, a.k + head_k, n0, a.Lk, stride);
    load_tile(vs, a.v + head_k, n0, a.Lk, stride);
    if (threadIdx.x < kBN)
      ksc[threadIdx.x] = n0 + threadIdx.x < a.Lk ? ks[n0 + threadIdx.x] : 0.f;
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int8_t* kp = ks8 + (j * 8 + g) * kLdsI8 + kk * 32 + tig * 4;
        mma_16832_s8(c, qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                     *reinterpret_cast<const uint32_t*>(kp + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        const float deq = __fmul_rn(__fmul_rn(e < 2 ? qs0 : qs1, ksc[col]),
                                    a.scale_log2);
        s[j][e] = n0 + col < valid ? __fmul_rn(__int2float_rn(c[e]), deq) : kNeg;
      }
    }
    online_softmax(s, acc, m0, m1, l0, l1);
    tile_pv(acc, s, vs);
  }
  store_rows(a.o + head_q, stride, acc, quad_sum(l0), quad_sum(l1), row0, a.Lq);
}

}  // namespace

extern "C" {

// B6. Returns a cudaError_t (0 on a clean launch).
int flexam_int8_attention(const void* q8, const void* k8, const void* v, void* o,
                          const void* qs, const void* ks, const void* k_len,
                          int B, int H, int Lq, int Lk, int D, float scale_log2,
                          void* stream) {
  if (D != kD || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  I8Args a{static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
           static_cast<const bf16*>(v), static_cast<bf16*>(o),
           static_cast<const float*>(qs), static_cast<const float*>(ks),
           static_cast<const int*>(k_len), B, H, Lq, Lk, scale_log2};
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  int8_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
