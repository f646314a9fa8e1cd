// Exact softmax attention for the DiT: kernels B1 and B2 of the port.
//
// Replaces flexam_tpu/ops/flash_attention.py:_flash_kernel (B1, the
// online-softmax kernel over key blocks) and :_single_kv_kernel (B2, taken
// when one key block covers every key: cross-attention over 512 text tokens).
//
// Math, as in the TPU kernels: logits in fp32 from bf16 q.k, with log2(e)
// folded into the softmax scale so exp2 replaces exp; masked keys (past the
// key length, or past a per-batch k_len) get the logit -1e30; running max,
// sum and accumulator in fp32; probabilities cast to bf16 before P.V; the
// output is acc / sum, cast to bf16.
//
// Layout: q, k, v and o are [B, L, H, D] bf16, contiguous, D == 128. The
// kernels index that layout directly (no transposes, no padding copies) and
// mask the ragged edge of L themselves.
//
// What bounds it on an H100: at the flagship self-attention shape (B 2,
// H 24, L 11,648) the work is 4*B*H*L*L*D = 3.3e12 flops against about 27 MB
// of q/k/v/o, so the tensor cores bound it. The design is a first, simple
// one: bf16 mma.sync m16n8k16 tiles (fp32 accumulate), 4 warps of 16 query
// rows each (64 rows a block), 64-key tiles of K and V staged in padded
// shared memory (conflict-free fragment loads; V read with ldmatrix.trans).
// No wgmma, TMA, or warp specialisation yet, and loads are not overlapped
// with the math: those are later work.
//
// B2 keeps no online carry: a first pass over K writes each row's fp32
// logits (<= 512 keys) to shared memory, private to the thread that
// computed them, and takes the row max; a second pass over V turns them
// into probabilities and accumulates P.V. K and V stream through in 64-key
// tiles and never sit whole in shared memory.

#include "attention_tiles.cuh"

namespace {

using flexam::bf16;
using namespace flexam::attn;

constexpr int kMaxSingleKv = 512;   // B2 key limit

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* k_len;  // [B] or null
  int B, H, Lq, Lk;
  float scale_log2;  // softmax scale * log2(e)
};

// The head's base offset is formed from int batch / head indices: offsets
// formed from the unsigned blockIdx fields compile B1 into another schedule
// that runs 5 % slower on an H100 (flexam_tpu_torch/tools/attention_ab.py).
__device__ __forceinline__ void store_out(const Args& a, const float acc[16][4],
                                          float l0, float l1, int row0) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int stride = a.H * kD;
  store_rows(a.o + (size_t)b * a.Lq * stride + h * kD, stride, acc, l0, l1,
             row0, a.Lq);
}

// B1: one block per (q tile, head, batch); online softmax over key tiles.
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  __shared__ __align__(16) bf16 ks[kBN * kLds];
  __shared__ __align__(16) bf16 vs[kBN * kLds];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int stride = a.H * kD;
  const size_t head_q = (size_t)b * a.Lq * stride + h * kD;
  const size_t head_k = (size_t)b * a.Lk * stride + h * kD;
  const int row0 = blockIdx.x * kBM + warp * 16;
  const int valid = a.k_len ? min(a.k_len[b], a.Lk) : a.Lk;

  uint32_t qa[8][4];
  load_q(qa, a.q + head_q, row0, a.Lq, stride);

  float acc[16][4];
  zero_acc(acc);
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  for (int n0 = 0; n0 < a.Lk; n0 += kBN) {
    __syncthreads();
    load_tile(ks, a.k + head_k, n0, a.Lk, stride);
    load_tile(vs, a.v + head_k, n0, a.Lk, stride);
    __syncthreads();

    float s[8][4];
    tile_logits(s, qa, ks, n0, valid, a.scale_log2);
    online_softmax(s, acc, m0, m1, l0, l1);
    tile_pv(acc, s, vs);
  }
  store_out(a, acc, quad_sum(l0), quad_sum(l1), row0);
}

// B2: all keys (<= 512) in one block's view; logits kept in shared memory,
// one max and one sum per row, no rescaling of the accumulator.
__global__ void __launch_bounds__(kThreads) single_kv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kv = reinterpret_cast<bf16*>(smem);  // K tiles, then V tiles
  const int n_tiles = (a.Lk + kBN - 1) / kBN;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // thread-private logit store: [warp][8-key group][lane] float4
  float4* lg = reinterpret_cast<float4*>(smem + kBN * kLds * sizeof(bf16)) +
               (size_t)warp * n_tiles * 8 * 32 + lane;
  const int stride = a.H * kD;
  const size_t head_q = (size_t)b * a.Lq * stride + h * kD;
  const size_t head_k = (size_t)b * a.Lk * stride + h * kD;
  const int row0 = blockIdx.x * kBM + warp * 16;
  const int valid = a.k_len ? min(a.k_len[b], a.Lk) : a.Lk;

  uint32_t qa[8][4];
  load_q(qa, a.q + head_q, row0, a.Lq, stride);

  float mx0 = kNeg, mx1 = kNeg;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(kv, a.k + head_k, t * kBN, a.Lk, stride);
    __syncthreads();
    float s[8][4];
    tile_logits(s, qa, kv, t * kBN, valid, a.scale_log2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      lg[(t * 8 + j) * 32] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);

  float acc[16][4];
  zero_acc(acc);
  float l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(kv, a.v + head_k, t * kBN, a.Lk, stride);
    __syncthreads();
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 sv = lg[(t * 8 + j) * 32];
      p[j][0] = exp2f(sv.x - mx0);
      p[j][1] = exp2f(sv.y - mx0);
      p[j][2] = exp2f(sv.z - mx1);
      p[j][3] = exp2f(sv.w - mx1);
      l0 += p[j][0] + p[j][1];
      l1 += p[j][2] + p[j][3];
    }
    tile_pv(acc, p, kv);
  }
  store_out(a, acc, quad_sum(l0), quad_sum(l1), row0);
}

size_t single_kv_smem_bytes(int Lk) {
  const int n_tiles = (Lk + kBN - 1) / kBN;
  return kBN * kLds * sizeof(bf16) + (size_t)kWarps * n_tiles * 8 * 32 * sizeof(float4);
}

}  // namespace

extern "C" {

// B1. Returns a cudaError_t (0 on a clean launch).
int flexam_flash_attention(const void* q, const void* k, const void* v, void* o,
                           const void* k_len, int B, int H, int Lq, int Lk, int D,
                           float scale_log2, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(o),
         static_cast<const int*>(k_len), B, H, Lq, Lk, scale_log2};
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// B2 (Lk <= 512). Returns a cudaError_t.
int flexam_single_kv_attention(const void* q, const void* k, const void* v, void* o,
                               const void* k_len, int B, int H, int Lq, int Lk, int D,
                               float scale_log2, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || Lk > kMaxSingleKv)
    return (int)cudaErrorInvalidValue;
  const size_t smem = single_kv_smem_bytes(Lk);
  cudaError_t err = cudaFuncSetAttribute(
      single_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<bf16*>(o),
         static_cast<const int*>(k_len), B, H, Lq, Lk, scale_log2};
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  single_kv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
