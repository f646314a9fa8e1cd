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

#include "common.cuh"

namespace {

using flexam::bf16;

constexpr int kD = 128;             // head dim
constexpr int kBM = 64;             // query rows per block
constexpr int kBN = 64;             // keys per tile
constexpr int kWarps = kBM / 16;    // one warp per 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;        // padded smem row (bf16 elements)
constexpr int kMaxSingleKv = 512;   // B2 key limit
constexpr float kNeg = -1e30f;

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

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* k_len;  // [B] or null
  int B, H, Lq, Lk;
  float scale_log2;  // softmax scale * log2(e)
};

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

// The warp's 16 query rows as mma A fragments, 8 k-steps of 16 over D.
__device__ __forceinline__ void load_q(uint32_t qa[8][4], const bf16* qh,
                                       int row0, int Lq, int row_stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int col = ks * 16 + tig * 2;
    const bf16* pa = qh + (size_t)ra * row_stride + col;
    const bf16* pb = qh + (size_t)rb * row_stride + col;
    qa[ks][0] = ra < Lq ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
    qa[ks][1] = rb < Lq ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
    qa[ks][2] = ra < Lq ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
    qa[ks][3] = rb < Lq ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
  }
}

// s = (Q K^T) * scale_log2 for the warp's 16 rows x the tile's 64 keys,
// masked past `valid` keys. s[j] is the mma C fragment of keys n0+8j..+7.
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

// acc += P V over one 64-key tile; p[j] holds probabilities in C layout.
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

__device__ __forceinline__ void store_out(const Args& a, const float acc[16][4],
                                          float l0, float l1, int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int stride = a.H * kD;
  bf16* oh = a.o + (size_t)b * a.Lq * stride + h * kD;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (ra < a.Lq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)ra * stride + col) =
          pack_bf16(acc[nt][0] / l0, acc[nt][1] / l0);
    if (rb < a.Lq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)rb * stride + col) =
          pack_bf16(acc[nt][2] / l1, acc[nt][3] / l1);
  }
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
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  for (int n0 = 0; n0 < a.Lk; n0 += kBN) {
    __syncthreads();
    load_tile(ks, a.k + head_k, n0, a.Lk, stride);
    load_tile(vs, a.v + head_k, n0, a.Lk, stride);
    __syncthreads();

    float s[8][4];
    tile_logits(s, qa, ks, n0, valid, a.scale_log2);
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
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
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
