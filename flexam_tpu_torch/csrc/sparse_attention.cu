// Block-sparse attention for video self-attention: kernel B5 of the port.
//
// Replaces flexam_tpu/ops/sparse_attention.py:_sparse_kernel. The token
// stream is cut into blocks of `blk` tokens (a frame, or `group` merged
// frames, of the DiT's video tokens, and the ref block); query block i
// attends to the key blocks kidx[i, :nnz[i]] only (the policy of
// ops/sparse_attention.py:video_sparse_policy), with exact softmax over
// those keys.
//
// Math, as in the TPU kernel and B1: logits in fp32 from bf16 q.k with
// log2(e) folded into the scale; online softmax in fp32 with exp2 over the
// active blocks in list order; probabilities cast to bf16 for P.V; the
// output is acc / sum.
//
// Layout: q, k, v, o [B, L, H, D] bf16, contiguous, D == 128, L = nq * blk;
// kidx [nq, max_nnz] and nnz [nq] int32 on the device.
//
// Grid: one block per (64-row tile of a query block, head, batch). A block
// walks only its query block's active key blocks, 64 keys at a time, with
// B1's tile code. `blk` is a multiple of 64 at 512x896 (896) but only of 8
// in general, so the last row tile and the last key tile of every block
// are masked by the block's edge (rows past blk are not written, keys past
// blk get the logit -1e30), never by L.
//
// What bounds it on an H100: at 23,296 tokens with the w=2 policy (26
// blocks of 896, 147 active pairs) the work is 4*B*H*pairs*blk^2*D =
// 2.9e12 flops against about 0.6 GB of q/k/v/o: the tensor cores bound it.
// The ref block's row holds every key block, so its tiles run 26 blocks
// while the others run 3 to 5; the grid's many other tiles fill the card
// meanwhile.

#include "attention_tiles.cuh"

namespace {

using flexam::bf16;
using namespace flexam::attn;

struct SparseArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kidx;   // [nq, max_nnz]
  const int* nnz;    // [nq]
  int B, H, L, blk, max_nnz, tiles;  // tiles: 64-row tiles per block
  float scale_log2;  // softmax scale * log2(e)
};

__global__ void __launch_bounds__(kThreads) sparse_attention_kernel(SparseArgs a) {
  __shared__ __align__(16) bf16 ks[kBN * kLds];
  __shared__ __align__(16) bf16 vs[kBN * kLds];
  const int qb = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int stride = a.H * kD;
  const size_t head = (size_t)b * a.L * stride + h * kD;
  const size_t q_off = head + (size_t)qb * a.blk * stride;
  const int row0 = tile * kBM + warp * 16;   // row within the query block

  uint32_t qa[8][4];
  load_q(qa, a.q + q_off, row0, a.blk, stride);

  float acc[16][4];
  zero_acc(acc);
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // l: this thread's share

  const int n = a.nnz[qb];
  for (int jj = 0; jj < n; ++jj) {
    const size_t k_off = head + (size_t)a.kidx[qb * a.max_nnz + jj] * a.blk * stride;
    for (int n0 = 0; n0 < a.blk; n0 += kBN) {
      __syncthreads();
      load_tile(ks, a.k + k_off, n0, a.blk, stride);
      load_tile(vs, a.v + k_off, n0, a.blk, stride);
      __syncthreads();

      float s[8][4];
      tile_logits(s, qa, ks, n0, a.blk, a.scale_log2);
      online_softmax(s, acc, m0, m1, l0, l1);
      tile_pv(acc, s, vs);
    }
  }
  store_rows(a.o + q_off, stride, acc, quad_sum(l0), quad_sum(l1), row0, a.blk);
}

}  // namespace

extern "C" {

// B5. Returns a cudaError_t (0 on a clean launch).
int flexam_sparse_attention(const void* q, const void* k, const void* v, void* o,
                            const void* kidx, const void* nnz, int B, int H,
                            int nq, int blk, int max_nnz, int D, float scale_log2,
                            void* stream) {
  if (D != kD || B <= 0 || H <= 0 || nq <= 0 || blk <= 0 || max_nnz <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (blk + kBM - 1) / kBM;
  SparseArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o),
               static_cast<const int*>(kidx), static_cast<const int*>(nnz),
               B, H, nq * blk, blk, max_nnz, tiles, scale_log2};
  dim3 grid(nq * tiles, H, B);
  sparse_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
