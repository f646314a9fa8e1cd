// SageAttention-style attention with int8 Q K^T: kernel B6 of the port.
//
// Replaces flexam_tpu/ops/int8_attention.py:_int8_flash_kernel. As there,
// the wrapper (ops/int8_attention.py) smooths k by its per-(batch, head)
// mean and quantizes q and k to int8 with one absmax scale per (batch,
// head, block of rows) before the launch; this kernel gets the int8 tensors
// and the scales expanded to one per query row and one per key, so a
// 128-row item or 128-key tile that straddles two quantization blocks
// (1,456 rows at 23,296 tokens is 11.375 tiles) still uses each row's and
// each key's own scale.
//
// Math, as in the TPU kernel: int32 logits from int8 q.k (exact), times
// q_scale[row] * k_scale[key] * (softmax scale * log2 e), masked to -1e30
// at and past k_len; online softmax in fp32 with exp2; probabilities cast
// to v's dtype for P.V (fp32 accumulate); the output is acc / sum in v's
// dtype. The dequantization is reassociated (module note below); keys
// past the key count (TMA's zero fill) do not count at all.
//
// Dtypes of v and o: bf16 (bf16 wgmma) and fp32. The TPU kernel runs an
// fp32 P.V at the default matmul precision, the chip's fast mode; the
// card's counterpart is TF32 wgmma (B1's fp32 instances, flash_attention.cu),
// whatever torch.backends.cuda.matmul.allow_tf32 says: the pre-pass
// (tf32_prep.cuh) writes V^T rounded to tf32, the probabilities are
// rounded in registers. The int8 Q K^T, its dequantization and the softmax
// do not depend on v's dtype.
//
// Layout: q8, k8 are [B, L, H, D] int8, v and o [B, L, H, D], D any
// multiple of 128, contiguous; qs [B, H, Lq] and ks [B, H, Lk] fp32. In
// bf16 D = 128 and 256 run the design below, each its own instance (at
// 256: 64-key tiles, a ring of 3 stages, the accumulator as two 128-column
// halves); in fp32 D = 128 has its own (Int8F32Plan: 64-key tiles); every
// other D runs hopper_wide.cuh's. The products accumulate in s32, exact at
// any D; the magic-number conversion below holds up to D = 256 (the wide
// design converts by I2F).
//
// What bounds it on an H100: at 23,296 tokens (B 2, H 24) Q K^T is
// 6.7e12 int8 operations (3.4 ms at 1,979 TOP/s) and P.V 6.7e12 bf16
// flops (6.7 ms at 989 TFLOP/s), against about 0.5 GB of q/k/v/o: the
// tensor cores bound it (in fp32, P.V's 6.7e12 flops at TF32's 495
// TFLOP/s: 13.5 ms). Beside them, 2.6e10 logits are converted,
// dequantized and exponentiated: exp2 on the quarter-rate SFU is about as
// long as the int8 product, so each logit gets as few full-rate
// instructions as B1's. Measured (PERF.md): with the softmax taken out
// the kernel still takes 0.8 of its time, so what holds it back is the
// wgmma pipeline it shares with B1, not the per-logit work.
//
// Design: B1's (flash_attention.cu), on hopper_attention.cuh.
//  * a persistent CTA on each SM walks items of 128 query rows of one
//    (batch, head), q tiles fastest. The producer warp (its warpgroup at 24
//    registers) loads an item's Q8 (16 KB at D = 128, one TMA box a
//    128-byte span), then each key tile's K8 (16 KB) and V (32 KB; in
//    fp32 64 keys of K8, 8 KB, and of V^T, 32 KB) into a ring of kStages
//    stages; its 32 lanes also write the tile's key factors ks[key] * c
//    into the stage (512 B) and arrive on the K barrier, which TMA's bytes
//    and the 32 lanes complete together.
//  * two consumer warpgroups (240 registers), 64 query rows each: S = Q8 K8^T
//    by 4 s8 wgmma m64n128k32 into an s32 accumulator (both operands K-major
//    from shared memory), issued before P_{t-1} V_{t-1} (B1's bf16 wgmma
//    with V MN-major; in fp32, m64n128k8 tf32 steps with V^T K-major) so
//    the tensor cores run one while the softmax of the other runs.
//  * each logit: an exact int -> float by the magic-number add (IADD, FADD;
//    no I2F), one FMUL by its key's factor, then B1's softmax with the
//    row's q scale folded into its FFMA: exp2(q_scale * (s * ks * c) - m),
//    the max taken on s * ks * c and scaled once (q_scale > 0). This
//    reassociates the plain version's s * ((qs * ks) * c): the logits agree
//    to a few fp32 ulps, far inside check_int8_attention's bound.
//  * the key mask only on the tile that holds the edge (there the row scale
//    is applied before masking); tiles wholly past k_len are not loaded
//    (their probabilities are exactly 0), except when k_len is 0 and every
//    key is masked alike.
//  * the accumulator's rescale is skipped when no row of a warp has a new
//    maximum (its factor is exactly 1);
//  * the epilogue writes acc / sum in v's dtype straight from registers.
//
// Tried on the card and not kept (PERF.md): FA3's ping-pong of the two
// consumer warpgroups, __int2float_rn (I2FP) in place of the
// magic-number add (no faster),
// and clusters of 2 CTAs sharing each K/V tile by TMA multicast (2 %
// faster, L2 traffic is not what bounds it).

#include "hopper_attention.cuh"
#include "hopper_wide.cuh"
#include "tf32_prep.cuh"

namespace {

using flexam::bf16;
using namespace flexam::hopper;

constexpr int kBM = 128;                // query rows a CTA (2 x 64)
constexpr int kThreads = 3 * 128;       // producer + 2 consumer warpgroups
constexpr float kNegInf = -__builtin_huge_valf();  // keys past Lk

// The bf16 instance for head dim kD (128 or 256): keys a tile, ring depth
// and the bytes of its tiles (int8 rows in 128-byte spans, V in 64-column
// spans of 128 bytes); P.V in steps of 16 keys.
template <int kD_>
struct Int8Bf16Plan {
  static constexpr bool kF32 = false;
  static constexpr int kD = kD_;
  static constexpr int kBN = kD == 128 ? 128 : 64;
  static constexpr int kStages = kD == 128 ? 4 : 3;
  static constexpr int kI8Spans = kD / 128;
  static constexpr uint32_t kQSpanBytes = kBM * 128;              // 16 KB
  static constexpr uint32_t kKSpanBytes = kBN * 128;
  static constexpr uint32_t kVSpanBytes = kBN * 128;
  static constexpr uint32_t kQBytes = kI8Spans * kQSpanBytes;
  static constexpr uint32_t kKBytes = kI8Spans * kKSpanBytes;
  static constexpr uint32_t kVTileBytes = kBN * kD * sizeof(bf16);
  static constexpr uint32_t kFacBytes = kBN * sizeof(float);
  static constexpr uint32_t kBarBytes = 8 * (2 + 3 * kStages);
  static constexpr size_t kSmemBytes = 1024 + kQBytes +
                                       (kKBytes + kVTileBytes + kFacBytes) *
                                           kStages +
                                       kBarBytes;
  static constexpr int kPVKeys = 16;
};

// fp32 V at D = 128 (TF32 P.V). A 128-key V^T tile is 64 KB, so the bf16
// plan's 128-key tiles in 4 stages (4 x 80.5 KB) do not fit; nor would
// 128-key tiles in 2 stages leave registers: a tf32 P takes one register a
// probability, so S (64 s32), P (64) and O (64) would pass the consumers'
// 240. 64-key tiles (the D = 256 instance's s8 m64n64k32) hold S, P and O
// in 32 + 32 + 64 registers, as F32Plan's do, and 4 stages fit: Q8 16 KB
// + 4 x (K8 8 KB + V^T [128 columns, 64 keys] 32 KB + 256 B of key
// factors), 177 KB.
struct Int8F32Plan {
  static constexpr bool kF32 = true;
  static constexpr int kD = 128;
  static constexpr int kBN = 64;
  static constexpr int kStages = 4;
  static constexpr int kI8Spans = 1;
  static constexpr uint32_t kQSpanBytes = kBM * 128;
  static constexpr uint32_t kKSpanBytes = kBN * 128;
  static constexpr uint32_t kVtSpanBytes = kD * 128;    // V^T: [128, 32]
  static constexpr uint32_t kQBytes = kQSpanBytes;
  static constexpr uint32_t kKBytes = kKSpanBytes;
  static constexpr uint32_t kVTileBytes = kBN * kD * sizeof(float);
  static constexpr uint32_t kFacBytes = kBN * sizeof(float);
  static constexpr uint32_t kBarBytes = 8 * (2 + 3 * kStages);
  static constexpr size_t kSmemBytes = 1024 + kQBytes +
                                       (kKBytes + kVTileBytes + kFacBytes) *
                                           kStages +
                                       kBarBytes;
  static constexpr int kPVKeys = 8;
};
static_assert(Int8F32Plan::kSmemBytes <= 232448, "fits one CTA an SM");
static_assert(kKeyPad % Int8F32Plan::kBN == 0,
              "V^T's padded keys cover whole key tiles");

struct Params {
  const float* qs;   // [B, H, Lq] scale of each query row
  const float* ks;   // [B, H, Lk] scale of each key
  const int* k_len;  // [B] or null
  void* o;           // [B, Lq, H, D], v's dtype
  int B, H, Lq, Lk;
  float scale_log2;  // softmax scale * log2(e)
};

// The (q tile, head, batch) of work item `wi`, q tiles fastest, and its key
// tiles: up to the last tile holding a key before min(k_len[b], Lk), or
// every tile when that is 0 (all keys masked alike).
struct Work {
  int q0, h, b, valid, n_tiles;
};

template <int kBN>
__device__ __forceinline__ Work work_item(const Params& a, int wi) {
  const int n_qt = (a.Lq + kBM - 1) / kBM;
  Work w;
  w.q0 = (wi % n_qt) * kBM;
  w.h = (wi / n_qt) % a.H;
  w.b = wi / (n_qt * a.H);
  w.valid = a.k_len ? max(0, min(a.k_len[w.b], a.Lk)) : a.Lk;
  w.n_tiles = ((w.valid > 0 ? w.valid : a.Lk) + kBN - 1) / kBN;
  return w;
}

// B6 on the plan S (Int8Bf16Plan<kD>, or Int8F32Plan on the pre-pass's V^T
// workspace, which tv maps).
template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
    int8_attention_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params a) {
  constexpr int kD = S::kD;
  constexpr int kBN = S::kBN, kStages = S::kStages;
  constexpr uint32_t kKBytes = S::kKBytes, kVTileBytes = S::kVTileBytes;
  constexpr uint32_t kFacBytes = S::kFacBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;                // + s * kKBytes
  const uint32_t v_s = k_s + kStages * kKBytes;         // + s * kVTileBytes
  const uint32_t f_s = v_s + kStages * kVTileBytes;     // + s * kFacBytes
  const uint32_t bars = f_s + kStages * kFacBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };
  // the key factors as a generic pointer, for the consumers' float2 reads
  const float* f_gen = reinterpret_cast<const float*>(
      smem + (f_s - smem_u32(smem)));
  const int n_work = (a.Lq + kBM - 1) / kBM * a.H * a.B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 32);     // the producer warp's 32 lanes
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Both roles walk the same work items and count key tiles across them
  // (`it`), which gives each tile's stage and barrier phase.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: warp 0; lane 0 issues the TMA loads
    regs_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0, n = 0;
      for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x, ++n) {
        const Work w = work_item<kBN>(a, wi);
        const float* ks = a.ks + ((size_t)w.b * a.H + w.h) * a.Lk;
        // Q of the next item once both consumers' last Q.K^T has landed
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(q_full, S::kQBytes);
          tma_load_i8_tile<S::kI8Spans, kBM>(q_s, &tq, q_full, w.h, w.q0,
                                             w.b);
        }
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
          // this lane's kBN / 32 keys' factors ks * c (0 past Lk), in one
          // 16- or 8-byte store
          constexpr int kPer = kBN / 32;
          const int key = t * kBN + kPer * lane;
          float f[kPer];
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            f[e] = key + e < a.Lk ? ks[key + e] * a.scale_log2 : 0.f;
          const uint32_t f_dst = f_s + s * kFacBytes + 4 * kPer * lane;
          if (kPer == 4)
            asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                         ::"r"(f_dst), "f"(f[0]), "f"(f[1]),
                           "f"(f[kPer > 2 ? 2 : 0]), "f"(f[kPer > 3 ? 3 : 0])
                         : "memory");
          else
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                         ::"r"(f_dst), "f"(f[0]), "f"(f[1]) : "memory");
          if (lane == 0) {
            mbar_arrive_expect_tx(k_full(s), kKBytes);
            tma_load_i8_tile<S::kI8Spans, kBN>(k_s + s * kKBytes, &tk,
                                               k_full(s), w.h, t * kBN, w.b);
            mbar_arrive_expect_tx(v_full(s), kVTileBytes);
            if constexpr (S::kF32)
              // V^T [B, D, H, Lkp]: the tile's keys as columns, all kD rows
              tma_load_span_tile<kBN / 32, kD, 32>(v_s + s * kVTileBytes,
                                                   &tv, v_full(s), w.h, 0,
                                                   w.b, t * kBN);
            else
              tma_load_bf16_tile<kD / 64, kBN>(v_s + s * kVTileBytes, &tv,
                                               v_full(s), w.h, t * kBN, w.b);
          } else {
            mbar_arrive(k_full(s));
          }
        }
      }
    }
  } else {
    // consumer c: query rows q0 + 64c .. q0 + 64c + 63 of each item
    regs_alloc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int quad = lane & 3;
    const uint32_t q_c = q_s + c * 64 * 128;   // its 64 rows, in each span

    // S = Q8 K8^T over D in D / 32 steps of 32 bytes (4 a 128-byte span),
    // issued
    auto issue_qk = [&](int (&si)[kBN / 2], int stage) {
      const uint32_t ks = k_s + stage * kKBytes;
      wgmma_qk_s8_first(si, sw128_desc(q_c, 16, 1024),
                        sw128_desc(ks, 16, 1024));
#pragma unroll
      for (int k = 1; k < kD / 32; ++k) {
        const uint32_t col = (k & 3) * 32;
        wgmma_qk_s8(si, sw128_desc(q_c + (k >> 2) * S::kQSpanBytes + col, 16,
                                   1024),
                    sw128_desc(ks + (k >> 2) * S::kKSpanBytes + col, 16, 1024));
      }
      wgmma_commit();
    };
    // O += P V over a tile's keys in steps of kPVKeys, issued. bf16: a
    // wgmma for every 128 columns of D; V is [keys, D] with D contiguous,
    // MN-major, the 64-column spans kVSpanBytes apart. fp32: V^T is [D,
    // keys] with keys contiguous, K-major, the 32-key spans kVtSpanBytes
    // apart.
    auto issue_pv = [&](float (&o)[kD / 128][64],
                        uint32_t (&p)[kBN / S::kPVKeys][4], int stage) {
      const uint32_t vs = v_s + stage * kVTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / S::kPVKeys; ++kk) {
        if constexpr (S::kF32) {
          wgmma_m64n128k8_tf32_rs(
              o[0], p[kk],
              sw128_desc(vs + (kk >> 2) * S::kVtSpanBytes + (kk & 3) * 32, 16,
                         1024));
        } else {
#pragma unroll
          for (int h = 0; h < kD / 128; ++h)
            wgmma_m64n128k16_rs_tb(
                o[h], p[kk],
                sw128_desc(vs + 2 * h * S::kVSpanBytes + kk * 16 * 128,
                           S::kVSpanBytes, 1024));
        }
      }
      wgmma_commit();
    };
    // the probabilities as P.V's A fragments (bf16, or tf32 rounded): the
    // s32 accumulator has the fp32 one's fragment layout, so the keys sit
    // where probs_to_a_tf32 and the pre-pass's V^T order expect them
    auto to_a = [&](const float (&sc)[kBN / 2],
                    uint32_t (&p)[kBN / S::kPVKeys][4]) {
      if constexpr (S::kF32)
        probs_to_a_tf32(sc, p);
      else
        probs_to_a(sc, p);
    };

    float o[kD / 128][64], sc[kBN / 2];
    int si[kBN / 2];
    uint32_t p[kBN / S::kPVKeys][4];
    float m_a, m_b, l_a, l_b, al_a, al_b, sum_a, sum_b;
    int it = 0, n = 0;
    for (int wi = blockIdx.x; wi < n_work; wi += gridDim.x, ++n) {
      const Work w = work_item<kBN>(a, wi);
      const int r_a = w.q0 + 64 * c + warp * 16 + (lane >> 2), r_b = r_a + 8;
      const float* qs = a.qs + ((size_t)w.b * a.H + w.h) * a.Lq;
      // rows past Lq are zeros from TMA and are not stored
      const float qs_a = r_a < a.Lq ? qs[r_a] : 1.f;
      const float qs_b = r_b < a.Lq ? qs[r_b] : 1.f;
#pragma unroll
      for (int h = 0; h < kD / 128; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
      m_a = m_b = kNeg;

      // Probabilities of key tile t (stage `stage`) in sc, from si. Each
      // logit is s * (ks * c), the row scale going into the softmax's
      // FFMA; on the tile holding the key edge it is applied first and
      // keys past k_len get -1e30, keys past Lk do not count at all.
      auto tile_probs = [&](int t, int stage) {
        const float* f = f_gen + stage * kBN + 2 * quad;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 fk = *reinterpret_cast<const float2*>(f + 8 * j);
          sc[4 * j] = s32_to_f32_small(si[4 * j]) * fk.x;
          sc[4 * j + 1] = s32_to_f32_small(si[4 * j + 1]) * fk.y;
          sc[4 * j + 2] = s32_to_f32_small(si[4 * j + 2]) * fk.x;
          sc[4 * j + 3] = s32_to_f32_small(si[4 * j + 3]) * fk.y;
        }
        const int n0 = t * kBN;
        float sa = qs_a, sb = qs_b;
        if (n0 + kBN > w.valid) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            const int key = n0 + 8 * (i >> 2) + 2 * quad + (i & 1);
            sc[i] = key < w.valid ? sc[i] * ((i & 2) ? sb : sa)
                                  : (key < a.Lk ? kNeg : kNegInf);
          }
          sa = sb = 1.f;
        }
        softmax_tile_rows(sc, sa, sb, m_a, m_b, al_a, al_b, sum_a, sum_b);
      };

      // Tile 0 alone; then, for each next tile t, Q K_t^T is issued before
      // P_{t-1} V_{t-1} (B1's schedule).
      mbar_wait(q_full, n & 1);
      mbar_wait(k_full(it % kStages), (it / kStages) & 1);
      wgmma_fence();
      issue_qk(si, it % kStages);
      wgmma_wait<0>();
      fence_regs(si);
      if (w.n_tiles == 1) mbar_arrive(q_empty);
      tile_probs(0, it % kStages);
      l_a = sum_a;
      l_b = sum_b;
      to_a(sc, p);
      for (int t = 1; t < w.n_tiles; ++t) {
        const int cur = it + t, prev = cur - 1;
        mbar_wait(k_full(cur % kStages), (cur / kStages) & 1);
        mbar_wait(v_full(prev % kStages), (prev / kStages) & 1);
        wgmma_fence();
        issue_qk(si, cur % kStages);
        issue_pv(o, p, prev % kStages);
        wgmma_wait<1>();
        fence_regs(si);
        if (t == w.n_tiles - 1) mbar_arrive(q_empty);
        tile_probs(t, cur % kStages);
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
        fence_regs(p);
        mbar_arrive(empty(prev % kStages));
        // a factor of exactly 1 for every row of the warp (no new maximum)
        // leaves the accumulator as it is
        if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
          for (int h = 0; h < kD / 128; ++h) rescale_rows(o[h], al_a, al_b);
        }
        l_a = l_a * al_a + sum_a;
        l_b = l_b * al_b + sum_b;
        to_a(sc, p);
      }
      const int last = it + w.n_tiles - 1;
      mbar_wait(v_full(last % kStages), (last / kStages) & 1);
      wgmma_fence();
      issue_pv(o, p, last % kStages);
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
      mbar_arrive(empty(last % kStages));
      it += w.n_tiles;

      // acc / sum in v's dtype, straight from registers to [B, Lq, H, D]:
      // a quad writes 16 (bf16) or 32 (fp32) contiguous bytes of a row;
      // rows at or past Lq are not written
      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      const size_t off = (size_t)w.b * a.Lq * a.H * kD + w.h * kD + 2 * quad;
      const size_t stride = (size_t)a.H * kD;
#pragma unroll
      for (int h = 0; h < kD / 128; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const size_t col = off + 128 * h + 8 * j;
          if constexpr (S::kF32) {
            float* base = static_cast<float*>(a.o) + col;
            if (r_a < a.Lq)
              *reinterpret_cast<float2*>(base + r_a * stride) =
                  make_float2(o[h][4 * j] / l_a, o[h][4 * j + 1] / l_a);
            if (r_b < a.Lq)
              *reinterpret_cast<float2*>(base + r_b * stride) =
                  make_float2(o[h][4 * j + 2] / l_b, o[h][4 * j + 3] / l_b);
          } else {
            bf16* base = static_cast<bf16*>(a.o) + col;
            if (r_a < a.Lq)
              *reinterpret_cast<uint32_t*>(base + r_a * stride) =
                  pack_bf16(o[h][4 * j] / l_a, o[h][4 * j + 1] / l_a);
            if (r_b < a.Lq)
              *reinterpret_cast<uint32_t*>(base + r_b * stride) =
                  pack_bf16(o[h][4 * j + 2] / l_b, o[h][4 * j + 3] / l_b);
          }
        }
    }
  }
}

// B6 at the head dims the plans above do not take (hopper_wide.cuh): bf16
// from 384 on, fp32 from 256 on.
template <bool kF32>
__global__ void __launch_bounds__(wide::kThreads, 1)
    int8_attention_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const wide::Params a) {
  wide::wide_cta<wide::kInt8, 0, kF32>(&tq, &tk, &tv, a);
}

// Launch B6 on plan S over q8, k8 and v (bf16), or the V^T workspace with
// Lkp keys (Int8F32Plan).
template <typename S>
int launch(const void* q8, const void* k8, const void* v, void* o,
           const void* qs, const void* ks, const void* k_len, int B, int H,
           int Lq, int Lk, float scale_log2, void* stream, int Lkp = 0) {
  constexpr int kD = S::kD;
  constexpr size_t kSmemBytes = S::kSmemBytes;
  CUtensorMap tq, tk, tv;
  if (!make_bl_hd_map_i8(&tq, q8, B, Lq, H, kD, kBM) ||
      !make_bl_hd_map_i8(&tk, k8, B, Lk, H, kD, S::kBN) ||
      !(S::kF32 ? make_bl_hd_map_f32(&tv, v, B, kD, H, Lkp, 64)
                : make_bl_hd_map(&tv, v, B, Lk, H, kD, 64)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_attention_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const Params a{static_cast<const float*>(qs), static_cast<const float*>(ks),
                 static_cast<const int*>(k_len), o, B, H, Lq, Lk, scale_log2};
  const long long n_work = (long long)((Lq + kBM - 1) / kBM) * H * B;
  const int grid = (int)(n_work < sms ? n_work : sms);
  int8_attention_kernel<S><<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(tq, tk, tv,
                                                                  a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lk, int D, const void* o) {
  return D <= 0 || D % 128 || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 ||
         reinterpret_cast<uintptr_t>(o) % 16;
}

wide::Params wide_params(const void* qs, const void* ks, const void* k_len,
                         void* o, int B, int H, int Lq, int Lk, int D,
                         float scale_log2) {
  wide::Params a{};
  a.k_len = static_cast<const int*>(k_len);
  a.qs = static_cast<const float*>(qs);
  a.ks = static_cast<const float*>(ks);
  a.o = o;
  a.B = B;
  a.H = H;
  a.D = D;
  a.Lq = Lq;
  a.Lk = Lk;
  a.scale_log2 = scale_log2;
  return a;
}

}  // namespace

extern "C" {

// B6 with bf16 v and o. Returns a cudaError_t (0 on a clean launch);
// cudaErrorInvalidValue for a D that is not a positive multiple of 128.
int flexam_int8_attention(const void* q8, const void* k8, const void* v, void* o,
                          const void* qs, const void* ks, const void* k_len,
                          int B, int H, int Lq, int Lk, int D, float scale_log2,
                          void* stream) {
  if (bad_shape(B, H, Lq, Lk, D, o)) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return launch<Int8Bf16Plan<128>>(q8, k8, v, o, qs, ks, k_len, B, H, Lq,
                                     Lk, scale_log2, stream);
  if (D == 256)
    return launch<Int8Bf16Plan<256>>(q8, k8, v, o, qs, ks, k_len, B, H, Lq,
                                     Lk, scale_log2, stream);
  return wide::launch<wide::kInt8>(
      int8_attention_wide_kernel<false>, q8, k8, v,
      wide_params(qs, ks, k_len, o, B, H, Lq, Lk, D, scale_log2), stream);
}

// B6 with fp32 v and o (TF32 P.V): the pre-pass (tf32_prep.cuh) writes V^T
// into vt (B * D * H * Lkp floats, Lkp = Lk rounded up to 64; v and vt
// 16-byte aligned), then Int8F32Plan at D = 128 or the wide design's fp32
// int8 mode above it. Returns a cudaError_t.
int flexam_int8_attention_f32(const void* q8, const void* k8, const void* v,
                              void* vt, void* o, const void* qs,
                              const void* ks, const void* k_len, int B, int H,
                              int Lq, int Lk, int D, float scale_log2,
                              void* stream) {
  if (bad_shape(B, H, Lq, Lk, D, o) || (long long)B * H > 65535 ||
      misaligned16(v, vt))
    return (int)cudaErrorInvalidValue;
  const int Lkp = padded_keys(Lk);
  transpose_v_async(v, vt, B, H, Lk, D, Lkp,
                    static_cast<cudaStream_t>(stream));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (D == 128)
    return launch<Int8F32Plan>(q8, k8, vt, o, qs, ks, k_len, B, H, Lq, Lk,
                               scale_log2, stream, Lkp);
  return wide::launch<wide::kInt8, true>(
      int8_attention_wide_kernel<true>, q8, k8, vt,
      wide_params(qs, ks, k_len, o, B, H, Lq, Lk, D, scale_log2), stream,
      Lkp);
}

// Dynamic shared memory a B6 CTA takes at head dim 128 (bf16 v), in bytes.
int flexam_int8_attention_smem_bytes() {
  return (int)Int8Bf16Plan<128>::kSmemBytes;
}

}  // extern "C"
