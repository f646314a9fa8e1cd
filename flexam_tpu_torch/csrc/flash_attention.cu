// Exact softmax attention for the DiT: kernels B1 and B2 of the port.
//
// Replaces flexam_tpu/ops/flash_attention.py:_flash_kernel (B1, the
// online-softmax kernel over key blocks) and :_single_kv_kernel (B2, taken
// when one key block covers every key: cross-attention over 512 text tokens).
//
// Math, as in the TPU kernels: logits in fp32 from q.k, with log2(e)
// folded into the softmax scale so exp2 replaces exp; keys at or past
// min(k_len[b], Lk) get the logit -1e30; running max, sum and accumulator in
// fp32; probabilities cast to the input's dtype before P.V; the output is
// acc / sum in the input's dtype.
//
// Dtypes: bf16 (bf16 wgmma) and fp32. The TPU kernels run fp32 operands at
// the default matmul precision, the chip's fast mode; the card's
// counterpart is TF32 wgmma, which the fp32 instances use whatever
// torch.backends.cuda.matmul.allow_tf32 says. Every tf32 operand is rounded
// to nearest first: a pre-pass (tf32_prep.cuh, shared with B5 and B6)
// writes Q and K rounded and V^T
// rounded (tf32 wgmma takes no transposed operand, so P.V reads V^T
// K-major) into workspaces the wrapper allocates, and the probabilities
// are rounded in registers. The pre-pass reads Q, K and V once and writes
// them once more: about 0.17 ms of HBM time at the flagship shape. B2 at
// D = 128 rounds Q in shared memory instead (below): its q is 286 MB at the
// flagship shape, its k and v 512 keys.
//
// Layout: q, k, v and o are [B, L, H, D], contiguous, D any multiple of
// 128. The kernels read q, k and v (bf16), or their rounded copies (fp32),
// through 4-D TMA tensor maps over (D, H, L, B): rows past L read as zeros,
// so the ragged edge of L never touches the next batch. D = 128 and 256 run
// the design below in bf16, each its own instance, and D = 128 in fp32
// (F32Plan, F32SplitPlan for B2); every other D runs hopper_wide.cuh's
// (slabs of 128 output columns, S recomputed for each).
//
// What bounds it on an H100: at the flagship self-attention shape (B 2,
// H 24, L 11,648) the work is 4*B*H*L*L*D = 3.3e12 flops against about 27 MB
// of q/k/v/o, so the tensor cores bound it (3.4 ms at 989 TFLOP/s); B2 at
// 512 keys is 1.5e11 flops, also bound by the tensor cores (0.15 ms).
//
// Design (Hopper, sm_90a), in hopper_attention.cuh's primitives:
//  * a persistent CTA on each SM walks work items of 128 query rows of one
//    (batch, head), q tiles fastest. It has three warpgroups. The producer
//    warpgroup gives up registers (setmaxnreg.dec to 24) and one of its
//    threads keeps TMA loads in flight: an item's Q, then its key tiles of
//    K and V into rings of kStages stages that run on across items
//    (separate full barriers for K and V, so Q.K^T starts before V lands;
//    the bf16 plans give K and V empty barriers of their own, below; fp32
//    B1 one a stage, released by all 256 consumer threads after their
//    P.V).
//    The next item's Q loads as soon as both consumers' last
//    Q.K^T of the current one has landed, so its load overlaps their last
//    P.V and epilogue.
//  * two consumer warpgroups (setmaxnreg.inc to 240), 64 query rows each:
//    S = Q K^T by wgmma m64n128k16 with Q and K from shared memory (both
//    K-major, 128-byte swizzle); the online softmax on the fp32 accumulator
//    (exp2 by the SFU, the scale folded into one FFMA); the probabilities
//    packed in registers straight into the bf16 A fragments of O += P V, a
//    wgmma whose B is V read MN-major (transposed). Q K_t^T is issued
//    before P_{t-1} V_{t-1} (FA3's intra-warpgroup overlap), so the tensor
//    cores have the next product while the softmax runs.
//  * the key mask is applied only on the tile that holds the key edge;
//    tiles wholly past k_len are not loaded (their probabilities are exactly
//    0), except when k_len is 0 and every key is masked alike.
//  * the epilogue writes acc / sum straight from registers (rows past Lq
//    are not written), or stages it for TMA stores (below).
//
// B2 is B1's kernel with at most 512 keys, a bound known at compile time:
// an online softmax over <= 4 tiles (8 at D = 256 and in fp32), rather
// than one max per row from a first pass and the logits recomputed in a
// second (1.5x the flops) or kept in shared memory (148 KB a block at 512
// keys, one block an SM).
//
// At D = 256 (D256Plan, hopper_attention.cuh) a 128 x 256 bf16 tile is
// 64 KB, so a ring holds 2 stages of narrower tiles beside Q's 64 KB. Two
// things held the first design (64-key tiles, one empty barrier a stage)
// to 0.54 of its bound:
//  * with FA3's overlap an iteration holds two stages, K_t for Q K_t^T and
//    V_{t-1} for P_{t-1} V_{t-1}; with a shared empty barrier and 2 stages
//    K_{t+1} could not load until P_t V_t had landed, so each tile waited
//    out most of a load. K and V now have empty barriers of their own: a
//    consumer frees K_t's slot as soon as Q K_t^T has landed and V_t's
//    after P_t V_t, and the producer issues K_g, then V_{g-1}, each in the
//    order its slot frees, across items too (an item's K_0 before the last
//    V of the item before it, its Q after).
//  * Q K^T reads both operands from shared memory: over 64 keys a k16 step
//    reads 4 KB for 32 clocks of math, all of the SM's 128 bytes a clock.
//    B1 takes 80-key tiles (m64n80k16: 4.5 KB per 40 clocks), FA3's choice
//    at this head dim: Q 64 KB + 2 x (K 40 KB + V 40 KB) = 224 KB, S 40
//    and P 20 registers beside the 128 of a consumer's 64 x 256 fp32
//    accumulator, which it holds as two 128-column halves that each P.V
//    k-step updates by one m64n128k16 wgmma.
//  * B2's items are 8 tiles of 64 keys (at 80 keys, 6.4 tiles, it ran no
//    faster), and its time over 64 to 512 keys showed a fixed cost of
//    about 11 us an item: the epilogue's plain stores, 4 bytes a lane,
//    each warp instruction 16 bytes of 8 rows. B2 writes each 128-column
//    half of O into 16 KB of shared memory a consumer (swizzled as TMA
//    reads it; 64-key tiles leave the room) and out by two TMA stores of
//    whole 128-byte rows, which clip rows past Lq (kStageO): about 7 us.
//    A second Q buffer (on 48-key tiles, for room) did not move it.
//  * the epilogue multiplies by 1 / sum (a division a row, not an element).
//
// B2 at D = 128 takes the same three measures (SplitPlan<128, ...>): its
// items are at most 4 tiles of 128 keys, and they waited on the plain
// stores of the epilogue as B2-256's did. Bf16Plan<128>'s 3 stages of
// 128-key K and V fill 230,488 bytes, so the split ring takes 2 stages of
// 128-key tiles (192 KB with Q and the staged O). 3 stages of 64-key tiles
// (160 KB) ran 14 % slower: an m64n64k16 Q K^T step reads 4 KB of shared
// memory per 32 clocks of math, all the SM's 128 bytes a clock.
//
// B1 at D = 128 in bf16 runs B2's plan, SplitPlan<128, 128, 2, true>, and
// adds three measures of its own, each with its switch in B1Measures128
// (every other instance takes none, NoMeasures). At the flagship shape the
// split ring and staged O alone ran 1-2 % behind the 3-stage ring with one
// empty barrier a stage that B1 had; 96-key tiles (3 stages) ran 7 %
// slower, and 160- to 192-key tiles spilled (PERF.md §6 has each variant).
// So:
//  * ping-pong (kPingPong): the consumers take turns issuing their
//    products (named barriers 3 and 4), so one's Q.K^T and P.V run on the
//    tensor cores while the other runs its softmax (FA3's warpgroup
//    schedule);
//  * one release a warp (kLaneRelease): one lane of each consumer warp
//    releases Q and the K / V slots (the empty barriers count 8 arrivals,
//    not 256);
//  * the tail split (kTailSplit; it also runs on Bf16Plan<128>). One CTA
//    an SM walks the items of a launch in rounds; the last round holds
//    n_work % sms of them, and FLUX's 432 items on 132 SMs leave 36 CTAs
//    busy in the fourth. When that tail is at most half a round, the
//    wrapper (ops/flash_attention.py tail_split) asks for each tail item
//    in s = min(sms / tail, key tiles) parts of contiguous key tiles, one
//    unit each, after the whole items. A part writes its unnormalised fp32
//    O, row maxima (log2 domain) and sums to a slot of a workspace the
//    wrapper keeps per stream, fences, and adds one to its item's counter;
//    the consumer whose add brings it to s merges every part in part order
//    (the output does not depend on which CTA finishes last),
//    O = sum 2^(m_p - m) O_p / sum 2^(m_p - m) l_p, stores O through the
//    usual epilogue and zeroes the counter, so the workspace needs no
//    clearing between launches. A part with no key tile (k_len short of
//    its range) writes nothing and is left out; with k_len 0 every part
//    masks its keys alike, so the merge gives the mean of V over all Lk
//    keys as the whole item would.
// At the flagship shape the card sits at its power limit and lowers its
// clock for this kernel as for the old one and SDPA, so these gain most
// on short launches (FLUX's), little on the flagship's.
//
// B2 in fp32 (F32SplitPlan) takes B2's measures too: split K / V^T rings of
// F32Plan's tiles and O staged in 16 KB a consumer, 64 fp32 columns a
// round (two rounds). It reads q as the caller gave it: after an item's Q
// lands each consumer rounds its 64 rows to tf32 in shared memory, in place
// (round_tf32_shared, the pre-pass's bits), fences them into the async
// proxy and meets its warpgroup at a named barrier before its first wgmma.
// The pre-pass then reads and writes only k and V^T: with q's pass B2's
// bytes alone (4 x 286 MB at the flagship shape) bound it above its
// operations.
//
// fp32 at D = 128 runs F32Plan (hopper_attention.cuh): Q 64 KB, 64-key K
// tiles and 64-key V^T tiles of 32 KB in a ring of 2 stages; S over 64
// keys by wgmma m64n64k8 (tf32), P.V by m64n128k8 with P from registers
// (probs_to_a_tf32) and V^T's [128 columns, 8 keys] from shared memory.

#include "hopper_attention.cuh"
#include "hopper_wide.cuh"
#include "tf32_prep.cuh"

namespace {

using flexam::bf16;
using namespace flexam::hopper;

constexpr int kBM = 128;                // query rows a CTA (2 x 64)
constexpr int kThreads = 3 * 128;       // producer + 2 consumer warpgroups
constexpr int kMaxKeysB2 = 512;         // B2: <= 512 keys
constexpr float kNegInf = -__builtin_huge_valf();  // keys past Lk
constexpr int kBoxRows = 64;            // TMA box: 64 rows x 128 bytes

// B1 and B2 at head dim 256: split K / V rings (D256Plan), 80-key tiles for
// B1, 64-key tiles and O staged for TMA stores for B2; B1 and B2 at head dim
// 128 in bf16, B2 in fp32: split rings and O staged, fp32 rounding Q itself
// (see the notes above).
using B1Plan128 = SplitPlan<128, 128, 2, true>;   // B2's plan, see above
using B1Plan256 = D256Plan<80>;
using B2Plan256 = D256Plan<64, true>;
using B2Plan128 = SplitPlan<128, 128, 2, true>;
using B2PlanF32 = F32SplitPlan;

// The measures an instance takes beside its plan (see the notes above):
// B1 at head dim 128 in bf16 all three, every other instance none.
struct NoMeasures {
  static constexpr bool kPingPong = false, kLaneRelease = false,
                        kTailSplit = false;
};
struct B1Measures128 {
  static constexpr bool kPingPong = true;     // consumers take turns issuing
  static constexpr bool kLaneRelease = true;  // one lane a warp releases
  static constexpr bool kTailSplit = true;    // the last round split by keys
};

struct Params {
  const int* k_len;  // [B] or null
  void* o;           // [B, Lq, H, D], bf16 or fp32
  int B, H, Lq, Lk;
  float scale_log2;  // softmax scale * log2(e)
  // B1 at head dim 128 (kTailSplit): the last `tail` work items run as `parts`
  // units each (see the note on the tail split); ws holds a slot a unit,
  // counters two words a tail item
  float* ws;
  int* counters;
  int tail, parts;
};

// The tail split's workspace: a slot for each (tail item, part), each
// consumer's half of it its 64 rows of unnormalised fp32 O in fragment
// order (64 floats a thread) and each row's max (log2 domain) and sum;
// then two counters a tail item, `sms` slots and 2 * sms counters in all
// (flexam_b1_split_workspace_bytes).
constexpr int kHalfFloats = 64 * 128 + 2 * 64;
constexpr int kSlotFloats = 2 * kHalfFloats;

static_assert(kKeyPad % F32Plan::kBN == 0 && kKeyPad % wide::kKeys == 0,
              "V^T's padded keys cover whole key tiles");

// The (q tile, head, batch) of work item `wi`, q tiles fastest, so the CTAs
// running at one time share heads (and their K/V in L2); and its key
// tiles: up to the last tile holding a key before min(k_len[b], Lk), or
// every tile when that is 0 (all keys masked alike).
struct Work {
  int q0, h, b, valid, n_tiles;
};

template <int kBN, int kMaxTiles>
__device__ __forceinline__ Work work_item(const Params& a, int wi) {
  const int n_qt = (a.Lq + kBM - 1) / kBM;
  Work w;
  w.q0 = (wi % n_qt) * kBM;
  w.h = (wi / n_qt) % a.H;
  w.b = wi / (n_qt * a.H);
  w.valid = a.k_len ? max(0, min(a.k_len[w.b], a.Lk)) : a.Lk;
  w.n_tiles = ((w.valid > 0 ? w.valid : a.Lk) + kBN - 1) / kBN;
  if (kMaxTiles > 0) w.n_tiles = min(w.n_tiles, kMaxTiles);
  return w;
}

// A unit of a CTA's walk: a whole work item, or (kTailSplit) part `part` of
// one of the last a.tail items, which takes its key tiles
// [part * n / parts, (part + 1) * n / parts) of the item's n. Units run
// whole items first (n_whole of them), then the tail items' parts, item by
// item; `slot` numbers the parts (-1 for a whole item).
struct Unit {
  Work w;
  int t0, t1, part, slot;
};

template <int kBN, int kMaxTiles, bool kTail>
__device__ __forceinline__ Unit unit_at(const Params& a, int u, int n_whole) {
  Unit x;
  if (kTail && u >= n_whole) {
    x.slot = u - n_whole;
    x.part = x.slot % a.parts;
    x.w = work_item<kBN, kMaxTiles>(a, n_whole + x.slot / a.parts);
    x.t0 = x.part * x.w.n_tiles / a.parts;
    x.t1 = (x.part + 1) * x.w.n_tiles / a.parts;
  } else {
    x.w = work_item<kBN, kMaxTiles>(a, u);
    x.t0 = 0;
    x.t1 = x.w.n_tiles;
    x.part = 0;
    x.slot = -1;
  }
  return x;
}

// One CTA of B1 / B2 on the plan S (SplitPlan, Bf16Plan, F32Plan or
// F32SplitPlan) with the measures M (NoMeasures or B1Measures128). In
// fp32, tv maps the V^T workspace.
template <typename S, int kMaxKeys, typename M = NoMeasures>
__device__ __forceinline__ void attention_cta(const CUtensorMap* tq,
                                              const CUtensorMap* tk,
                                              const CUtensorMap* tv,
                                              const CUtensorMap* to,
                                              const Params& a) {
  static_assert(!M::kTailSplit || (S::kD == 128 && !S::kF32),
                "the tail split runs on bf16 plans at 128");
  constexpr int kD = S::kD;
  constexpr int kBN = S::kBN, kStages = S::kStages, kSpans = S::kSpans;
  constexpr int kMaxTiles = (kMaxKeys + kBN - 1) / kBN;
  constexpr uint32_t kKVBytes = S::kKVBytes;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;                      // + s * kKVBytes
  const uint32_t v_s = k_s + kStages * kKVBytes;
  const uint32_t o_s = v_s + kStages * kKVBytes;          // kStageO: O halves
  const uint32_t bars = o_s + S::kOStageBytes;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  // the stage's empty barrier: K's and V's alike, or V's alone in the
  // split ring, whose K slots have their own (k_empty)
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 3 * kStages + s); };
  // the releases of Q and of a K or V slot: every consumer thread, or
  // (kLaneRelease) one lane of each consumer warp
  constexpr uint32_t kConsumerArrivals = M::kLaneRelease ? 2 * 4 : 2 * 128;
  constexpr bool kTail = M::kTailSplit;
  const int n_work = (a.Lq + kBM - 1) / kBM * a.H * a.B;
  // whole items, then the tail's parts
  const int n_whole = kTail ? n_work - a.tail : n_work;
  const int n_units = kTail ? n_whole + a.tail * a.parts : n_work;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerArrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumerArrivals);
      if constexpr (S::kSplitRing) mbar_init(k_empty(s), kConsumerArrivals);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Both roles walk the same work items and count key tiles across them
  // (`it`), which gives each tile's stage and barrier phase.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer
    regs_dealloc<24>();
    if constexpr (S::kSplitRing) {
      // Split ring: each load goes out in the order its slot frees. K of
      // global tile g waits for K of g - kStages, whose Q.K^T lands halfway
      // through iteration g - kStages; V of g for V of g - kStages, whose
      // P.V lands at the end of iteration g - kStages + 1. So the order is
      // K of g, then V of g - 1, across items too: an item's K_0 goes out
      // before the last V of the item before it, and its Q (which waits for
      // that item's last Q.K^T) after.
      if (threadIdx.x == 0) {
        // K (v false) or V (v true) of global tile g into its stage, once
        // the tile kStages before it has left the slot
        auto load = [&](bool v, int g, int h, int row0, int b) {
          const int s = g % kStages;
          if (g >= kStages)
            mbar_wait(v ? empty(s) : k_empty(s), (g / kStages - 1) & 1);
          const uint32_t full = v ? v_full(s) : k_full(s);
          mbar_arrive_expect_tx(full, kKVBytes);
          if constexpr (S::kF32) {
            // V^T [B, D, H, Lkp]: the tile's keys as columns, all kD rows
            if (v)
              tma_load_span_tile<kBN / 32, kD, 32>(v_s + s * kKVBytes, tv,
                                                   full, h, 0, b, row0);
            else
              tma_load_span_tile<kSpans, kBN, 32, S::kKVBox>(
                  k_s + s * kKVBytes, tk, full, h, row0, b);
          } else {
            tma_load_span_tile<kSpans, kBN, 64, S::kKVBox>(
                (v ? v_s : k_s) + s * kKVBytes, v ? tv : tk, full, h, row0,
                b);
          }
        };
        // n counts the units that load a Q (a part with no key tiles
        // loads nothing and takes its count back)
        int it = 0, n = 0, vh = -1, vrow = 0, vb = 0;   // V of tile it - 1
        for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++n) {
          const Unit x = unit_at<kBN, kMaxTiles, kTail>(a, u, n_whole);
          const Work w = x.w;
          if (kTail && x.t1 == x.t0) --n;
          for (int t = x.t0; t < x.t1; ++t, ++it) {
            load(false, it, w.h, t * kBN, w.b);
            if (vh >= 0) load(true, it - 1, vh, vrow, vb);
            vh = w.h;
            vrow = t * kBN;
            vb = w.b;
            if (t == x.t0) {
              if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
              mbar_arrive_expect_tx(q_full, S::kQBytes);
              tma_load_span_tile<kSpans, kBM, S::kCols>(q_s, tq, q_full, w.h,
                                                        w.q0, w.b);
            }
          }
        }
        if (vh >= 0) load(true, it - 1, vh, vrow, vb);
      }
    } else if (threadIdx.x == 0) {
      int it = 0, n = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++n) {
        const Unit x = unit_at<kBN, kMaxTiles, kTail>(a, u, n_whole);
        const Work w = x.w;
        if (kTail && x.t1 == x.t0) {
          --n;                                  // it loads no Q
          continue;
        }
        // Q of the next item once both consumers' last Q.K^T has landed
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_arrive_expect_tx(q_full, S::kQBytes);
        tma_load_span_tile<kSpans, kBM, S::kCols>(q_s, tq, q_full, w.h, w.q0,
                                                  w.b);
        for (int t = x.t0; t < x.t1; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
          mbar_arrive_expect_tx(k_full(s), kKVBytes);
          tma_load_span_tile<kSpans, kBN, S::kCols>(
              k_s + s * kKVBytes, tk, k_full(s), w.h, t * kBN, w.b);
          mbar_arrive_expect_tx(v_full(s), kKVBytes);
          if constexpr (S::kF32)
            // V^T [B, D, H, Lkp]: the tile's keys as columns, all kD rows
            tma_load_span_tile<kBN / 32, kD, 32>(v_s + s * kKVBytes, tv,
                                                 v_full(s), w.h, 0, w.b,
                                                 t * kBN);
          else
            tma_load_span_tile<kSpans, kBN, 64>(v_s + s * kKVBytes, tv,
                                                v_full(s), w.h, t * kBN, w.b);
        }
      }
    }
  } else {
    // consumer c: query rows q0 + 64c .. q0 + 64c + 63 of each item
    regs_alloc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int quad = lane & 3;
    const uint32_t q_c = q_s + c * 64 * 128;   // its rows, in each span
    // The descriptor of an operand `off` bytes past `base`. The split-ring
    // plans add the offset to the base's descriptor, one a product: at 256
    // S, P and O leave no room for a descriptor a k-step held across the
    // loop (ptxas spilled at 80 keys).
    auto desc = [](uint32_t base, uint32_t off, uint32_t lbo) -> uint64_t {
      if constexpr (S::kSplitRing)
        return sw128_desc(base, lbo, 1024) + (off >> 4);
      else
        return sw128_desc(base + off, lbo, 1024);
    };

    // S = Q K^T over D in steps of 32 bytes (4 per 128-byte span), issued
    auto issue_qk = [&](float (&sc)[kBN / 2], int stage) {
      const uint32_t ks = k_s + stage * kKVBytes;
#pragma unroll
      for (int k = 0; k < S::kQKSteps; ++k) {
        const uint32_t col = (k & 3) * 32;
        const uint64_t da = desc(q_c, (k >> 2) * S::kQSpanBytes + col, 16);
        const uint64_t db = desc(ks, (k >> 2) * S::kKVSpanBytes + col, 16);
        if constexpr (S::kF32)
          wgmma_m64n64k8_tf32_ss(sc, da, db, k);
        else
          wgmma_qk(sc, da, db, k);
      }
      wgmma_commit();
    };
    // O += P V over a tile's keys in steps of kPVKeys, issued. bf16: a
    // wgmma for every 128 columns of D; V is [keys, D] with D contiguous,
    // MN-major, the 64-column spans kKVSpanBytes apart. fp32: V^T is
    // [D, keys] with keys contiguous, K-major, the 32-key spans
    // kVtSpanBytes apart.
    auto issue_pv = [&](float (&o)[kD / 128][64],
                        uint32_t (&p)[kBN / S::kPVKeys][4], int stage) {
      const uint32_t vs = v_s + stage * kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / S::kPVKeys; ++kk) {
        if constexpr (S::kF32) {
          wgmma_m64n128k8_tf32_rs(
              o[0], p[kk],
              desc(vs, (kk >> 2) * S::kVtSpanBytes + (kk & 3) * 32, 16));
        } else {
#pragma unroll
          for (int h = 0; h < kD / 128; ++h)
            wgmma_m64n128k16_rs_tb(
                o[h], p[kk],
                desc(vs, 2 * h * S::kKVSpanBytes + kk * 16 * 128,
                     S::kKVSpanBytes));
        }
      }
      wgmma_commit();
    };
    // the probabilities as P.V's A fragments (bf16, or tf32 rounded)
    auto to_a = [&](const float (&sc)[kBN / 2],
                    uint32_t (&p)[kBN / S::kPVKeys][4]) {
      if constexpr (S::kF32)
        probs_to_a_tf32(sc, p);
      else
        probs_to_a(sc, p);
    };

    float o[kD / 128][64], sc[kBN / 2];
    uint32_t p[kBN / S::kPVKeys][4];
    float m_a, m_b, l_a, l_b, al_a, al_b, sum_a, sum_b;
    // kPingPong: the two consumers take turns issuing their products
    // (named barriers 3 + c), each while the other runs its softmax, and
    // consumer 1 lets consumer 0 go first. kLaneRelease: a slot is released
    // by one lane of each warp once the warp's wait for the product that
    // read it is over
    auto turn_wait = [&] {
      if constexpr (M::kPingPong) named_barrier(3 + c, 256);
    };
    auto turn_pass = [&] {
      if constexpr (M::kPingPong) named_barrier_arrive(4 - c, 256);
    };
    if (c == 1) turn_pass();
    auto release = [&](uint32_t bar) {
      if (!M::kLaneRelease || lane == 0) mbar_arrive(bar);
    };

    int it = 0, n = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++n) {
      const Unit x = unit_at<kBN, kMaxTiles, kTail>(a, u, n_whole);
      const Work w = x.w;
      const int nt = x.t1 - x.t0;                 // the unit's key tiles
      if (kTail && nt == 0) {
        --n;                                      // it loads no Q
      } else {
#pragma unroll
        for (int h = 0; h < kD / 128; ++h)
#pragma unroll
          for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
        m_a = m_b = kNeg;

        // Probabilities of key tile t in sc, in place. The tile holding the
        // key edge is scaled and masked first: keys past k_len get -1e30,
        // keys past Lk (zero-filled by TMA) do not count at all.
        auto tile_probs = [&](int t) {
          const int n0 = t * kBN;
          float scale = a.scale_log2;
          if (n0 + kBN > w.valid) {
#pragma unroll
            for (int i = 0; i < kBN / 2; ++i) {
              const int key = n0 + 8 * (i >> 2) + 2 * quad + (i & 1);
              sc[i] = key < w.valid ? sc[i] * scale
                                    : (key < a.Lk ? kNeg : kNegInf);
            }
            scale = 1.f;
          }
          softmax_tile(sc, scale, m_a, m_b, al_a, al_b, sum_a, sum_b);
        };

        // The first tile alone; then, for each next tile, Q K_t^T is issued
        // before P_{t-1} V_{t-1}, so the tensor cores run the one while this
        // warpgroup's softmax of S_t waits for it (the accumulator takes its
        // rescale only once P_{t-1} V_{t-1} has landed).
        mbar_wait(q_full, n & 1);
        if constexpr (S::kRoundQ) {
          // this warpgroup's 64 rows of Q (8 KB of each 32-column span)
          // rounded to tf32 in place, then made visible to wgmma's reads
#pragma unroll
          for (int span = 0; span < kSpans; ++span)
            round_tf32_shared(q_c + span * S::kQSpanBytes + 16 * tid, 2048);
          fence_proxy_async();
          named_barrier(1 + c, 128);
        }
        mbar_wait(k_full(it % kStages), (it / kStages) & 1);
        turn_wait();
        wgmma_fence();
        issue_qk(sc, it % kStages);
        turn_pass();
        wgmma_wait<0>();
        fence_regs(sc);
        if constexpr (S::kSplitRing) release(k_empty(it % kStages));
        if (nt == 1) release(q_empty);
        tile_probs(x.t0);
        l_a = sum_a;
        l_b = sum_b;
        to_a(sc, p);
        for (int t = 1; t < nt; ++t) {
          const int cur = it + t, prev = cur - 1;
          mbar_wait(k_full(cur % kStages), (cur / kStages) & 1);
          mbar_wait(v_full(prev % kStages), (prev / kStages) & 1);
          turn_wait();
          wgmma_fence();
          issue_qk(sc, cur % kStages);
          issue_pv(o, p, prev % kStages);
          turn_pass();
          wgmma_wait<1>();
          fence_regs(sc);
          if constexpr (S::kSplitRing) release(k_empty(cur % kStages));
          if (t == nt - 1) release(q_empty);
          tile_probs(x.t0 + t);
          wgmma_wait<0>();
#pragma unroll
          for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
          fence_regs(p);
          fence_regs(sc);
          release(empty(prev % kStages));
#pragma unroll
          for (int h = 0; h < kD / 128; ++h) rescale_rows(o[h], al_a, al_b);
          l_a = l_a * al_a + sum_a;
          l_b = l_b * al_b + sum_b;
          to_a(sc, p);
        }
        const int last = it + nt - 1;
        mbar_wait(v_full(last % kStages), (last / kStages) & 1);
        turn_wait();
        wgmma_fence();
        issue_pv(o, p, last % kStages);
        turn_pass();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < kD / 128; ++h) fence_regs(o[h]);
        release(empty(last % kStages));
        it += nt;
      }

      l_a = quad_sum(l_a);
      l_b = quad_sum(l_b);
      if constexpr (kTail) {
        // A part of a tail item: its unnormalised O (fragment order, 16
        // bytes a thread a store), row maxima and sums to its slot; the
        // part whose arrival brings the item's counter to `parts` merges
        // every part, in part order whichever it is (so the result does
        // not depend on which CTA finishes last), stores the item's O below
        // and resets the counter for the next launch; the others go on to
        // their next unit. A part without key tiles writes nothing and is
        // left out of the merge.
        if (x.slot >= 0) {
          const int ra = warp * 16 + (lane >> 2);  // row a of the 64; b + 8
          const int item = x.slot / a.parts;
          float* const part0 = a.ws + (size_t)(x.slot - x.part) * kSlotFloats +
                               c * kHalfFloats;
          if (nt > 0) {
            float* const mine = part0 + (size_t)x.part * kSlotFloats;
            float4* const o4 = reinterpret_cast<float4*>(mine);
#pragma unroll
            for (int j = 0; j < 16; ++j)
              o4[j * 128 + tid] = make_float4(o[0][4 * j], o[0][4 * j + 1],
                                              o[0][4 * j + 2], o[0][4 * j + 3]);
            if (quad == 0) {
              mine[8192 + ra] = m_a;
              mine[8192 + ra + 8] = m_b;
              mine[8256 + ra] = l_a;
              mine[8256 + ra + 8] = l_b;
            }
          }
          __threadfence();
          named_barrier(1 + c, 128);
          int done = 0;
          if (tid == 0)
            done = atomicAdd(a.counters + 2 * item + c, 1) == a.parts - 1;
          if (!named_barrier_or(1 + c, 128, done)) continue;
          __threadfence();
          const int n_item = w.n_tiles;
          auto empty_part = [&](int q) {
            return (q + 1) * n_item / a.parts == q * n_item / a.parts;
          };
          float mx_a = kNegInf, mx_b = kNegInf;
          for (int q = 0; q < a.parts; ++q) {
            if (empty_part(q)) continue;
            const float* part = part0 + (size_t)q * kSlotFloats;
            mx_a = fmaxf(mx_a, __ldcg(part + 8192 + ra));
            mx_b = fmaxf(mx_b, __ldcg(part + 8192 + ra + 8));
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) o[0][i] = 0.f;
          l_a = l_b = 0.f;
          for (int q = 0; q < a.parts; ++q) {
            if (empty_part(q)) continue;
            const float* part = part0 + (size_t)q * kSlotFloats;
            const float f_a = ex2(__ldcg(part + 8192 + ra) - mx_a);
            const float f_b = ex2(__ldcg(part + 8192 + ra + 8) - mx_b);
            l_a += f_a * __ldcg(part + 8256 + ra);
            l_b += f_b * __ldcg(part + 8256 + ra + 8);
            const float4* p4 = reinterpret_cast<const float4*>(part);
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float4 v = __ldcg(p4 + j * 128 + tid);
              o[0][4 * j] += f_a * v.x;
              o[0][4 * j + 1] += f_a * v.y;
              o[0][4 * j + 2] += f_b * v.z;
              o[0][4 * j + 3] += f_b * v.w;
            }
          }
          if (tid == 0) a.counters[2 * item + c] = 0;
        }
      }

      // acc / sum in the output's dtype to [B, Lq, H, D] (the Q buffer
      // already holds the next item's Q): staged for TMA stores (kStageO),
      // or straight from registers, a quad writing 16 (bf16) or 32 (fp32)
      // contiguous bytes of a row, rows at or past Lq not written
      // the split-ring plans scale by 1 / sum (a division a row, not an
      // element: up to 128 fewer divisions a thread, which B2's short items
      // feel)
      float inv_a = 0.f, inv_b = 0.f;
      if constexpr (S::kSplitRing) {
        inv_a = 1.f / l_a;
        inv_b = 1.f / l_b;
      }
      auto norm = [&](float x, float l, float inv) {
        if constexpr (S::kSplitRing)
          return x * inv;
        else
          return x / l;
      };
      if constexpr (S::kStageO) {
        // O through this consumer's 16 KB of shared memory, a round at a
        // time: two [64 rows, 128 bytes] spans (128-byte swizzle) filled
        // from registers, then two TMA stores, which write whole 128-byte
        // rows and clip rows past Lq. A round is a 128-column half of O in
        // bf16 and 64 columns in fp32; it waits until the stores before it
        // have read the buffer.
        const uint32_t os = o_s + c * 16384;
        const int rl = warp * 16 + (lane >> 2);   // row a; row b is rl + 8
        constexpr int kRounds = S::kF32 ? kD / 64 : kD / 128;
#pragma unroll
        for (int h = 0; h < kRounds; ++h) {
          if (tid == 0) bulk_wait_all<true>();
          named_barrier(1 + c, 128);
          if constexpr (S::kF32) {
            // columns 64h + 8j + 2 quad (+1): 32 bytes a block of 8, so
            // chunk 2 (j % 4) + quad / 2 of span j / 4, 8 bytes at 8 (quad
            // % 2)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int jo = 8 * h + j;               // o's block of 8
              const uint32_t at =
                  os + (j >> 2) * 8192 + rl * 128 +
                  (((2 * (j & 3) + (quad >> 1)) ^ (rl & 7)) << 4) +
                  8 * (quad & 1);
              st_shared_v2_f32(at, o[0][4 * jo] * inv_a,
                               o[0][4 * jo + 1] * inv_a);
              st_shared_v2_f32(at + 8 * 128, o[0][4 * jo + 2] * inv_b,
                               o[0][4 * jo + 3] * inv_b);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const uint32_t at = os + (j >> 3) * 8192 + rl * 128 +
                                  (((j & 7) ^ (rl & 7)) << 4) + 4 * quad;
              st_shared_u32(at, pack_bf16(o[h][4 * j] * inv_a,
                                          o[h][4 * j + 1] * inv_a));
              st_shared_u32(at + 8 * 128,
                            pack_bf16(o[h][4 * j + 2] * inv_b,
                                      o[h][4 * j + 3] * inv_b));
            }
          }
          fence_proxy_async();
          named_barrier(1 + c, 128);
          if (tid == 0) {
            tma_store_4d(to, os, 2 * S::kCols * h, w.h, w.q0 + 64 * c, w.b);
            tma_store_4d(to, os + 8192, 2 * S::kCols * h + S::kCols, w.h,
                         w.q0 + 64 * c, w.b);
            bulk_commit();
          }
        }
      } else {
        const int r_a = w.q0 + 64 * c + warp * 16 + (lane >> 2), r_b = r_a + 8;
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
                    pack_bf16(norm(o[h][4 * j], l_a, inv_a),
                              norm(o[h][4 * j + 1], l_a, inv_a));
              if (r_b < a.Lq)
                *reinterpret_cast<uint32_t*>(base + r_b * stride) =
                    pack_bf16(norm(o[h][4 * j + 2], l_b, inv_b),
                              norm(o[h][4 * j + 3], l_b, inv_b));
            }
          }
      }
    }
    if constexpr (S::kStageO)
      if (tid == 0) bulk_wait_all<false>();
  }
}

// B1: a persistent CTA on each SM walks (128-row q tile, head, batch)
// items; online softmax over key tiles. M: the measures (B1Measures128 at
// head dim 128 in bf16).
template <typename P, typename M = NoMeasures>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to, const Params a) {
  attention_cta<P, 0, M>(&tq, &tk, &tv, &to, a);
}

// B2: the same, for at most 512 keys.
template <typename P>
__global__ void __launch_bounds__(kThreads, 1)
    single_kv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to, const Params a) {
  attention_cta<P, kMaxKeysB2>(&tq, &tk, &tv, &to, a);
}

// B1 and B2 at the head dims the plans above do not take
// (hopper_wide.cuh): bf16 from 384 on, fp32 from 256 on.
template <bool kF32>
__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const wide::Params a) {
  wide::wide_cta<wide::kDense, 0, kF32>(&tq, &tk, &tv, a);
}

template <bool kF32>
__global__ void __launch_bounds__(wide::kThreads, 1)
    single_kv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const wide::Params a) {
  wide::wide_cta<wide::kDense, kMaxKeysB2 / wide::kKeys, kF32>(&tq, &tk, &tv,
                                                               a);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

// Launch `kernel` (flash_kernel<P> or single_kv_kernel<P>) over q, k, v
// (bf16), or over the pre-pass's rounded q, k and the V^T workspace with
// Lkp keys (F32Plan). A kernel with the tail split (flash_kernel<P,
// B1Measures128>) takes the workspace and its last `tail` items in `parts`
// parts each; parts 1 splits nothing.
template <typename P, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           void* o, const void* k_len, int B, int H, int Lq, int Lk,
           float scale_log2, void* stream, int Lkp = 0, void* ws = nullptr,
           int tail = 0, int parts = 1) {
  constexpr int kD = P::kD;
  constexpr size_t kSmemBytes = P::kSmemBytes;
  CUtensorMap tq, tk, tv, to{};
  const bool ok =
      P::kF32 ? make_bl_hd_map_f32(&tq, q, B, Lq, H, kD, kBoxRows) &&
                    make_bl_hd_map_f32(&tk, k, B, Lk, H, kD, P::kKVBox) &&
                    make_bl_hd_map_f32(&tv, v, B, kD, H, Lkp, P::kKVBox)
              : make_bl_hd_map(&tq, q, B, Lq, H, kD, kBoxRows) &&
                    make_bl_hd_map(&tk, k, B, Lk, H, kD, P::kKVBox) &&
                    make_bl_hd_map(&tv, v, B, Lk, H, kD, P::kKVBox);
  if (!ok || (P::kStageO &&
              !(P::kF32 ? make_bl_hd_map_f32(&to, o, B, Lq, H, kD, kBoxRows)
                        : make_bl_hd_map(&to, o, B, Lq, H, kD, kBoxRows))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const long long n_work = (long long)((Lq + kBM - 1) / kBM) * H * B;
  if (parts < 1 ||
      (parts > 1 && (!ws || reinterpret_cast<uintptr_t>(ws) % 16 ||
                     tail < 1 || tail > n_work ||
                     (long long)tail * parts > sms)))
    return (int)cudaErrorInvalidValue;
  if (parts == 1) tail = 0;
  float* wsf = static_cast<float*>(ws);
  const Params a{static_cast<const int*>(k_len), o, B, H, Lq, Lk, scale_log2,
                 wsf, ws ? reinterpret_cast<int*>(wsf + (size_t)sms *
                                                  kSlotFloats)
                         : nullptr,
                 tail, parts};
  const long long n_units = n_work - tail + (long long)tail * parts;
  const int grid = (int)(n_units < sms ? n_units : sms);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lk, int D, const void* o) {
  return D <= 0 || D % 128 || B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 ||
         reinterpret_cast<uintptr_t>(o) % 16;
}

wide::Params wide_params(const void* k_len, void* o, int B, int H, int Lq,
                         int Lk, int D, float scale_log2) {
  wide::Params a{};
  a.k_len = static_cast<const int*>(k_len);
  a.o = o;
  a.B = B;
  a.H = H;
  a.D = D;
  a.Lq = Lq;
  a.Lk = Lk;
  a.scale_log2 = scale_log2;
  return a;
}

// bf16 B1 (single_kv false) or B2 at head dim D: the instance for D, or
// cudaErrorInvalidValue for a D that is not a positive multiple of 128.
// B1 at D = 128 takes the tail split (ws, tail, parts); any other call
// must ask for none (parts 1).
int dispatch(bool single_kv, const void* q, const void* k, const void* v,
             void* o, const void* k_len, int B, int H, int Lq, int Lk, int D,
             float scale_log2, void* stream, void* ws = nullptr, int tail = 0,
             int parts = 1) {
  if (bad_shape(B, H, Lq, Lk, D, o) ||
      (parts != 1 && (single_kv || D != 128)))
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return single_kv
               ? launch<B2Plan128>(single_kv_kernel<B2Plan128>, q, k, v, o,
                                   k_len, B, H, Lq, Lk, scale_log2, stream)
               : launch<B1Plan128>(flash_kernel<B1Plan128, B1Measures128>, q,
                                   k, v, o, k_len, B, H, Lq, Lk, scale_log2,
                                   stream, 0, ws, tail, parts);
  if (D == 256)
    return single_kv
               ? launch<B2Plan256>(single_kv_kernel<B2Plan256>, q, k, v, o,
                                   k_len, B, H, Lq, Lk, scale_log2, stream)
               : launch<B1Plan256>(flash_kernel<B1Plan256>, q, k, v, o, k_len,
                                   B, H, Lq, Lk, scale_log2, stream);
  const wide::Params a = wide_params(k_len, o, B, H, Lq, Lk, D, scale_log2);
  return single_kv
             ? wide::launch<wide::kDense>(single_kv_wide_kernel<false>, q, k,
                                          v, a, stream)
             : wide::launch<wide::kDense>(flash_wide_kernel<false>, q, k, v,
                                          a, stream);
}

// fp32 B1 or B2 at head dim D: the pre-pass into qw, kw ([B, L, H, D] like
// q and k) and vt ([B, D, H, Lkp], Lkp = Lk rounded up to kKeyPad), then
// F32Plan at D = 128 or the wide design's fp32 dense mode above it. B2 at
// D = 128 (B2PlanF32) rounds q in shared memory: it reads q itself, skips
// q's pass and takes no qw (it may be null).
int dispatch_f32(bool single_kv, const void* q, const void* k, const void* v,
                 void* qw, void* kw, void* vt, void* o, const void* k_len,
                 int B, int H, int Lq, int Lk, int D, float scale_log2,
                 void* stream) {
  const bool round_q = !(single_kv && D == 128);
  if (bad_shape(B, H, Lq, Lk, D, o) || (long long)B * H > 65535 ||
      misaligned16(q, k, v, qw, kw, vt) || (round_q && !qw))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Lkp = padded_keys(Lk);
  if (round_q) round_tf32_async(q, qw, (long long)B * Lq * H * D, st);
  round_tf32_async(k, kw, (long long)B * Lk * H * D, st);
  transpose_v_async(v, vt, B, H, Lk, D, Lkp, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (D == 128)
    return single_kv
               ? launch<B2PlanF32>(single_kv_kernel<B2PlanF32>, q, kw, vt, o,
                                   k_len, B, H, Lq, Lk, scale_log2, stream,
                                   Lkp)
               : launch<F32Plan>(flash_kernel<F32Plan>, qw, kw, vt, o, k_len,
                                 B, H, Lq, Lk, scale_log2, stream, Lkp);
  const wide::Params a = wide_params(k_len, o, B, H, Lq, Lk, D, scale_log2);
  return single_kv ? wide::launch<wide::kDense, true>(
                         single_kv_wide_kernel<true>, qw, kw, vt, a, stream,
                         Lkp)
                   : wide::launch<wide::kDense, true>(flash_wide_kernel<true>,
                                                      qw, kw, vt, a, stream,
                                                      Lkp);
}

}  // namespace

extern "C" {

// B1 in bf16. At head dim 128 the launch's last `tail_items` work items
// run in `parts` parts each, split by keys (ops/flash_attention.py
// tail_split), through `workspace` (flexam_b1_split_workspace_bytes: a
// slot and two zeroed counters for each of the card's SMs, which the
// kernel leaves zeroed); parts 1 splits nothing and takes no workspace.
// Returns a cudaError_t (0 on a clean launch): cudaErrorInvalidValue for a
// split without a workspace, at another head dim, or of more units than
// SMs.
int flexam_flash_attention(const void* q, const void* k, const void* v, void* o,
                           const void* k_len, void* workspace, int tail_items,
                           int parts, int B, int H, int Lq, int Lk, int D,
                           float scale_log2, void* stream) {
  return dispatch(false, q, k, v, o, k_len, B, H, Lq, Lk, D, scale_log2,
                  stream, workspace, tail_items, parts);
}

// Dynamic shared memory a B1 CTA takes at head dim 128, in bytes.
int flexam_attention_smem_bytes() { return (int)B1Plan128::kSmemBytes; }

// B1 at head dim 128 in bf16, into out[0..6]: its plan's keys a tile and
// stages, whether K and V have empty barriers of their own (split ring)
// and O is staged for TMA stores, and its measures (ping-pong, one release
// a warp, the tail split), each 0 or 1. Returns 0.
int flexam_b1_plan(int* out) {
  const int v[7] = {B1Plan128::kBN,          B1Plan128::kStages,
                    B1Plan128::kSplitRing,   B1Plan128::kStageO,
                    B1Measures128::kPingPong, B1Measures128::kLaneRelease,
                    B1Measures128::kTailSplit};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// Bytes of the tail split's workspace on a card of `sms` SMs: a slot for
// each unit of the last round (at most one an SM), then two counter words
// a tail item.
int flexam_b1_split_workspace_bytes(int sms) {
  return sms * (int)(kSlotFloats * sizeof(float) + 2 * sizeof(int));
}

// The same for bf16 B1 (single_kv 0) or B2 (1) at head dim d, 128 or 256;
// 0 for any other d.
int flexam_attention_smem_bytes_at(int d, int single_kv) {
  if (d == 128)
    return (int)(single_kv ? B2Plan128::kSmemBytes : B1Plan128::kSmemBytes);
  if (d == 256)
    return (int)(single_kv ? B2Plan256::kSmemBytes : B1Plan256::kSmemBytes);
  return 0;
}

// The same for fp32 B1 (single_kv 0) or B2 (1) at head dim 128.
int flexam_attention_smem_bytes_f32(int single_kv) {
  return (int)(single_kv ? B2PlanF32::kSmemBytes : F32Plan::kSmemBytes);
}

// B2 in bf16 (Lk <= 512). Returns a cudaError_t.
int flexam_single_kv_attention(const void* q, const void* k, const void* v, void* o,
                               const void* k_len, int B, int H, int Lq, int Lk, int D,
                               float scale_log2, void* stream) {
  if (Lk > kMaxKeysB2) return (int)cudaErrorInvalidValue;
  return dispatch(true, q, k, v, o, k_len, B, H, Lq, Lk, D, scale_log2,
                  stream);
}

// B1 in fp32 (TF32 wgmma). qw, kw: workspaces shaped as q and k; vt: a
// workspace of B * D * H * Lkp floats, Lkp = Lk rounded up to 64. All
// 16-byte aligned. Returns a cudaError_t.
int flexam_flash_attention_f32(const void* q, const void* k, const void* v,
                               void* qw, void* kw, void* vt, void* o,
                               const void* k_len, int B, int H, int Lq, int Lk,
                               int D, float scale_log2, void* stream) {
  return dispatch_f32(false, q, k, v, qw, kw, vt, o, k_len, B, H, Lq, Lk, D,
                      scale_log2, stream);
}

// B2 in fp32 (Lk <= 512), with B1's workspaces; at D = 128 qw is not used
// and may be null. Returns a cudaError_t.
int flexam_single_kv_attention_f32(const void* q, const void* k, const void* v,
                                   void* qw, void* kw, void* vt, void* o,
                                   const void* k_len, int B, int H, int Lq,
                                   int Lk, int D, float scale_log2,
                                   void* stream) {
  if (Lk > kMaxKeysB2) return (int)cudaErrorInvalidValue;
  return dispatch_f32(true, q, k, v, qw, kw, vt, o, k_len, B, H, Lq, Lk, D,
                      scale_log2, stream);
}

}  // extern "C"
