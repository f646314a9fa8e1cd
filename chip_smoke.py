#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`flexam_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with "phase" and "seconds" when it ends:

  env                  torch / CUDA versions and the card (nvidia-smi);
  build                the CUDA kernels built from csrc/ (one nvcc a
                       source, all started together, then one link), with
                       ptxas's registers / spills by kernel, the Hopper
                       opcodes (HGMMA, IGMMA, UTMALDG, ...) in the SASS of
                       the attention kernels B1, B2, B5 and B6, and the
                       128-bit loads and stores of the row kernels B3, B4;
  kernels              B1, B2, B3 and B4 (both modes) at the flagship
                       shapes, B5 and B6 at the long-clip shape (23,296
                       tokens), each held to its plain PyTorch version, with
                       its time (20 back-to-back launches between two CUDA
                       events, the median of 5 such runs, so the wrapper's
                       host time is not counted), its bound and the library
                       yardstick (B3/B4: GB/s beside out.copy_(x)'s); then
                       B6 on q/k whose size changes from one quantization
                       block to the next, and B2, B3 (RIFLEx tables) and B4
                       at the long path's shapes;
  reference_check      a small head_dim-128 DiT through the kernels on the
                       card against the same DiT on the CPU (plain path),
                       with dense, block-sparse and int8 attention;
  dit_forward_flagship one DiT forward at full width (Wan2.2-Fun-5B,
                       512x896x97f: 11,648 tokens with the ref block, CFG
                       batch 2), random bf16 weights made on the card;
  generate             the main path: the full-width model (umT5-XXL, the
                       48-channel VAE, the DiT) on 512x896x17f with the
                       first frame known, 4 Euler steps at CFG 6.0, T5
                       released after encoding; then a 1-step denoise with
                       no known frame (the broadcast B4 mode). Launch counts
                       are reset just before and read just after;
  generate_long        the long-clip path on the same pipeline, weights and
                       prompt context: 512x896x201f (23,296 tokens with the
                       ref block), first frame known, RIFLEx (k 6, L_test
                       51), streamed VAE encode and decode, 2 Euler steps at
                       CFG 6.0 through the auto attention ladder (B6 for
                       self-attention); then 1 step under
                       FLEXAM_ATTENTION=sparse (B5). Launch counts are reset
                       and read around each; a profiled step of each
                       follows ("denoise_long_profile").

The flagship phase also runs one more forward under torch.profiler, and a
"dit_forward_profile" line gives its device time by kernel group.

Each kernel is held to its plain version element by element, within a few
bf16 ulps of the element's own size (the bounds and their reasons are in
flexam_tpu_torch/testing.py). Then one JSON line with every kernel's
numbers, the nvidia-smi line, and the result line. TF32 is off for
matmuls and convolutions (torch.backends.cuda.matmul.allow_tf32 /
cudnn.allow_tf32 = False), so fp32 work on the card runs in full fp32. Any
failure raises and exits non-zero.
Without a CUDA device, or without the flexam_tpu_torch package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
SEED = 1234
FLAGSHIP_LATENT = (25, 32, 56)     # 97 frames at 512 x 896, 16x VAE
GENERATE_VIDEO = (17, 512, 896)    # frames, height, width of the main path
LONG_VIDEO = (201, 512, 896)       # the long-clip path: 51 latent frames
LONG_TOKENS = 52 * 448             # with the ref block: 23,296


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, **kw) -> float:
    """Milliseconds per call of `fn` on the card, from back-to-back
    launches between two CUDA events (`flexam_tpu_torch/tools/timing.py`:
    20 calls a run, the median of 5 runs unless `kw` says otherwise), so
    the wrapper's host time is not counted."""
    from flexam_tpu_torch.tools.timing import device_ms as timed
    return timed(fn, **kw)


def compare(got, ref, bound_rel: float, name: str) -> dict:
    """max abs / max rel error of a whole model's output; fails above
    bound_rel of max |ref|."""
    g, r = got.float(), ref.float()
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    rel = err / scale if scale else err
    if not (err <= bound_rel * scale) or not g.isfinite().all():
        raise AssertionError(f"{name}: max abs err {err} > {bound_rel} x "
                             f"max|ref| {scale}")
    return {"max_abs_err": err, "max_rel_err": rel, "bound_rel": bound_rel,
            "max_abs_ref": scale}


class StagePeaks:
    """Peak memory allocated in each stage of a run: `mark(name)` closes the
    stage that ran since the last mark (or since the object was made), and
    the next stage starts from the memory allocated then."""

    def __init__(self):
        import torch
        self.torch = torch
        self.gb = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.resident_gb = torch.cuda.memory_allocated() / 1e9

    def mark(self, name: str) -> None:
        self.torch.cuda.synchronize()
        self.gb[name] = self.torch.cuda.max_memory_allocated() / 1e9
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> float:
        return max(self.gb.values())


# the wgmma opcodes each attention kernel must have (int8 wgmma is IGMMA)
HOPPER_OPCODES = {"flash_kernel": ("HGMMA", "UTMALDG"),
                  "single_kv_kernel": ("HGMMA", "UTMALDG"),
                  "sparse_attention_kernel": ("HGMMA", "UTMALDG"),
                  "int8_attention_kernel": ("IGMMA", "HGMMA", "UTMALDG")}


def hopper_sass(lib: Path) -> dict:
    """Counts of the opcodes that tell the attention kernels' Hopper design
    from an mma.sync one (wgmma: HGMMA for bf16, IGMMA for int8; TMA
    loads: UTMALDG; mbarriers: SYNCS; HMMA / IMMA are mma.sync) in their
    SASS, from cuobjdump; fails if B1, B2 or B5 lacks HGMMA or UTMALDG, or
    B6 lacks IGMMA, HGMMA or UTMALDG. Also B6's int -> float conversions
    by full opcode: I2F.*.RP comes from integer divisions (the work-item
    index); a conversion of each logit would add I2F (or I2FP) without RP.
    And the row kernels' (B3, B4) 128-bit global loads and stores, by
    instantiation (`ln_mod_kernel<12>` serves 3072 features); fails if one
    lacks either. Null where the toolkit has no cuobjdump."""
    from flexam_tpu_torch.tools.attention_ab import (key_opcodes,
                                                     sass_opcodes,
                                                     wide_accesses)
    try:
        ops = sass_opcodes(lib)
    except (OSError, subprocess.CalledProcessError) as e:
        return {"cuobjdump": None, "reason": str(e)[:200]}
    keys = {k: v for k, v in key_opcodes(ops).items() if k in HOPPER_OPCODES}
    rows = {k: wide_accesses(v) for k, v in ops.items()
            if k.startswith(("ln_mod_kernel", "rmsnorm_rope_kernel"))}
    if len(rows) < 2 or not all(all(n.values()) for n in rows.values()):
        raise AssertionError(f"row kernels without 128-bit global loads or "
                             f"stores in their SASS: {rows}")
    keys["row_kernels_128_bit"] = rows
    for kernel, need in HOPPER_OPCODES.items():
        got = keys.get(kernel, {})
        if not all(got.get(op) for op in need):
            raise AssertionError(f"{kernel}: no {' / '.join(need)} in its "
                                 f"SASS ({got})")
    i2f = {op: n for op, n in ops["int8_attention_kernel"].items()
           if op.split(".")[0] in ("I2F", "I2FP")}
    keys["int8_attention_kernel_i2f"] = i2f
    keys["int8_attention_kernel_i2f_outside_divisions"] = sum(
        n for op, n in i2f.items() if ".RP" not in op)
    return keys


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_kernels(dev, results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from flexam_tpu_torch.core.rope import build_video_rope, make_rope_tables
    from flexam_tpu_torch.ops import flash_attention as fa
    from flexam_tpu_torch.ops import fused
    from flexam_tpu_torch.testing import (check_attention,
                                          check_ln_modulation,
                                          check_rmsnorm_rope)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    B, H, D, L, LT, DIM = 2, 24, 128, 11648, 512, 3072

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    lines = {}

    # attention: B1 self-attention (L x L), B2 cross-attention (L x 512)
    q = randn(B, L, H, D)
    for name, lk, fn in (("flash_attention", L, fa.flash_attention),
                         ("single_kv_attention", LT, fa.single_kv_attention)):
        k, v = randn(B, lk, H, D), randn(B, lk, H, D)
        got = fn(q, k, v)
        # the plain version over query chunks of 1024 rows: all of them
        # are compared (the full fp32 logits would be 26 GB at L x L)
        ref = fa.attention_plain(q, k, v, q_chunk=1024)
        torch.cuda.synchronize()
        err = check_attention(got, ref, name)
        del got, ref
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4.0 * B * H * L * lk * D
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(flops, nbytes)
        ms = device_ms(lambda: fn(q, k, v))
        lines[name] = dict(
            err, ms=ms, tflops=flops / ms / 1e9, bound_share=bms / ms,
            plain_ms=device_ms(lambda: fa.attention_plain(q, k, v,
                                                          q_chunk=1024),
                               launches=1, reps=3, warmup=1),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt)),
            bound_ms=bms, bound_by=by,
            plain_compare="every query row; the plain version runs over "
                          "1024-row query chunks",
            shape=f"q [{B},{L},{H},{D}] k/v [{B},{lk},{H},{D}] bf16")
        del k, v, qt, kt, vt
    del q

    # B3: q/k RMSNorm over 3072 + RoPE on the flagship grid (26 x 16 x 28).
    # Rows get their own offset and scale, as DiT hidden states have, so
    # that B4's mean subtraction matters.
    x = (randn(B, L, DIM, dtype=torch.float32)
         * torch.exp(0.5 * randn(B, L, 1, dtype=torch.float32))
         + 4.0 * randn(B, L, 1, dtype=torch.float32)).to(bf)
    gamma = (1.0 + 0.1 * randn(DIM, dtype=torch.float32)).to(bf)
    tables = torch.from_numpy(make_rope_tables(D, 1024)).to(dev)
    cos, sin = build_video_rope(tables, (26, 16, 28), D)
    # what this card streams: out.copy_(x) reads x and writes out once
    copy_out = torch.empty_like(x)
    copy_ms = device_ms(lambda: copy_out.copy_(x))
    copy = dict(copy_ms=copy_ms, copy_gbps=4.0 * x.numel() / copy_ms / 1e6)
    del copy_out

    def streamed(nbytes, ms):
        """The row kernels' bandwidth figures beside the copy's."""
        bms, by = bound_ms(10.0 * x.numel(), nbytes)
        return dict(ms=ms, gbps=nbytes / ms / 1e6, bound_share=bms / ms,
                    bound_ms=bms, bound_by=by, **copy)

    got = fused.rmsnorm_rope(x, gamma, cos, sin, H)
    ref = fused.rmsnorm_rope_plain(x, gamma, cos, sin, H)
    lines["rmsnorm_rope"] = dict(
        check_rmsnorm_rope(got, ref, "rmsnorm_rope"),
        **streamed(2.0 * 2 * x.numel() + 2 * DIM + 4.0 * 2 * cos.numel(),
                   device_ms(lambda: fused.rmsnorm_rope(x, gamma, cos, sin,
                                                        H))),
        plain_ms=device_ms(lambda: fused.rmsnorm_rope_plain(x, gamma, cos, sin,
                                                            H)),
        library_ms=None,
        shape=f"x [{B},{L},{DIM}] bf16, tables [{L},{D // 2}] fp32")

    # B4 both modes: binary (TI2V first frame known) and broadcast, with the
    # main path's terms: the shift a fresh tensor, the scale a strided view
    # of the [B, 2, 6, D] (binary) or [B, 1, 6, D] modulation tensor
    mask = torch.ones((B, L), device=dev)
    mask[:, 448:896] = 0.0     # the first video frame after the ref block
    for name, terms, m in (("ln_mod_binary", (B, 2, DIM), mask),
                           ("ln_mod_bcast", (B, DIM), None)):
        mod = randn(B, terms[1] if m is not None else 1, 6, DIM,
                    dtype=torch.float32)
        sh = randn(*terms, dtype=torch.float32)
        sc = mod[:, :, 1] if m is not None else mod[:, 0, 1]
        got = fused.ln_modulation(x, sh, sc, mask=m)
        ref = fused.ln_modulation_plain(x, sh, sc, mask=m)
        lines[name] = dict(
            check_ln_modulation(got, ref, sh, m, name),
            **streamed(2.0 * 2 * x.numel() + 4.0 * 2 * sh.numel()
                       + (4.0 * m.numel() if m is not None else 0.0),
                       device_ms(lambda: fused.ln_modulation(x, sh, sc,
                                                             mask=m))),
            plain_ms=device_ms(lambda: fused.ln_modulation_plain(x, sh, sc,
                                                                 mask=m)),
            library_ms=None,
            shape=f"x [{B},{L},{DIM}] bf16, shift/scale {list(terms)} fp32 "
                  "(scale a strided view)")
        if m is not None:
            # the kernel reads the strided scale as it is: its time on a
            # contiguous copy of the same terms, beside
            sc_c = sc.contiguous()
            lines[name]["contiguous_terms_ms"] = device_ms(
                lambda: fused.ln_modulation(x, sh, sc_c, mask=m))
    del x
    lines.update(long_kernels(dev, gen))
    results.update(lines)
    emit("kernels", t0, kernels=sorted(lines), **lines)


def long_kernels(dev, gen) -> dict:
    """B5 and B6 at the long-clip shape: q/k/v [2, 23296, 24, 128] bf16
    (512x896x201f: 51 latent frames + the ref block, 448 tokens each); then
    B2, B3 (RIFLEx tables) and B4 (binary) at the shapes the long path
    gives them ("long/..." lines)."""
    import torch
    import torch.nn.functional as F
    from flexam_tpu_torch.ops import flash_attention as fa
    from flexam_tpu_torch.ops import int8_attention as i8
    from flexam_tpu_torch.ops import sparse_attention as sp
    from flexam_tpu_torch.testing import (block_scaled, check_int8_attention,
                                          check_sparse_attention)

    B, H, D, L = 2, 24, 128, LONG_TOKENS
    q, k, v = (torch.randn((B, L, H, D), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2.0 * 4 * q.numel()          # q, k, v read once, o written once
    shape = f"q/k/v [{B},{L},{H},{D}] bf16"
    lines = {}

    # B5 with the w=2 policy of 51 frames + ref: 26 blocks of 896 tokens
    pol = sp.video_sparse_policy(51, 448, ref_tokens=448, window=2)
    rows, blk = pol["rows"], pol["blk"]
    kidx, nnz = (torch.from_numpy(a).to(dev) for a in sp.rows_to_arrays(rows))
    pairs = int(nnz.sum().item())

    def b5():
        return sp.sparse_flash_attention(q, k, v, rows, blk, kidx=kidx,
                                         nnz=nnz)

    got = b5()
    ref = sp.masked_dense_attention(q, k, v, rows, blk)
    torch.cuda.synchronize()
    err = check_sparse_attention(got, ref, "sparse_attention")
    del got, ref
    tok_blk = torch.arange(L, device=dev) // blk
    bmask = torch.zeros((len(rows), len(rows)), dtype=torch.bool, device=dev)
    for i, r in enumerate(rows):
        bmask[i, r] = True
    tok_mask = bmask[tok_blk][:, tok_blk]            # [L, L] bool
    flops = 4.0 * B * H * pairs * blk * blk * D
    bms, by = bound_ms(flops, nbytes)
    ms = device_ms(b5)
    lines["sparse_attention"] = dict(
        err, ms=ms, tflops=flops / ms / 1e9, bound_share=bms / ms,
        plain_ms=device_ms(lambda: sp.masked_dense_attention(q, k, v, rows,
                                                             blk),
                           launches=1, reps=3, warmup=1),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=tok_mask)),
        library="F.scaled_dot_product_attention with the boolean token mask",
        bound_ms=bms, bound_by=by, blocks=len(rows), blk=blk,
        active_pairs=pairs, density=pairs / len(rows) ** 2,
        dense_bound_ms=bound_ms(4.0 * B * H * L * L * D, nbytes)[0],
        plain_compare="every query row; the plain version runs over 512-row "
                      "query chunks", shape=shape)
    del tok_mask

    # B6, what the auto ladder takes for self-attention at this length
    def b6():
        return i8.int8_attention(q, k, v)

    got = b6()
    ref = i8.int8_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = check_int8_attention(got, ref, "int8_attention")
    del ref
    exact = fa.attention_plain(q, k, v, q_chunk=1024)
    rel = ((got.float() - exact.float()).abs().mean()
           / exact.float().abs().mean()).item()
    del got, exact
    ops_i8 = 2.0 * B * H * L * L * D        # Q K^T in int8
    ops_bf = 2.0 * B * H * L * L * D        # P V in bf16
    t_ops = (ops_i8 / PEAK_INT8_OPS + ops_bf / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    ms = device_ms(b6)
    lines["int8_attention"] = dict(
        err, ms=ms, tflops=(ops_i8 + ops_bf) / ms / 1e9,
        bound_share=max(t_ops, t_bytes) / ms,
        tflops_note="int8 and bf16 operations together, per second",
        quantize_ms=device_ms(lambda: i8.quantize_qk(q, k)),
        plain_ms=device_ms(lambda: i8.int8_attention_plain(q, k, v),
                           launches=1, reps=3, warmup=1),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                    vt)),
        library="bf16 F.scaled_dot_product_attention (exact attention, not "
                "the int8 function)",
        b1_ms=device_ms(lambda: fa.flash_attention(q, k, v)),
        b1_note="B1 at the same shape: what the auto ladder replaces (exact, "
                "not the int8 function)",
        mean_rel_err_vs_exact=rel, mean_rel_err_bound_jax_test=0.02,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        plain_compare="every query row; the plain version runs over 512-row "
                      "query chunks", shape=shape)
    if rel >= 0.02:
        raise AssertionError(f"int8_attention: mean relative error {rel} "
                             "against exact attention >= 0.02")

    # B6 again with q rows and keys whose size alternates by 4x from one
    # quantization block (1,456 rows) to the next: 12 of the 15 block edges
    # fall inside a 64-row / 64-key tile, and each side of an edge must
    # take its own block's scale
    blk6 = i8.quant_block(L)
    qb, kb = block_scaled(q, blk6), block_scaled(k, blk6, phase=1)
    got = i8.int8_attention(qb, kb, v)
    ref = i8.int8_attention_plain(qb, kb, v)
    torch.cuda.synchronize()
    lines["long/int8_attention_block_scales"] = dict(
        check_int8_attention(got, ref, "int8_attention block scales"),
        quant_block=blk6, scales="q rows x2.0 / x0.5 by block, keys the "
        "other way round", shape=shape)
    del q, k, v, qt, kt, vt, qb, kb, got, ref
    lines.update(long_path_shapes(dev, gen))
    return lines


def long_path_shapes(dev, gen) -> dict:
    """B2, B3 and B4 (binary) at the long path's shapes, against their plain
    versions: cross-attention of 23,296 queries over 512 text tokens, the
    q/k RMSNorm + RoPE with the RIFLEx tables (k 6, L_test 51) on the
    52 x 16 x 28 grid, and the AdaLN prologue with the first video frame
    known."""
    import torch
    from flexam_tpu_torch.core.rope import build_video_rope, make_rope_tables
    from flexam_tpu_torch.ops import flash_attention as fa
    from flexam_tpu_torch.ops import fused
    from flexam_tpu_torch.testing import (check_attention,
                                          check_ln_modulation,
                                          check_rmsnorm_rope)

    B, H, D, L, LT, DIM = 2, 24, 128, LONG_TOKENS, 512, 3072
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    lines = {}
    q, k, v = randn(B, L, H, D), randn(B, LT, H, D), randn(B, LT, H, D)
    got = fa.single_kv_attention(q, k, v)
    ref = fa.attention_plain(q, k, v, q_chunk=1024)
    torch.cuda.synchronize()
    lines["long/single_kv_attention"] = dict(
        check_attention(got, ref, "long/single_kv_attention"),
        ms=device_ms(lambda: fa.single_kv_attention(q, k, v)),
        shape=f"q [{B},{L},{H},{D}] k/v [{B},{LT},{H},{D}] bf16")
    del q, k, v, got, ref

    # rows with their own offset and scale, as in the flagship check
    x = (randn(B, L, DIM, dtype=torch.float32)
         * torch.exp(0.5 * randn(B, L, 1, dtype=torch.float32))
         + 4.0 * randn(B, L, 1, dtype=torch.float32)).to(bf)
    gamma = (1.0 + 0.1 * randn(DIM, dtype=torch.float32)).to(bf)
    tables = torch.from_numpy(make_rope_tables(
        D, 1024, riflex={"k": 6, "L_test": 51})).to(dev)
    cos, sin = build_video_rope(tables, (52, 16, 28), D)
    got = fused.rmsnorm_rope(x, gamma, cos, sin, H)
    ref = fused.rmsnorm_rope_plain(x, gamma, cos, sin, H)
    torch.cuda.synchronize()
    ms = device_ms(lambda: fused.rmsnorm_rope(x, gamma, cos, sin, H))
    lines["long/rmsnorm_rope"] = dict(
        check_rmsnorm_rope(got, ref, "long/rmsnorm_rope"),
        ms=ms, gbps=(4.0 * x.numel() + 8.0 * cos.numel()) / ms / 1e6,
        riflex={"k": 6, "L_test": 51}, grid=[52, 16, 28],
        shape=f"x [{B},{L},{DIM}] bf16, tables [{L},{D // 2}] fp32")
    del got, ref

    mask = torch.ones((B, L), device=dev)
    mask[:, 448:896] = 0.0     # the first video frame after the ref block
    # the scale a strided view of the modulation tensor, as on the main path
    sh = randn(B, 2, DIM, dtype=torch.float32)
    sc = randn(B, 2, 6, DIM, dtype=torch.float32)[:, :, 1]
    got = fused.ln_modulation(x, sh, sc, mask=mask)
    ref = fused.ln_modulation_plain(x, sh, sc, mask=mask)
    torch.cuda.synchronize()
    ms = device_ms(lambda: fused.ln_modulation(x, sh, sc, mask=mask))
    lines["long/ln_mod_binary"] = dict(
        check_ln_modulation(got, ref, sh, mask, "long/ln_mod_binary"),
        ms=ms, gbps=4.0 * x.numel() / ms / 1e6,
        shape=f"x [{B},{L},{DIM}] bf16, shift/scale [{B},2,{DIM}] fp32")
    return lines


def phase_reference_check(dev) -> None:
    """A small head_dim-128 DiT through the kernels on the card, against the
    same weights and inputs through the plain versions on the CPU (bf16
    both), with dense, block-sparse and int8 attention. Bound: 5e-2 of max
    |ref| (bf16 over 2 blocks; the two devices order their sums
    differently, and under int8 a value on a rounding tie may quantize one
    step apart)."""
    import torch
    from flexam_tpu_torch.config import DiTConfig
    from flexam_tpu_torch.core import attention
    from flexam_tpu_torch.models.dit import dit_forward, init_dit_params
    from flexam_tpu_torch.ops import launch_counts
    from flexam_tpu_torch.ops.sparse_attention import make_sparse_attn_fn

    t0 = time.perf_counter()
    cfg = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                    in_dim=8, out_dim=4, text_dim=32, text_len=6, freq_dim=32,
                    add_ref_conv=False, add_cnn_block=False)
    params = init_dit_params(cfg, seed=SEED, dtype=torch.bfloat16,
                             device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((2, 8, 3, 16, 16), generator=gen).to(torch.bfloat16)
    ctx = torch.randn((2, 6, 32), generator=gen).to(torch.bfloat16)
    t = torch.tensor([700.0, 700.0])
    mask = (torch.rand((2, 3 * 8 * 8), generator=gen) > 0.3).float()
    out = {}
    on_card = _to(params, dev)
    for name, m in (("binary", mask), ("scalar", None)):
        ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=m)
        got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                          binary_t_mask=None if m is None else m.to(dev))
        out[name] = compare(got.cpu(), ref, 5e-2, f"reference_check/{name}")
    # the long-clip backends: B5 (3 frames of 64 tokens, window 1: frame 0
    # does not see frame 2) and B6 (every attention call, explicitly)
    sparse = make_sparse_attn_fn(3, 64, window=1)
    counts = launch_counts()
    ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=mask,
                      attn_fn=sparse)
    got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                      binary_t_mask=mask.to(dev), attn_fn=sparse)
    out["sparse"] = compare(got.cpu(), ref, 5e-2, "reference_check/sparse")
    os.environ["FLEXAM_ATTENTION"] = "pallas_int8"
    attention._default_backend.cache_clear()
    try:
        ref = dit_forward(params, cfg, x, t, ctx, binary_t_mask=mask)
        got = dit_forward(on_card, cfg, x.to(dev), t.to(dev), ctx.to(dev),
                          binary_t_mask=mask.to(dev))
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    out["int8"] = compare(got.cpu(), ref, 5e-2, "reference_check/int8")
    after = launch_counts()
    for k, n in (("sparse_attention", 2), ("int8_attention", 4)):
        if after[k] - counts[k] != n:
            raise AssertionError(f"reference_check: {k} launched "
                                 f"{after[k] - counts[k]} times, expected {n}")
    emit("reference_check", t0, **out)


def _to(tree, dev):
    import torch
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def phase_dit_flagship(dev, cfg):
    import torch
    from flexam_tpu_torch.models.dit import (dit_forward, init_dit_params,
                                             make_rope_tables_for)
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    dcfg = cfg.dit
    params = init_dit_params(dcfg, seed=SEED, dtype=torch.bfloat16,
                             device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf = torch.bfloat16
    lt, lh, lw = FLAGSHIP_LATENT
    c = dcfg.out_dim

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    x = randn(2, c, lt, lh, lw)
    y = randn(2, dcfg.in_dim - c, lt, lh, lw)
    ac = randn(2, dcfg.in_dim_cnn_block - c, lt, lh, lw)
    ref = randn(2, c, lh, lw)
    ctx = randn(2, dcfg.text_len, dcfg.text_dim)
    t = torch.full((2,), 900.0, device=dev)
    dens = torch.full((2,), 0.5, device=dev)
    n_vid = lt * (lh // 2) * (lw // 2)
    mask = torch.ones((2, n_vid), device=dev)
    mask[:, :(lh // 2) * (lw // 2)] = 0.0     # first frame known
    rope = make_rope_tables_for(dcfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t1 = time.perf_counter()
    with torch.no_grad():
        out = dit_forward(params, dcfg, x, t, ctx, density=dens, y=y,
                          additional_control=ac, full_ref=ref,
                          rope_tables=rope, binary_t_mask=mask)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t1
    counts = launch_counts()
    finite = bool(out.isfinite().all().item())
    if not finite or tuple(out.shape) != tuple(x.shape):
        raise AssertionError(f"flagship forward: shape {tuple(out.shape)}, "
                             f"finite {finite}")
    expect = {"flash_attention": dcfg.num_layers,
              "single_kv_attention": dcfg.num_layers,
              "rmsnorm_rope": 2 * dcfg.num_layers,
              "ln_mod_binary": 2 * dcfg.num_layers}
    for k, n in expect.items():
        if counts[k] != n:
            raise AssertionError(f"flagship forward: {k} launched "
                                 f"{counts[k]} times, expected {n}")
    emit("dit_forward_flagship", t0, tokens=n_vid + (lh // 2) * (lw // 2),
         batch=2, init_seconds=round(t_init, 3), forward_seconds=fwd_s,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         finite=finite, launches=counts)
    t0 = time.perf_counter()
    with torch.no_grad():
        emit("dit_forward_profile", t0, **profile_forward(
            lambda: dit_forward(params, dcfg, x, t, ctx, density=dens, y=y,
                                additional_control=ac, full_ref=ref,
                                rope_tables=rope, binary_t_mask=mask)))
    return params


def profile_forward(fn) -> dict:
    """Device time of one more call of `fn` under torch.profiler: the wall
    time, the device-busy share, device time by kernel group, and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = {"B1 flash_attention": ("flash_kernel",),
              "B2 single_kv_attention": ("single_kv_kernel",),
              "B5 sparse_attention": ("sparse_attention_kernel",),
              "B6 int8_attention": ("int8_attention_kernel",),
              "B3 rmsnorm_rope": ("rmsnorm_rope_kernel",),
              "B4 ln_modulation": ("ln_mod_kernel",),
              "gemm": ("gemm", "gemv", "cutlass", "xmma", "sm90_", "cublas",
                       "nvjet"),
              "conv": ("conv", "implicit_convolve", "cudnn")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    by_group, top = {}, []
    for ev in prof.key_averages():
        # device-side activities only (kernels, copies), not the host ops
        # that launched them; CUPTI's "Command Buffer Full" marks a full
        # launch queue, not device work
        dev_us = ev.self_device_time_total
        if (ev.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0
                or ev.key == "Command Buffer Full"):
            continue
        name = ev.key
        g = next((k for k, pats in groups.items()
                  if any(p in name for p in pats)), "other (elementwise etc.)")
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, ev.count, name[:90]))
    top.sort(reverse=True)
    busy = sum(by_group.values()) / 1e3
    return {"wall_seconds": wall, "device_busy_seconds": busy,
            "device_busy_share": busy / wall if wall else None,
            "device_ms_by_group": dict(sorted(by_group.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"device_ms": a, "calls": b, "name": c}
                            for a, b, c in top[:12]]}


def phase_generate(dev, cfg, dit_params, results: dict):
    import numpy as np
    import torch
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels

    t0 = time.perf_counter()
    models = FlexAMModels(
        cfg=cfg, dit_params=dit_params,
        vae_params=init_vae_params(cfg.vae, seed=SEED + 2, device=dev),
        t5_params=init_t5_params(cfg.t5, seed=SEED + 3, device=dev))
    pipe = FlexAMGenerationPipeline(models, device=dev)
    T, Hp, Wp = GENERATE_VIDEO
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def clip(frames=T):
        return torch.rand((1, 3, frames, Hp, Wp), generator=gen, device=dev)

    video, control, depth = clip(), clip(), clip()
    cos_videos = [clip() for _ in range(4)]
    ref_image = clip(1)
    mask = torch.ones((1, 1, T, Hp, Wp), device=dev)
    mask[:, :, 0] = 0.0                       # first frame known
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    peaks = StagePeaks()
    stage = {}
    step_times = []

    reset_launch_counts()
    t1 = time.perf_counter()
    context = pipe.encode_prompt("a red fox runs through fresh snow")
    torch.cuda.synchronize()
    stage["encode"] = time.perf_counter() - t1
    pipe.release_t5()
    torch.cuda.empty_cache()
    peaks.mark("encode")
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning(video, mask, control, depth, cos_videos,
                                     ref_image)
    torch.cuda.synchronize()
    stage["prepare"] = time.perf_counter() - t1
    peaks.mark("prepare")
    if not cond["first_frame_known"] or not cond["per_token_t"]:
        raise AssertionError("generate: expected the binary-timestep path")

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        if done == total:
            peaks.mark("denoise")

    t_den = time.perf_counter()
    out = pipe.generate_from_cond(cond, context, num_inference_steps=4,
                                  guidance_scale=6.0, seed=SEED,
                                  progress_cb=progress)
    t_end = time.perf_counter()
    peaks.mark("decode")
    stage["denoise"] = step_times[-1] - t_den
    stage["decode"] = t_end - step_times[-1]
    peak = peaks.peak()
    if out.shape != (1, 3, T, Hp, Wp) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"generate: output {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")

    # no known frame: scalar timestep, the broadcast B4 mode
    t1 = time.perf_counter()
    cond_free = pipe.prepare_conditioning(video, None, control, depth,
                                          cos_videos, ref_image)
    lat = pipe.denoise(cond_free, context, num_inference_steps=1,
                       guidance_scale=6.0, seed=SEED)
    torch.cuda.synchronize()
    stage["no_known_frame_prepare_denoise_1_step"] = time.perf_counter() - t1
    counts = launch_counts()
    if not bool(lat.isfinite().all().item()):
        raise AssertionError("no-known-frame denoise: non-finite latents")
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for k in MAIN_PATH_KERNELS:
        results.setdefault(k, {})["launches"] = counts[k]
    emit("generate", t0, setup_seconds=round(t_setup, 3),
         stages=stage, step_seconds=[b - a for a, b in
                                     zip([t_den] + step_times[:-1],
                                         step_times)],
         output_shape=list(out.shape), output_range=[float(out.min()),
                                                     float(out.max())],
         peak_memory_allocated_gb=peak, frames=T,
         resident_at_start_gb=peaks.resident_gb,
         peak_memory_allocated_gb_by_stage=peaks.gb, launches=counts)
    return pipe, context


def phase_generate_long(dev, pipe, context, results: dict) -> None:
    """The long-clip path: 512x896x201f through generate_from_cond with the
    auto attention ladder (B6), then one step under FLEXAM_ATTENTION=sparse
    (B5). Reuses the main path's pipeline, DiT weights and context."""
    import numpy as np
    import torch
    from flexam_tpu_torch.core import attention
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    T, Hp, Wp = LONG_VIDEO
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    video = torch.rand((1, 3, T, Hp, Wp), generator=gen, device=dev)
    control = torch.rand((1, 3, T, Hp, Wp), generator=gen, device=dev)
    ref_image = torch.rand((1, 3, 1, Hp, Wp), generator=gen, device=dev)
    mask = torch.ones((1, 1, T, Hp, Wp), device=dev)
    mask[:, :, 0] = 0.0                       # first frame known
    pipe.enable_riflex(k=6, L_test=51)
    if os.environ.get("FLEXAM_ATTENTION") or os.environ.get(
            "FLEXAM_INT8_AUTO") == "0":
        raise AssertionError("generate_long: FLEXAM_ATTENTION / "
                             "FLEXAM_INT8_AUTO must be unset for the auto "
                             "ladder")
    attention._default_backend.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peaks = StagePeaks()
    stage, step_times = {}, []

    reset_launch_counts()
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning(video, mask, control, None, None,
                                     ref_image)
    torch.cuda.synchronize()
    stage["prepare_streamed_encode"] = time.perf_counter() - t1
    peaks.mark("prepare_streamed_encode")
    del video, control, mask
    _, lt, lh, lw = cond["latent_shape"]
    tokens = (lt + 1) * (lh // 2) * (lw // 2)
    if tokens != LONG_TOKENS or not cond["first_frame_known"]:
        raise AssertionError(f"generate_long: {tokens} tokens, first frame "
                             f"known {cond['first_frame_known']}")

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())
        if done == total:
            peaks.mark("denoise_2_steps")

    t_den = time.perf_counter()
    out = pipe.generate_from_cond(cond, context, num_inference_steps=2,
                                  guidance_scale=6.0, seed=SEED,
                                  progress_cb=progress)
    t_end = time.perf_counter()
    peaks.mark("decode_streamed")
    counts = launch_counts()
    stage["denoise_2_steps"] = step_times[-1] - t_den
    stage["decode_streamed"] = t_end - step_times[-1]
    peak = peaks.peak()
    steps = [b - a for a, b in zip([t_den] + step_times[:-1], step_times)]
    layers = pipe.cfg.dit.num_layers
    if counts["int8_attention"] != 2 * layers or counts["flash_attention"]:
        raise AssertionError(f"generate_long: launches {counts}; expected "
                             f"int8_attention {2 * layers} and "
                             "flash_attention 0")
    missing = [k for k in LONG_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"generate_long: never launched: {missing}")
    if out.shape != (1, 3, T, Hp, Wp) or not np.isfinite(out).all() \
            or out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"generate_long: output {out.shape}, range "
                             f"[{out.min()}, {out.max()}]")
    out_range = [float(out.min()), float(out.max())]
    del out
    results["int8_attention"]["launches"] = counts["int8_attention"]

    # one step with video self-attention block-sparse (B5)
    os.environ["FLEXAM_ATTENTION"] = "sparse"
    attention._default_backend.cache_clear()
    try:
        reset_launch_counts()
        t1 = time.perf_counter()
        lat = pipe.denoise(cond, context, num_inference_steps=1,
                           guidance_scale=6.0, seed=SEED)
        torch.cuda.synchronize()
        stage["sparse_denoise_1_step"] = time.perf_counter() - t1
        sparse_counts = launch_counts()
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    if (sparse_counts["sparse_attention"] != layers
            or sparse_counts["flash_attention"]
            or sparse_counts["int8_attention"]):
        raise AssertionError(f"generate_long sparse step: launches "
                             f"{sparse_counts}; expected sparse_attention "
                             f"{layers}, flash and int8 0")
    if not bool(lat.isfinite().all().item()):
        raise AssertionError("generate_long sparse step: non-finite latents")
    results["sparse_attention"]["launches"] = sparse_counts["sparse_attention"]
    emit("generate_long", t0, frames=T, tokens=tokens, riflex={"k": 6,
                                                                "L_test": 51},
         stages=stage, step_seconds=steps, output_shape=[1, 3, T, Hp, Wp],
         output_range=out_range, peak_memory_allocated_gb=peak,
         resident_at_start_gb=peaks.resident_gb,
         peak_memory_allocated_gb_by_stage=peaks.gb,
         launches=counts, sparse_step_launches=sparse_counts)

    # where a long step's time goes: one more step of each, profiled
    t0 = time.perf_counter()
    prof = {"int8_auto": profile_forward(lambda: pipe.denoise(
        cond, context, num_inference_steps=1, guidance_scale=6.0, seed=SEED))}
    os.environ["FLEXAM_ATTENTION"] = "sparse"
    attention._default_backend.cache_clear()
    try:
        prof["sparse"] = profile_forward(lambda: pipe.denoise(
            cond, context, num_inference_steps=1, guidance_scale=6.0,
            seed=SEED))
    finally:
        del os.environ["FLEXAM_ATTENTION"]
        attention._default_backend.cache_clear()
    pipe.disable_riflex()
    emit("denoise_long_profile", t0, **prof)


# ---------------------------------------------------------------------------

KERNELS = {
    "flash_attention": ("flexam_tpu_torch/csrc/flash_attention.cu",
                        "flexam_tpu/ops/flash_attention.py:34"),
    "single_kv_attention": ("flexam_tpu_torch/csrc/flash_attention.cu",
                            "flexam_tpu/ops/flash_attention.py:101"),
    "rmsnorm_rope": ("flexam_tpu_torch/csrc/rmsnorm_rope.cu",
                     "flexam_tpu/ops/fused.py:167"),
    "ln_mod_binary": ("flexam_tpu_torch/csrc/ln_modulation.cu",
                      "flexam_tpu/ops/fused.py:377"),
    "ln_mod_bcast": ("flexam_tpu_torch/csrc/ln_modulation.cu",
                     "flexam_tpu/ops/fused.py:403"),
    "sparse_attention": ("flexam_tpu_torch/csrc/sparse_attention.cu",
                         "flexam_tpu/ops/sparse_attention.py:163"),
    "int8_attention": ("flexam_tpu_torch/csrc/int8_attention.cu",
                       "flexam_tpu/ops/int8_attention.py:42"),
}
# the kernels each path must launch (the long path's B5 runs in its sparse
# step, checked there)
MAIN_PATH_KERNELS = ("flash_attention", "single_kv_attention", "rmsnorm_rope",
                     "ln_mod_binary", "ln_mod_bcast")
LONG_PATH_KERNELS = ("int8_attention", "single_kv_attention", "rmsnorm_rope",
                     "ln_mod_binary")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import flexam_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the flexam_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    if Path(flexam_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: flexam_tpu_torch was imported from "
              f"{flexam_tpu_torch.__file__}, not from beside this script",
              file=sys.stderr)
        return 3
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.ops import build
    from flexam_tpu_torch.tools.attention_ab import (ptxas_resources,
                                                     wgmma_notes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    results = {}

    t0 = time.perf_counter()
    emit("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         nvidia_smi=card, tf32_matmul=False, tf32_cudnn=False)

    t0 = time.perf_counter()
    build.library()
    log = Path(build.build_info.get("log", "")) if build.build_info.get(
        "log") else None
    text = log.read_text() if log else ""
    lib = build.library()
    emit("build", t0, nvcc_seconds=build.build_info["seconds"],
         nvcc_compile_seconds=build.build_info.get("compile_seconds"),
         cached=build.build_info["cached"], ptxas=ptxas_resources(text),
         wgmma_notes=wgmma_notes(text),
         attention_smem_bytes=lib.flexam_attention_smem_bytes(),
         int8_attention_smem_bytes=lib.flexam_int8_attention_smem_bytes(),
         attention_sass=hopper_sass(Path(build.build_info["path"])))

    phase_kernels(dev, results)
    torch.cuda.empty_cache()
    phase_reference_check(dev)
    dit_params = phase_dit_flagship(dev, WAN22_5B_FLEXAM)
    torch.cuda.empty_cache()
    pipe, context = phase_generate(dev, WAN22_5B_FLEXAM, dit_params, results)
    del dit_params
    torch.cuda.empty_cache()
    phase_generate_long(dev, pipe, context, results)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({k: r[k] for k in ("tflops", "gbps", "bound_share", "copy_ms")
                if k in r})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
