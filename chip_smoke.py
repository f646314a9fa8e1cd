#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`flexam_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with "phase" and "seconds" when it ends:

  env                  torch / CUDA versions and the card (nvidia-smi);
  build                the CUDA kernels built from csrc/ by one nvcc call;
  kernels              B1, B2, B3 and B4 (both modes) at the flagship
                       shapes, each held to its plain PyTorch version, with
                       its time, its bound and the library yardstick;
  reference_check      a small head_dim-128 DiT through the kernels on the
                       card against the same DiT on the CPU (plain path);
  dit_forward_flagship one DiT forward at full width (Wan2.2-Fun-5B,
                       512x896x97f: 11,648 tokens with the ref block, CFG
                       batch 2), random bf16 weights made on the card;
  generate             the main path: the full-width model (umT5-XXL, the
                       48-channel VAE, the DiT) on 512x896x17f with the
                       first frame known, 4 Euler steps at CFG 6.0, T5
                       released after encoding; then a 1-step denoise with
                       no known frame (the broadcast B4 mode). Launch counts
                       are reset just before and read just after.

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
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
SEED = 1234
FLAGSHIP_LATENT = (25, 32, 56)     # 97 frames at 512 x 896, 16x VAE
GENERATE_VIDEO = (17, 512, 896)    # frames, height, width of the main path


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over `iters` runs, each timed with CUDA
    events, after `warmup` untimed runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
        lines[name] = dict(
            err, ms=cuda_ms(lambda: fn(q, k, v), 10),
            plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, q_chunk=1024),
                             3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), 10),
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
    got = fused.rmsnorm_rope(x, gamma, cos, sin, H)
    ref = fused.rmsnorm_rope_plain(x, gamma, cos, sin, H)
    nbytes = 2.0 * 2 * x.numel() + 2 * DIM + 4.0 * 2 * cos.numel()
    bms, by = bound_ms(10.0 * x.numel(), nbytes)
    lines["rmsnorm_rope"] = dict(
        check_rmsnorm_rope(got, ref, "rmsnorm_rope"),
        ms=cuda_ms(lambda: fused.rmsnorm_rope(x, gamma, cos, sin, H), 20),
        plain_ms=cuda_ms(lambda: fused.rmsnorm_rope_plain(x, gamma, cos, sin,
                                                          H), 10),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"x [{B},{L},{DIM}] bf16, tables [{L},{D // 2}] fp32")

    # B4 both modes: binary (TI2V first frame known) and broadcast
    mask = torch.ones((B, L), device=dev)
    mask[:, 448:896] = 0.0     # the first video frame after the ref block
    for name, terms, m in (("ln_mod_binary", (B, 2, DIM), mask),
                           ("ln_mod_bcast", (B, DIM), None)):
        sh, sc = randn(*terms, dtype=torch.float32), randn(
            *terms, dtype=torch.float32)
        got = fused.ln_modulation(x, sh, sc, mask=m)
        ref = fused.ln_modulation_plain(x, sh, sc, mask=m)
        nbytes = (2.0 * 2 * x.numel() + 4.0 * 2 * sh.numel()
                  + (4.0 * m.numel() if m is not None else 0.0))
        bms, by = bound_ms(10.0 * x.numel(), nbytes)
        lines[name] = dict(
            check_ln_modulation(got, ref, sh, m, name),
            ms=cuda_ms(lambda: fused.ln_modulation(x, sh, sc, mask=m), 20),
            plain_ms=cuda_ms(lambda: fused.ln_modulation_plain(x, sh, sc,
                                                               mask=m), 10),
            library_ms=None, bound_ms=bms, bound_by=by,
            shape=f"x [{B},{L},{DIM}] bf16, shift/scale {list(terms)} fp32")
    results.update(lines)
    emit("kernels", t0, kernels=sorted(lines), **lines)


def phase_reference_check(dev) -> None:
    """A small head_dim-128 DiT through the kernels on the card, against the
    same weights and inputs through the plain versions on the CPU (bf16
    both). Bound: 5e-2 of max |ref| (bf16 over 2 blocks; the two devices
    order their sums differently)."""
    import torch
    from flexam_tpu_torch.config import DiTConfig
    from flexam_tpu_torch.models.dit import dit_forward, init_dit_params

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


def phase_generate(dev, cfg, dit_params, results: dict) -> None:
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
    torch.cuda.reset_peak_memory_stats()
    stage = {}
    step_times = []

    reset_launch_counts()
    t1 = time.perf_counter()
    context = pipe.encode_prompt("a red fox runs through fresh snow")
    torch.cuda.synchronize()
    stage["encode"] = time.perf_counter() - t1
    pipe.release_t5()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cond = pipe.prepare_conditioning(video, mask, control, depth, cos_videos,
                                     ref_image)
    torch.cuda.synchronize()
    stage["prepare"] = time.perf_counter() - t1
    if not cond["first_frame_known"] or not cond["per_token_t"]:
        raise AssertionError("generate: expected the binary-timestep path")

    def progress(done, total):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter())

    t_den = time.perf_counter()
    out = pipe.generate_from_cond(cond, context, num_inference_steps=4,
                                  guidance_scale=6.0, seed=SEED,
                                  progress_cb=progress)
    t_end = time.perf_counter()
    stage["denoise"] = step_times[-1] - t_den
    stage["decode"] = t_end - step_times[-1]
    peak = torch.cuda.max_memory_allocated() / 1e9
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
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for k, n in counts.items():
        results.setdefault(k, {})["launches"] = n
    emit("generate", t0, setup_seconds=round(t_setup, 3),
         stages=stage, step_seconds=[b - a for a, b in
                                     zip([t_den] + step_times[:-1],
                                         step_times)],
         output_shape=list(out.shape), output_range=[float(out.min()),
                                                     float(out.max())],
         peak_memory_allocated_gb=peak, frames=T, launches=counts)


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
}


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
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log else [])
    emit("build", t0, nvcc_seconds=build.build_info["seconds"],
         cached=build.build_info["cached"], ptxas=ptxas)

    phase_kernels(dev, results)
    torch.cuda.empty_cache()
    phase_reference_check(dev)
    dit_params = phase_dit_flagship(dev, WAN22_5B_FLEXAM)
    torch.cuda.empty_cache()
    phase_generate(dev, WAN22_5B_FLEXAM, dit_params, results)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
