"""Serving-session benchmark: N sequential flagship generations on the card,
each timed by phase.

Port of `flexam_tpu/tools/serving_bench.py`. A session builds the 5B DiT
and the VAE once (random weights from fixed seeds: throughput does not
depend on the values), quantizes the DiT in the chosen mode, then runs N
times: prepare the conditioning from tracks (the device rasterizer and the
VAE encode), the CFG flow-matching denoise, and the streamed decode to
uint8 on the host. Modes:

  bf16     the default: the bf16 DiT stays resident through the decode (the
           H100's 80 GB holds it; the JAX package's 16 GB chip could not)
  int8     block linears int8 (`ops/qlinear.py`): half the resident bytes,
           the block GEMMs as int8 GEMMs
  fp8      float8-e4m3 weight storage (`utils/fp8.py`): half the resident
           bytes, cast to bf16 where used

`--attention sparse` runs video self-attention block-sparse (B5) on top of
the mode, `--cfg-skip R` drops the uncond branch for the last R fraction of
the steps, `--riflex K` turns on RIFLEx for the clip's latent frame count.

Usage (on the card):
  python -m flexam_tpu_torch.tools.serving_bench --mode int8 --runs 5
  python -m flexam_tpu_torch.tools.serving_bench --mode bf16 --attention sparse
  python -m flexam_tpu_torch.tools.serving_bench --platform cpu --tiny \
      --size 32 32 --frames 9 --steps 2

Prints one JSON line a run {run, mode, prepare_s, denoise_s, decode_s,
e2e_s, steps_per_s, video_shape, latents_finite, and attention /
sparse_window / cfg_skip / riflex_k / frames where set}, then a summary
line {summary, mode, runs, init_s, warm_medians, run0_e2e_s, the resident
DiT's bytes and leaf dtypes, and on the card the peak allocated memory}:
JAX's format, less its link probe (`probe_rtt_ms`, `healthy`). Times are host clock around work that
ends in `torch.cuda.synchronize()`, unrounded. `video_shape` is the port's
decode layout, [B, 3, T, H, W] (JAX's is [B, T, H, W, 3]).

Workload: the reference's default geometry (512x896x97f, 50 CFG steps)
from an image and synthetic linear tracks. The text context is random,
with no umT5 tower, as in JAX: an encode is once per prompt, not a serving
loop cost. The demo's 40.9 GB peak (PERF.md) comes with a resident umT5;
this session's does not.

Not ported: `bf16-offload` (the 16 GB chip's offload, ROADMAP A15) raises;
`--aot-cache`, `--steps-per-launch`, the link probe and the compile cache
are TPU workarounds (A15). `--tiny` runs on either device; on the card its
head_dim 24 takes the dispatcher's exact branch (`core.attention.
exact_attention`), as JAX's takes `xla_attention`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(f"[serve_bench] {msg}", file=sys.stderr, flush=True)


def synthetic_inputs(height, width, frames, n_side=3):
    """First frame (bright blob on a gradient) + linear tracks riding it."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([xs / width, ys / height, 0.5 * np.ones_like(xs)])
    p0 = np.array([width * 0.25, height * 0.3])
    p1 = np.array([width * 0.7, height * 0.7])
    sig = min(height, width) / 10.0
    g = np.exp(-(((xs - p0[0]) ** 2 + (ys - p0[1]) ** 2) / (2 * sig * sig)))
    frame = np.clip(base + g[None] * 0.7, 0, 1)[None, :, None]   # [1,3,1,H,W]
    centers = np.linspace(p0, p1, frames)
    offs = np.linspace(-sig, sig, n_side)
    grid = np.stack(np.meshgrid(offs, offs), -1).reshape(-1, 2)
    pts = centers[:, None, :] + grid[None]
    depth = np.full((frames, pts.shape[1], 1), 0.5, np.float32)
    tracks = np.concatenate([pts.astype(np.float32), depth], -1)
    return frame.astype(np.float32), tracks


def tree_bytes(tree) -> tuple:
    """(bytes, {dtype name: leaf count}) of a parameter tree."""
    from flexam_tpu_torch.io.convert import tree_leaves

    leaves = tree_leaves(tree)
    dtypes = {}
    for t in leaves:
        name = str(t.dtype).replace("torch.", "")
        dtypes[name] = dtypes.get(name, 0) + 1
    return sum(t.nbytes for t in leaves), dtypes


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="bf16",
                    choices=("bf16", "bf16-offload", "fp8", "int8"))
    ap.add_argument("--attention", default="default",
                    choices=("default", "sparse"),
                    help="sparse = block-sparse video self-attention (B5) "
                         "on top of the mode")
    ap.add_argument("--sparse-window", type=int, default=2)
    ap.add_argument("--cfg-skip", type=float, default=0.0,
                    help="cfg_skip_ratio for the denoise loop")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, nargs=2, default=(512, 896),
                    metavar=("H", "W"))
    ap.add_argument("--frames", type=int, default=97)
    ap.add_argument("--guidance", type=float, default=6.0)
    ap.add_argument("--riflex", type=int, default=None, metavar="K",
                    help="RIFLEx long-video RoPE: rescale the K-th temporal "
                         "frequency for this run's latent frame count")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config; pair with --size 32 32 --frames 9 "
                         "--steps 2")
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; none or cuda on the card")
    return ap


def main(argv=None):
    """Run a session; returns (records, summary) after printing them."""
    args = build_argparser().parse_args(argv)
    if args.mode == "bf16-offload":
        raise NotImplementedError(
            "--mode bf16-offload is the 16 GB TPU chip's DiT offload around "
            "the decode; it is not ported (ROADMAP A15): the H100 keeps the "
            "bf16 DiT resident (--mode bf16)")
    import torch

    from flexam_tpu_torch.demo import _device
    from flexam_tpu_torch.device import resolve_device

    device = resolve_device(_device(args.platform))
    saved_env = {k: os.environ.get(k)
                 for k in ("FLEXAM_ATTENTION", "FLEXAM_SPARSE_WINDOW")}
    if args.attention == "sparse":
        # resolved per latent geometry by the pipeline's _resolve_attn_fn
        os.environ["FLEXAM_ATTENTION"] = "sparse"
        os.environ["FLEXAM_SPARSE_WINDOW"] = str(args.sparse_window)
    try:
        return _session(args, device, torch)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(device, torch):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _session(args, device, torch):
    from flexam_tpu_torch.config import WAN22_5B_FLEXAM, tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = tiny_test_config() if args.tiny else WAN22_5B_FLEXAM
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    dit_params = init_dit_params(cfg.dit, seed=0, dtype=dtype, device=device)
    _sync(device, torch)
    log(f"DiT init {time.perf_counter() - t0:.1f}s on {device}")
    t0 = time.perf_counter()
    vae_params = init_vae_params(cfg.vae, seed=1, dtype=dtype, device=device)
    _sync(device, torch)
    log(f"VAE init {time.perf_counter() - t0:.1f}s")

    quant = {"fp8": "fp8", "int8": "int8"}.get(args.mode)
    models = FlexAMModels(cfg=cfg, dit_params=dit_params,
                          vae_params=vae_params)
    del dit_params, vae_params          # the pipeline owns the weights now
    t0 = time.perf_counter()
    pipe = FlexAMGenerationPipeline(models, device=device, quant=quant,
                                    compute_dtype=dtype)
    _sync(device, torch)
    if quant:
        log(f"quantize({quant}) {time.perf_counter() - t0:.1f}s")

    h, w = args.size
    frame, tracks = synthetic_inputs(h, w, args.frames)
    ctx = torch.from_numpy(np.random.RandomState(0).randn(
        2, cfg.t5.text_length, cfg.dit.text_dim) * 0.02).to(device, dtype)
    if args.riflex is not None:
        lat_frames = 1 + (args.frames - 1) // cfg.vae.temporal_compression_ratio
        pipe.enable_riflex(k=args.riflex, L_test=lat_frames)
        log(f"RIFLEx on: k={args.riflex}, L_test={lat_frames}")
    _sync(device, torch)
    init_s = time.perf_counter() - t0

    records = []
    for run in range(args.runs):
        rec = {"run": run, "mode": args.mode}
        if args.attention != "default":
            rec["attention"] = args.attention
            rec["sparse_window"] = args.sparse_window
        if args.cfg_skip:
            rec["cfg_skip"] = args.cfg_skip
        if args.riflex is not None:
            rec["riflex_k"] = args.riflex
            rec["frames"] = args.frames
        t_run = time.perf_counter()

        t0 = time.perf_counter()
        cond = pipe.prepare_conditioning_from_tracks(
            tracks, None, h, w, point_wise=4, first_frame=frame)
        _sync(device, torch)
        rec["prepare_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        latents = pipe.denoise(cond, ctx, num_inference_steps=args.steps,
                               guidance_scale=args.guidance, seed=run,
                               cfg_skip_ratio=args.cfg_skip)
        _sync(device, torch)
        dt = max(time.perf_counter() - t0, 1e-6)
        rec["denoise_s"] = dt
        rec["steps_per_s"] = args.steps / dt
        rec["latents_finite"] = bool(torch.isfinite(latents).all())

        t0 = time.perf_counter()
        u8 = pipe.decode_u8(latents)      # on the host: the copy syncs
        rec["decode_s"] = time.perf_counter() - t0
        rec["e2e_s"] = time.perf_counter() - t_run
        rec["video_shape"] = list(u8.shape)
        del cond, latents, u8
        print(json.dumps(rec), flush=True)
        records.append(rec)

    warm = records[1:] or records
    med = {k: float(np.median([r[k] for r in warm]))
           for k in ("prepare_s", "denoise_s", "decode_s", "e2e_s",
                     "steps_per_s")}
    dit_bytes, dit_dtypes = tree_bytes(pipe.models.dit_params)
    summary = {"summary": True, "mode": args.mode, "runs": args.runs,
               "init_s": init_s, "warm_medians": med,
               "run0_e2e_s": records[0]["e2e_s"],
               "dit_bytes": dit_bytes, "dit_dtypes": dit_dtypes}
    if cuda:
        summary["peak_alloc_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if args.attention != "default":
        summary["attention"] = args.attention
        summary["sparse_window"] = args.sparse_window
    if args.cfg_skip:
        summary["cfg_skip"] = args.cfg_skip
    if args.riflex is not None:
        summary["riflex_k"] = args.riflex
        summary["frames"] = args.frames
    print(json.dumps(summary), flush=True)
    return records, summary


if __name__ == "__main__":
    main()
