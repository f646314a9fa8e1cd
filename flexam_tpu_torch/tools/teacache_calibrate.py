"""TeaCache calibration: fit the rel-L1 -> residual-change polynomial for
given weights, so that the skip rule fires at representative rates.

Port of `flexam_tpu/tools/teacache_calibrate.py`. TeaCache
(`FlexAM/models/cache_utils.py:21-77`) skips the block stack while a
polynomial of the rel-L1 change of the timestep modulation accumulates
below a threshold; the reference's table was fitted for its own weights.
For any weights:

  1. `collect_signals` / `collect_signals_trajectory`: run a denoise
     trajectory with the plain forward and record, per step pair, the
     rel-L1 of the modulated input and the relative L1 change of the block
     stack's residual (what TeaCache re-applies when it skips);
  2. `fit_coefficients`: numpy's degree-4 polyfit through the pairs, the
     reference table's form;
  3. hand the coefficients to `pipeline.denoise(teacache_coefficients=)` /
     `dit_forward_teacache(coefficients=)`.

`train_to_smooth` trains a small DiT with the port's own `train.py` loop
on a smooth synthetic latent video, which gives the smooth velocity field
that trained checkpoints have and random ones lack. The initial noise and
the training noise come from `torch.Generator`s (or explicit tensors);
the context, where JAX draws it from its key, too.

    python -m flexam_tpu_torch.tools.teacache_calibrate \
        [--ckpt path/transformer] [--steps 12] [--latent F H W] [--json out]
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.config import DiTConfig
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.models.dit import _dit_blocks, _dit_prepare


def _rel(a: torch.Tensor, prev: torch.Tensor) -> float:
    return float((a - prev).abs().mean() / (prev.abs().mean() + 1e-12))


@torch.no_grad()
def collect_signals(
    params: dict,
    cfg: DiTConfig,
    xs,                            # [n_steps, B, C, F, H, W] trajectory
    ts,                            # [n_steps, B] timesteps
    context: torch.Tensor,
    density: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    additional_control: Optional[torch.Tensor] = None,
    full_ref: Optional[torch.Tensor] = None,
    rope_tables: Optional[torch.Tensor] = None,
    attn_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per consecutive step pair: (rel-L1 of the modulated e0, relative L1
    change of the block-stack residual), the quantities
    `dit_forward_teacache` thresholds on. The forward computes in the
    context's dtype."""
    from flexam_tpu_torch.core.attention import attention
    attn_fn = attn_fn or attention
    dev = context.device
    rels, outs = [], []
    prev_mod = prev_res = None
    for x, t in zip(xs, ts):
        x = torch.as_tensor(x).to(dev, context.dtype)
        t = torch.as_tensor(t).to(dev, torch.float32)
        tokens, e0, de0, _, _, cos, sin, ctx, _, _ = _dit_prepare(
            params, cfg, x, t, context, density, y, additional_control,
            full_ref, rope_tables, None, None)
        mod = (e0[1][:, 0] if isinstance(e0, tuple) else e0[:, -1]).float()
        out = _dit_blocks(params, cfg, tokens, e0, de0, cos, sin, ctx,
                          attn_fn)
        res = (out - tokens).float()
        if prev_mod is not None:
            rels.append(_rel(mod, prev_mod))
            outs.append(_rel(res, prev_res))
        prev_mod, prev_res = mod, res
    return np.asarray(rels), np.asarray(outs)


@torch.no_grad()
def collect_signals_trajectory(
    params: dict,
    cfg: DiTConfig,
    latent_shape: Tuple[int, ...],     # (B, C, F, H, W)
    context: torch.Tensor,
    num_steps: int = 12,
    shift: float = 5.0,
    seed: int = 0,
    guidance_scale: float = 6.0,
    latents: Optional[torch.Tensor] = None,
    **cond_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Calibration signals along a real Euler flow-match trajectory from
    `latents` (default: N(0, 1) from a generator seeded with `seed`).
    `guidance_scale` is unused, as in JAX."""
    from flexam_tpu_torch.models.dit import dit_forward
    from flexam_tpu_torch.sampling import (build_schedule,
                                           sampler_init_state, sampler_step,
                                           schedule_arrays)

    dev = context.device
    tables = build_schedule("euler", num_steps, shift=shift)
    sched = schedule_arrays(tables, dev)
    if latents is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        latents = torch.randn(latent_shape, generator=gen, device=dev)
    state = sampler_init_state(torch.as_tensor(latents).to(dev),
                               tables.order)
    b = latent_shape[0]
    xs, ts = [], []
    for i in range(num_steps):
        t = torch.full((b,), float(tables.timesteps[i]), device=dev)
        xs.append(state[0])
        ts.append(t)
        v = dit_forward(params, cfg, state[0].to(context.dtype), t, context,
                        **cond_kwargs)
        state, _ = sampler_step(sched, tables.convert, state, v.float(), i)
    return collect_signals(params, cfg, xs, ts, context, **cond_kwargs)


def fit_coefficients(rels: np.ndarray, outs: np.ndarray,
                     degree: int = 4) -> Tuple[float, ...]:
    """Degree-4 polyfit (the reference table's form,
    `cache_utils.py:4-18`), guarded for short or degenerate samples."""
    if len(rels) <= degree:
        # underdetermined: a linear fit padded with zeros
        k = max(1, len(rels) - 1)
        c = np.polyfit(rels, outs, k)
        c = np.concatenate([np.zeros(degree + 1 - len(c)), c])
        return tuple(float(v) for v in c)
    return tuple(float(v) for v in np.polyfit(rels, outs, degree))


def smooth_latents(cfg: DiTConfig, batch: int,
                   latent_shape: Tuple[int, int, int],
                   device) -> torch.Tensor:
    """The fixed smooth target [B, out_dim, F, H, W]: sin(2 pi (f + h))
    cos(2 pi w) on [0, 1] grids, scaled by 1 + c / C per channel."""
    f, h, w = latent_shape
    ff, hh, ww = torch.meshgrid(
        torch.linspace(0, 1, f, device=device),
        torch.linspace(0, 1, h, device=device),
        torch.linspace(0, 1, w, device=device), indexing="ij")
    base = torch.sin(2 * torch.pi * (ff + hh)) * torch.cos(2 * torch.pi * ww)
    c = cfg.out_dim
    scale = 1.0 + torch.arange(c, dtype=torch.float32, device=device) / c
    lat = base[None] * scale[:, None, None, None]
    return lat[None].expand(batch, c, f, h, w).contiguous()


def train_to_smooth(
    cfg: DiTConfig,
    num_steps: int = 40,
    batch: int = 1,
    latent_shape: Tuple[int, int, int] = (2, 8, 8),   # (F, H, W) latent
    lr: float = 2e-4,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    params: Optional[dict] = None,
    context: Optional[torch.Tensor] = None,
) -> dict:
    """Train a small DiT with the port's flow-matching loop until its
    outputs evolve smoothly along the sigma schedule. The target is a fixed
    smooth latent video, so the learned velocity field becomes a smooth
    function of (x, t). `params` / `context` replace the seeded init and
    the seeded N(0, 1) context [batch, 4, text_dim]. Returns {"params",
    "losses", "context"}."""
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.train import adamw, train_step, trainable

    dev = resolve_device(device)
    if params is None:
        params = init_dit_params(cfg, seed=seed, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    if context is None:
        context = torch.randn((batch, 4, cfg.text_dim), generator=gen,
                              device=dev).to(dtype)
    lat = smooth_latents(cfg, batch, latent_shape, dev)
    opt = adamw(trainable(params), lr)
    losses = []
    for _ in range(num_steps):
        params, loss = train_step(params, opt, cfg,
                                  {"latents": lat, "context": context},
                                  generator=gen)
        losses.append(float(loss))
    for t in opt.params:
        t.requires_grad_(False)
    return {"params": params, "losses": losses, "context": context}


def main(argv=None) -> int:
    """Calibrate coefficients for a checkpoint (default: random 5B weights)
    at a scaled latent shape; prints one JSON line."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None,
                    help="DiT checkpoint dir (default: random 5B weights)")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--latent", type=int, nargs=3, default=[9, 16, 16],
                    metavar=("F", "H", "W"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", default="cuda",
                    help="torch device (cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.platform)

    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    cfg = WAN22_5B_FLEXAM.dit
    if args.ckpt:
        from flexam_tpu_torch.io.checkpoints import load_dit_checkpoint
        params = load_dit_checkpoint(args.ckpt, cfg, dtype=torch.bfloat16,
                                     device=dev)
    else:
        from flexam_tpu_torch.models.dit import init_dit_params
        params = init_dit_params(cfg, seed=0, dtype=torch.bfloat16,
                                 device=dev)
    f, h, w = args.latent
    gen = torch.Generator(device=dev).manual_seed(1)
    ctx = torch.randn((1, 16, cfg.text_dim), generator=gen,
                      device=dev).to(torch.bfloat16)
    # bare-DiT calibration shape: x carries in_dim channels when no y
    rels, outs = collect_signals_trajectory(
        params, cfg, (1, cfg.in_dim, f, h, w), ctx, num_steps=args.steps)
    coeffs = fit_coefficients(rels, outs)
    result = {"coefficients": list(coeffs),
              "rel_l1": rels.tolist(), "rel_residual": outs.tolist()}
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
