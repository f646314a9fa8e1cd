"""Train-to-follow: FlexAM's property, shown end to end.

Port of `flexam_tpu/tools/control_follow.py`. FlexAM exists so that the
generated video obeys the rasterized motion control. This loop shows it
on the port's own components: train a model on track-conditioned clips,
generate from held-out tracks, re-track the output and check that the
recovered motion matches the conditioning.

  1. synthetic data: a Gaussian blob travels a random linear track
     (`make_blob_clip`, `tracks_from_centers`);
  2. `train_vae_recon`: the tiny Wan2.2 VAE learns to reconstruct the
     clips (MSE plus a temporal-difference term), `optax.adam` as
     `torch.optim.Adam`;
  3. `train_dit_control`: the tiny FlexAM DiT trains with the port's
     flow-matching step (`train.flow_match_loss`, AdamW) on conditioning
     built by the real pipeline (`prepare_conditioning_from_tracks`),
     under optax's `cosine_decay_schedule(lr, n, alpha=0.15)` in closed
     form;

Both trainers run through `train.run_steps`, which replays a step as a
CUDA graph on the card (a tiny model's step is launch-bound there).
  4. `evaluate_adherence`: generate from held-out tracks through
     `generate_from_cond`, then score the brightness-centroid trajectory
     and the displacement the device flow tracker (`perception/
     flow_device`, JAX's `flow_jax`) recovers, each against the conditioned
     track and a mismatched alternative;
  5. `dump_artifacts`: the reference's artifact set (the control videos
     and the generated clip) through `utils.media.save_video`, which
     writes `.mp4.npz` frame dumps where no video encoder is installed.

Noise: JAX draws the training noise, the initial latents and the context
from its keys; the port draws them from `torch.Generator`s seeded alike,
and takes explicit tensors where a test crosses JAX's. `cached_stack`
keeps a trained stack in the port's own `.npz` file
(`io.checkpoints.save_pytree`), beside JAX's cache, never in it.

    python -m flexam_tpu_torch.tools.control_follow --output_dir out
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexam_tpu_torch.config import FlexAMConfig, tiny_test_config
from flexam_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Synthetic track-conditioned clips
# ---------------------------------------------------------------------------


def make_blob_clip(p0, p1, T: int = 9, H: int = 64, W: int = 64,
                   size: float = 16.0) -> Tuple[np.ndarray, np.ndarray]:
    """A bright Gaussian blob moves linearly p0 -> p1 over T frames.
    Returns (video [3, T, H, W] in [0, 1], centers [T, 2] (x, y))."""
    centers = np.linspace(np.asarray(p0, np.float64),
                          np.asarray(p1, np.float64), T)
    vid = np.zeros((3, T, H, W), np.float32) + 0.08
    color = np.array([0.95, 0.85, 0.3], np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    sig = size / 2.4
    for t in range(T):
        cx, cy = centers[t]
        g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sig * sig))
        vid[:, t] += color[:, None, None] * g[None].astype(np.float32)
    return np.clip(vid, 0.0, 1.0), centers.astype(np.float32)


def tracks_from_centers(centers: np.ndarray, size: float = 16.0,
                        n_side: int = 3) -> np.ndarray:
    """Track points riding on the blob: an n_side^2 grid of offsets around
    the center at a constant pseudo-depth, [T, N, 3] (u, v, depth), the
    `track_video_flow` contract the rasterizer consumes."""
    T = centers.shape[0]
    offs = np.linspace(-size * 0.3, size * 0.3, n_side)
    grid = np.stack(np.meshgrid(offs, offs), -1).reshape(-1, 2)
    pts = centers[:, None, :] + grid[None]
    depth = np.full((T, pts.shape[1], 1), 0.5, np.float32)
    return np.concatenate([pts.astype(np.float32), depth], -1)


def control_follow_config() -> FlexAMConfig:
    """`tiny_test_config` with an 8-wide VAE (the blob needs no more, and
    the reconstruction training runs ~4x faster than at 16)."""
    base = tiny_test_config()
    return dataclasses.replace(
        base, vae=dataclasses.replace(base.vae, c_dim=8, dec_dim=8))


def _freeze(params) -> None:
    from flexam_tpu_torch.io.convert import tree_leaves
    for t in tree_leaves(params):
        if torch.is_tensor(t):
            t.requires_grad_(False)


# ---------------------------------------------------------------------------
# Stage 1: VAE reconstruction training
# ---------------------------------------------------------------------------


def vae_recon_loss(params, cfg: FlexAMConfig, x: torch.Tensor):
    """MSE plus twice the MSE of adjacent-frame differences: the re-track
    needs the decoder to reproduce motion, not only each frame."""
    from flexam_tpu_torch.models.vae import vae_decode, vae_encode_mode
    rec = vae_decode(params, cfg.vae, vae_encode_mode(params, cfg.vae, x))
    mse = (rec - x).pow(2).mean()
    tdiff = (torch.diff(rec, dim=2) - torch.diff(x, dim=2)).pow(2).mean()
    return mse + 2.0 * tdiff


def train_vae_recon(cfg: FlexAMConfig, clips: np.ndarray,
                    num_steps: int = 320, batch: int = 2,
                    lr: float = 1e-3, seed: int = 0, device="cuda",
                    params: Optional[dict] = None):
    """MSE autoencoder training of the tiny Wan2.2 VAE on [N, 3, T, H, W]
    clips in [0, 1] (float32; `params` replaces the seeded init). Returns
    (params, losses)."""
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.train import adam, run_steps, trainable

    dev = resolve_device(device)
    if params is None:
        params = init_vae_params(cfg.vae, seed=seed, dtype=torch.float32,
                                 device=dev)
    data = torch.from_numpy(np.asarray(clips, np.float32) * 2.0 - 1.0).to(dev)
    opt = adam(trainable(params), lr)
    # one draw of every step's indices: the stream of JAX's per-step draws
    idx = torch.from_numpy(np.random.RandomState(seed).randint(
        0, clips.shape[0], (num_steps, batch))).to(dev)
    x = data[idx[0]]

    def load(i):
        torch.index_select(data, 0, idx[i], out=x)

    losses = run_steps(opt, num_steps, load,
                       lambda: vae_recon_loss(params, cfg, x))
    _freeze(params)
    return params, losses


# ---------------------------------------------------------------------------
# Stage 2: conditioned DiT training on pipeline-built conditioning
# ---------------------------------------------------------------------------


@torch.no_grad()
def build_training_batches(pipe, clips_and_centers, size: float = 16.0
                           ) -> List[Dict[str, np.ndarray]]:
    """For each (video, centers): the pipeline's rasterizer prepare
    (`prepare_conditioning_from_tracks`, pure control -> video: the clip is
    the video, no mask) and the VAE-encoded target, as `train_step`
    batches in the layout the denoise loop feeds the DiT."""
    from flexam_tpu_torch.models.vae import vae_encode_mode

    out = []
    for vid, centers in clips_and_centers:
        trk = tracks_from_centers(centers, size=size)
        h, w = vid.shape[-2:]
        cond = pipe.prepare_conditioning_from_tracks(
            trk, None, h, w, point_wise=3, video=vid[None])
        y = torch.cat([cond["control_latents"], cond["mask_latents"],
                       cond["masked_video_latents"]], dim=1)
        x0 = vae_encode_mode(pipe.models.vae_params, pipe.cfg.vae,
                             torch.from_numpy(vid[None] * 2.0 - 1.0)
                             .to(pipe.device))
        out.append({
            "latents": x0.float().cpu().numpy(),
            "y": y.float().cpu().numpy(),
            "additional_control": cond["additional_control"].float()
            .cpu().numpy(),
            "full_ref": cond["ref_latents"].float().cpu().numpy(),
        })
    return out


def train_dit_control(cfg: FlexAMConfig, data: List[Dict], ctx: np.ndarray,
                      num_steps: int = 3000, batch: int = 4,
                      lr: float = 2e-3, seed: int = 3, device="cuda",
                      params: Optional[dict] = None, noise=None):
    """Flow-matching training (`train.train_step`'s update) of the tiny
    FlexAM DiT on the conditioned batches under a cosine decay to 0.15 lr.
    `params` replaces the seeded init; `noise(step)`, if given, returns the
    step's (sigma, eps) (a test crosses JAX's). Returns (params, losses)."""
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.train import (adamw, cosine_decay_schedule,
                                        draw_noise, flow_match_loss,
                                        run_steps, trainable)

    dev = resolve_device(device)
    if params is None:
        params = init_dit_params(cfg.dit, seed=1, dtype=torch.float32,
                                 device=dev)
    opt = adamw(trainable(params),
                cosine_decay_schedule(lr, num_steps, alpha=0.15))
    stacked = {k: torch.from_numpy(np.concatenate([d[k] for d in data]))
               .to(dev) for k in data[0]}
    idx = torch.from_numpy(np.random.RandomState(seed).randint(
        0, len(data), (num_steps, batch))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # the tensors a step reads, written in place by `load`
    b = {k: v[idx[0]] for k, v in stacked.items()}
    b["context"] = torch.from_numpy(np.repeat(ctx, batch, 0)).to(dev)
    sigma = torch.empty((batch,), device=dev)
    eps = torch.empty_like(b["latents"])

    def load(i):
        for k, v in stacked.items():
            torch.index_select(v, 0, idx[i], out=b[k])
        s, e = noise(i) if noise is not None else draw_noise(b["latents"],
                                                             gen)
        sigma.copy_(s)
        eps.copy_(e)

    losses = run_steps(opt, num_steps, load, lambda: flow_match_loss(
        params, cfg.dit, b, sigma, eps))
    _freeze(params)
    return params, losses


def train_control_stack(cfg: Optional[FlexAMConfig] = None,
                        n_clips: int = 32, T: int = 13, vae_T: int = 9,
                        H: int = 64, W: int = 64, size: float = 16.0,
                        vae_steps: int = 300, dit_steps: int = 3000,
                        seed: int = 0, verbose: bool = False,
                        device="cuda") -> Dict:
    """The whole training run. Returns {cfg, vae_params, dit_params, ctx,
    vae_losses, dit_losses, train_endpoints, geometry, seconds}."""
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    dev = resolve_device(device)
    cfg = cfg or control_follow_config()
    rng = np.random.RandomState(seed)
    lo = size / 2 + 2
    endpoints = [(rng.uniform(lo, W - lo, 2), rng.uniform(lo, H - lo, 2))
                 for _ in range(n_clips)]
    # T=13 generation keeps the per-frame motion in the LK tracker's range;
    # the causal VAE trains on shorter (vae_T) clips of the same tracks
    clips = [make_blob_clip(p0, p1, T=T, H=H, W=W, size=size)
             for p0, p1 in endpoints]
    vae_clips = [make_blob_clip(p0, p1, T=vae_T, H=H, W=W, size=size)[0]
                 for p0, p1 in endpoints]
    seconds = {}

    t0 = time.time()
    vae_params, vae_losses = train_vae_recon(
        cfg, np.stack(vae_clips), num_steps=vae_steps, seed=seed, device=dev)
    seconds["vae"] = time.time() - t0
    if verbose:
        print(f"[control_follow] VAE {vae_steps} steps {seconds['vae']:.0f}s"
              f" loss {vae_losses[-1]:.4f}", flush=True)

    models = FlexAMModels(cfg=cfg, vae_params=vae_params,
                          dit_params=init_dit_params(
                              cfg.dit, seed=1, dtype=torch.float32,
                              device=dev))
    pipe = FlexAMGenerationPipeline(models, device=dev,
                                    compute_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(2)
    ctx = torch.randn((1, cfg.t5.text_length, cfg.dit.text_dim),
                      generator=gen, device=dev).cpu().numpy()

    t0 = time.time()
    data = build_training_batches(pipe, clips, size=size)
    seconds["prepare"] = time.time() - t0
    t0 = time.time()
    dit_params, dit_losses = train_dit_control(
        cfg, data, ctx, num_steps=dit_steps, seed=seed + 3, device=dev)
    seconds["dit"] = time.time() - t0
    if verbose:
        print(f"[control_follow] DiT {dit_steps} steps {seconds['dit']:.0f}s"
              f" loss {np.mean(dit_losses[-50:]):.4f}", flush=True)
    return {"cfg": cfg, "vae_params": vae_params, "dit_params": dit_params,
            "ctx": ctx, "vae_losses": vae_losses, "dit_losses": dit_losses,
            "train_endpoints": endpoints, "seconds": seconds,
            "geometry": {"T": T, "H": H, "W": W, "size": size}}


# ---------------------------------------------------------------------------
# Stage 3: adherence evaluation
# ---------------------------------------------------------------------------


def centroid_trajectory(video: np.ndarray) -> np.ndarray:
    """Brightness centroid per frame of [3, T, H, W] -> [T, 2] (x, y)."""
    lum = video.mean(0)
    T, H, W = lum.shape
    ys, xs = np.mgrid[0:H, 0:W]
    out = []
    for t in range(T):
        f = np.clip(lum[t] - np.percentile(lum[t], 60), 0, None)
        m = f.sum() + 1e-9
        out.append([(f * xs).sum() / m, (f * ys).sum() / m])
    return np.asarray(out)


def tracker_displacement(video: np.ndarray, start_center: np.ndarray,
                         size: float, device="cuda") -> Optional[np.ndarray]:
    """Re-track [3, T, H, W] with the device flow tracker and return the
    mean end-to-end displacement of the grid points that start on the
    blob (None if the grid misses it)."""
    from flexam_tpu_torch.perception.flow_device import (
        track_video_flow_device)

    tr, _vis = track_video_flow_device(video[None], density=4, iters=6,
                                       radius=9, device=device)
    d0 = tr[0, :, :2]
    on = np.linalg.norm(d0 - start_center, axis=1) < size * 0.45
    if on.sum() == 0:
        return None
    return np.asarray((tr[-1, on, :2] - tr[0, on, :2]).mean(0))


def evaluate_adherence(stack: Dict, cases: Sequence[Tuple[np.ndarray,
                                                          np.ndarray]],
                       num_inference_steps: int = 20, seed: int = 7,
                       artifacts_dir: Optional[str] = None,
                       attn_fn=None, quant: Optional[str] = None,
                       guidance_scale: float = 1.0,
                       t_override: Optional[int] = None,
                       riflex_k: Optional[int] = None, device="cuda",
                       latents=None) -> List[Dict]:
    """Generate from each held-out (p0, p1) case and score adherence, each
    case against its own track and against the other cases' tracks (the
    mismatched alternatives). `attn_fn` / `quant` run the same evaluation
    through another attention or int8 / fp8 linears; `guidance_scale` > 1
    runs the CFG pair; `t_override` generates longer clips than the stack
    trained on, `riflex_k` with RIFLEx for them. `latents` (the initial
    noise, [1, C, T', H', W']) replaces the draw seeded with `seed`."""
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    dev = resolve_device(device)
    cfg = stack["cfg"]
    g = stack["geometry"]
    if t_override is not None:
        g = dict(g, T=int(t_override))
    dit_params = stack["dit_params"]
    if quant:
        # quantization replaces linears in its tree's dicts: new containers
        # (every level) keep the caller's tree as it is
        from flexam_tpu_torch.io.convert import map_leaves
        dit_params = map_leaves(dit_params, lambda key, t, in_block: t)
    models = FlexAMModels(cfg=cfg, dit_params=dit_params,
                          vae_params=stack["vae_params"])
    pipe = FlexAMGenerationPipeline(models, device=dev, attn_fn=attn_fn,
                                    quant=quant,
                                    compute_dtype=torch.float32)
    if riflex_k is not None:
        lt = 1 + (g["T"] - 1) // cfg.vae.temporal_compression_ratio
        pipe.enable_riflex(k=riflex_k, L_test=lt)
    ctx = torch.as_tensor(np.asarray(stack["ctx"], np.float32)).to(dev)
    results = []
    for i, (p0, p1) in enumerate(cases):
        vid, centers = make_blob_clip(p0, p1, T=g["T"], H=g["H"], W=g["W"],
                                      size=g["size"])
        trk = tracks_from_centers(centers, size=g["size"])
        cond = pipe.prepare_conditioning_from_tracks(
            trk, None, g["H"], g["W"], point_wise=3, video=vid[None],
            return_videos=artifacts_dir is not None)
        videos = cond.pop("videos", None)
        gen = pipe.generate_from_cond(
            cond, ctx, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed,
            offload_dit_for_decode=False, latents=latents)[0]
        res = {"case": i, "p0": np.asarray(p0), "p1": np.asarray(p1),
               "centers": centers, "video": gen}
        res["centroid"] = centroid_trajectory(gen)
        res["centroid_err"] = float(np.linalg.norm(
            res["centroid"] - centers, axis=1).mean())
        res["tracker_disp"] = tracker_displacement(gen, centers[0],
                                                   g["size"], device=dev)
        res["cond_disp"] = centers[-1] - centers[0]
        if artifacts_dir:
            dump_artifacts(artifacts_dir, i, videos, gen)
        results.append(res)

    # mismatched-alternative scores (each case against the others' tracks)
    for res in results:
        alt_c = [r["centers"] for r in results if r["case"] != res["case"]]
        res["centroid_err_alt"] = float(min(
            np.linalg.norm(res["centroid"] - a, axis=1).mean()
            for a in alt_c)) if alt_c else None
        if res["tracker_disp"] is not None and alt_c:
            res["tracker_err"] = float(np.linalg.norm(
                res["tracker_disp"] - res["cond_disp"]))
            res["tracker_err_alt"] = float(min(
                np.linalg.norm(res["tracker_disp"] - (a[-1] - a[0]))
                for a in alt_c))
    return results


def dump_artifacts(outdir: str, case: int, videos: Optional[Dict],
                   generated: np.ndarray, fps: int = 8) -> List[str]:
    """The reference's per-run artifact set (`pipelines.py:1852-1903`: the
    tracking, depth and cos control videos and the generated clip), each
    [3, T, H, W] or [1, 3, T, H, W] in [0, 1]. Returns the paths written."""
    from flexam_tpu_torch.utils.media import save_video

    os.makedirs(outdir, exist_ok=True)
    out = [save_video(generated, os.path.join(
        outdir, f"case{case}_generated.mp4"), fps=fps)]
    for name, vid in (videos or {}).items():
        out.append(save_video(vid, os.path.join(
            outdir, f"case{case}_{name}.mp4"), fps=fps))
    return out


# one trained stack serves the callers that share a cache; bump the
# version after changing the training recipe (the stale cache is retrained)
CACHE_VERSION = "v3-blob64x13-vae300t9-dit3000cos"


def default_cache_path() -> str:
    """The port's own cache file under `tests/` (JAX's is
    `tests/.cache_control_follow.npz`; the two trees differ in layout)."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        "tests", ".cache_control_follow_torch.npz")


def cached_stack(cache_path: str, version: str, verbose: bool = True,
                 device="cuda") -> Dict:
    """Train-or-load the control-follow stack, cached on disk under a
    version stamp (`save_pytree` / `restore_pytree` and a `.json` beside
    it)."""
    from flexam_tpu_torch.io.checkpoints import restore_pytree, save_pytree
    from flexam_tpu_torch.io.convert import map_leaves
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.vae import init_vae_params

    dev = resolve_device(device)
    cfg = control_follow_config()
    meta_path = cache_path + ".json"
    if os.path.exists(cache_path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") == version:
            like = {"vae": init_vae_params(cfg.vae, dtype=torch.float32,
                                           device="cpu"),
                    "dit": init_dit_params(cfg.dit, dtype=torch.float32,
                                           device="cpu")}
            params = map_leaves(restore_pytree(cache_path, like),
                                lambda k, t, b: t.to(dev))
            return {"cfg": cfg, "vae_params": params["vae"],
                    "dit_params": params["dit"],
                    "ctx": np.asarray(meta["ctx"], np.float32),
                    "vae_losses": meta["vae_losses"],
                    "dit_losses": meta["dit_losses"],
                    "geometry": meta["geometry"]}

    stack = train_control_stack(cfg=cfg, verbose=verbose, device=dev)
    save_pytree(cache_path, {"vae": stack["vae_params"],
                             "dit": stack["dit_params"]})
    with open(meta_path, "w") as f:
        json.dump({"version": version,
                   "ctx": np.asarray(stack["ctx"]).tolist(),
                   "vae_losses": stack["vae_losses"],
                   "dit_losses": stack["dit_losses"],
                   "geometry": stack["geometry"]}, f)
    return stack


def default_holdout_cases(H: int = 64, W: int = 64,
                          size: float = 16.0) -> List[Tuple]:
    m = size / 2 + 8
    return [(np.array([m, m]), np.array([W - m, H - m])),
            (np.array([W - m, m]), np.array([m, H - m]))]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output_dir", default="control_follow_out")
    ap.add_argument("--vae_steps", type=int, default=320)
    ap.add_argument("--dit_steps", type=int, default=3000)
    ap.add_argument("--n_clips", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--platform", default="cuda",
                    help="torch device (cpu for the plain path)")
    args = ap.parse_args(argv)

    stack = train_control_stack(n_clips=args.n_clips,
                                vae_steps=args.vae_steps,
                                dit_steps=args.dit_steps, verbose=True,
                                device=args.platform)
    results = evaluate_adherence(stack, default_holdout_cases(),
                                 num_inference_steps=args.steps,
                                 artifacts_dir=args.output_dir,
                                 device=args.platform)
    report = []
    for r in results:
        report.append({k: float(r[k]) for k in (
            "centroid_err", "centroid_err_alt", "tracker_err",
            "tracker_err_alt") if r.get(k) is not None})
        print(f"case {r['case']}: centroid err {r['centroid_err']:.1f} px "
              f"(alt {r['centroid_err_alt']:.1f}); tracker err "
              f"{r.get('tracker_err', float('nan')):.1f} "
              f"(alt {r.get('tracker_err_alt', float('nan')):.1f})")
    with open(os.path.join(args.output_dir, "adherence.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"metric": "control_adherence_centroid_px",
                      "value": float(np.mean([r["centroid_err"]
                                              for r in results]))}))


if __name__ == "__main__":
    main()
