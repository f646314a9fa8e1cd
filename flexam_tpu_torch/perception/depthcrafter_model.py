"""The DepthCrafter denoiser: the SVD spatio-temporal UNet driving
video-depth diffusion behind `perception/depthcrafter.py`'s denoiser seam.

Port of `flexam_tpu/perception/depthcrafter_model.py`. The reference's
DepthCrafter branch (`pipelines.py:1307-1360`, disabled at `:1407`)
calls an external pipe built on the published architecture: frames ->
VAE-encoded conditioning latents (channel-concatenated each step) +
per-frame CLIP image embeddings + (fps, motion bucket, noise aug) time
ids -> EDM v-prediction Euler loop over Karras sigmas (two UNet passes a
step, conditional and unconditional) -> VAE decode -> the 3-channel output
the reference collapses to mono depth. The pieces:

  * `models/svd_unet.py`, the UNet;
  * the VAE: `models/flux_vae.py` at SD geometry (`SD_VAE_CONFIG`); with
    the video release's temporal decoder in the file
    (`decoder.time_conv_out`), `models/svd_vae.py` decodes (quant_conv
    honoured);
  * image embeddings: with FLEXAM_SVD_CLIP (an HF
    CLIPVisionModelWithProjection file) the ViT tower of `models/clip.py`
    (antialiased 224 resize, CLIP-normalize, CLS + post-LN + projection);
    without it JAX's deterministic projection of frame statistics.

Noise: JAX draws the latents and the conditioning pixels' noise
augmentation from one `jax.random.PRNGKey(seed)`; the port takes both
explicitly (`latents=` [1, T, 4, h, w] before the sigma scaling, and
`aug_noise=` [T, 3, H, W]), else draws them from a `torch.Generator`
seeded with `seed`. The encode runs in chunks of 16 frames; the decode
whole (the temporal decoder) or in chunks of 16 (the spatial one).

Weights: FLEXAM_DEPTHCRAFTER_CKPT (UNet, published naming) +
FLEXAM_SVD_VAE, coverage-gated by `io/verify_load.check_mapping`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.io.convert import cast_floats
from flexam_tpu_torch.models.flux_vae import (FluxVAEConfig,
                                              flux_vae_decode,
                                              flux_vae_encode,
                                              init_flux_vae_params)
from flexam_tpu_torch.models.svd_unet import (SVDUNetConfig, euler_v_step,
                                              init_svd_unet_params,
                                              karras_sigmas,
                                              svd_unet_forward)

SD_VAE_CONFIG = FluxVAEConfig(ch=128, ch_mult=(1, 2, 4, 4),
                              num_res_blocks=2, z_channels=4,
                              scale_factor=0.18215, shift_factor=0.0)


def _denoise_step(params, cfg: SVDUNetConfig, sample, cond_latents, ctx,
                  ctx_uncond, ids, sigma, sigma_next, guidance):
    """One CFG v-prediction Euler step. sample: [1, T, 4, h, w]; the
    scalars in float32, as JAX's jitted step takes them."""
    sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
    scaled = sample / float(np.sqrt(sigma ** np.float32(2) + np.float32(1)))
    t_cont = torch.full((1,), float(np.float32(0.25) * np.log(sigma)),
                        dtype=torch.float32, device=sample.device)
    v_c = svd_unet_forward(params, cfg, torch.cat([scaled, cond_latents], 2),
                           t_cont, ctx, ids)
    v_u = svd_unet_forward(
        params, cfg, torch.cat([scaled, torch.zeros_like(cond_latents)], 2),
        t_cont, ctx_uncond, ids)
    v = v_u + float(np.float32(guidance)) * (v_c - v_u)
    return euler_v_step(sample.float(), v.float(), sigma,
                        sigma_next).to(sample.dtype)


class DepthCrafterDenoiser:
    """`denoiser(frames [T, h, w, 3] in [0,1], guidance_scale,
    num_inference_steps) -> [T, h, w, 3]` for
    `perception.depthcrafter.predict_depthcrafter`, on `device`."""

    def __init__(self, unet_params: dict, vae_params: dict,
                 cfg: SVDUNetConfig = SVDUNetConfig(),
                 vae_cfg: FluxVAEConfig = SD_VAE_CONFIG,
                 image_embed_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None,
                 fps: float = 7.0, motion_bucket_id: float = 127.0,
                 noise_aug_strength: float = 0.02,
                 dtype=torch.float32, seed: int = 42, device="cuda"):
        # the published conditioning embeds fps - 1 (default 7 -> 6)
        self.device = resolve_device(device)
        self.params = cast_floats(unet_params, dtype)
        self.vae_params = cast_floats(vae_params, dtype)
        self.cfg, self.vae_cfg = cfg, vae_cfg
        self.image_embed_fn = image_embed_fn
        self.decode_fn = decode_fn
        self.added_ids = np.array(
            [[fps - 1.0, motion_bucket_id, noise_aug_strength]], np.float32)
        self.noise_aug = noise_aug_strength
        self.dtype = dtype
        self.seed = seed

    def _encode_frames(self, x: torch.Tensor, chunk: int = 16
                       ) -> torch.Tensor:
        """Frame-chunked VAE encode of [T, 3, H, W] (the spatial encoder is
        exact a frame)."""
        if "quant_conv" in self.vae_params:
            from flexam_tpu_torch.models.svd_vae import svd_vae_encode
            enc = svd_vae_encode
        else:
            enc = flux_vae_encode
        return torch.cat([enc(self.vae_params, self.vae_cfg, x[i:i + chunk])
                          for i in range(0, x.shape[0], chunk)], dim=0)

    def _embed_frames(self, frames: np.ndarray) -> torch.Tensor:
        """[T, h, w, 3] -> [1, T, 1, cross_dim] embeddings, one a frame."""
        t = frames.shape[0]
        if self.image_embed_fn is not None:
            e = np.asarray(self.image_embed_fn(frames), np.float32)
        else:
            # a deterministic projection of frame statistics keeps the
            # conditioning path live without the CLIP checkpoint
            d = self.cfg.cross_attention_dim
            proj = np.random.default_rng(0).standard_normal(
                (48, d)).astype(np.float32) / 7.0
            pooled = frames.reshape(t, -1, 3)
            stats = np.concatenate([
                pooled.mean(1), pooled.std(1),
                np.percentile(pooled, np.linspace(5, 95, 14), axis=1
                              ).transpose(1, 0, 2).reshape(t, -1),
            ], axis=1).astype(np.float32)            # [T, 48]
            e = stats @ proj
        return torch.from_numpy(np.ascontiguousarray(e.reshape(
            1, t, 1, -1))).to(self.device, self.dtype)

    @torch.no_grad()
    def __call__(self, frames: np.ndarray, guidance_scale: float = 1.2,
                 num_inference_steps: int = 25, latents=None,
                 aug_noise=None) -> np.ndarray:
        frames = np.asarray(frames, np.float32)
        t, h, w, _ = frames.shape
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(
            self.device).permute(0, 3, 1, 2)
        x = (x * 2.0 - 1.0).to(self.dtype)
        # the published pipeline noise-augments the conditioning PIXELS
        # before the encode (its strength is the embedded id's)
        if self.noise_aug > 0:
            if aug_noise is None:
                aug_noise = torch.randn(x.shape, generator=gen,
                                        device=self.device)
            noise = torch.as_tensor(np.array(aug_noise, np.float32)
                                    if not torch.is_tensor(aug_noise)
                                    else aug_noise).to(self.device, x.dtype)
            x = x + self.noise_aug * noise
        cond_z = self._encode_frames(x)
        # the published conditioning concats UNSCALED posterior means
        cond_z = (cond_z / self.vae_cfg.scale_factor)[None]
        ctx = self._embed_frames(frames)
        ctx_un = torch.zeros_like(ctx)
        ids = torch.from_numpy(self.added_ids).to(self.device)
        sigmas = karras_sigmas(num_inference_steps)
        if latents is None:
            latents = torch.randn(cond_z.shape, generator=gen,
                                  device=self.device)
        lat = torch.as_tensor(np.array(latents, np.float32)
                              if not torch.is_tensor(latents)
                              else latents).to(self.device, torch.float32)
        if lat.shape != cond_z.shape:
            raise ValueError(f"latents {tuple(lat.shape)}, expected "
                             f"{tuple(cond_z.shape)}")
        sample = (lat * float(np.float32((sigmas[0] ** 2 + 1) ** 0.5))
                  ).to(self.dtype)
        for i in range(num_inference_steps):
            sample = _denoise_step(self.params, self.cfg, sample, cond_z,
                                   ctx, ctx_un, ids, sigmas[i], sigmas[i + 1],
                                   guidance_scale)
        # the state lives in the SCALED latent space (the published decode
        # divides by the scale inside)
        z = sample[0]                                   # [T, 4, h/8, w/8]
        if self.decode_fn is not None:
            out = self.decode_fn(z)
        else:
            out = torch.cat([flux_vae_decode(self.vae_params, self.vae_cfg,
                                             z[i:i + 16]).float()
                             for i in range(0, z.shape[0], 16)], dim=0)
        out = torch.as_tensor(out).float().permute(0, 2, 3, 1).cpu().numpy()
        return np.clip(out * 0.5 + 0.5, 0.0, 1.0)


def make_clip_image_embed_fn(clip_params: dict, clip_cfg,
                             dtype=torch.bfloat16, chunk: int = 16,
                             device="cuda") -> Callable:
    """`image_embed_fn` over the ViT tower: [T, h, w, 3] frames in [0, 1]
    -> [T, proj_dim] image embeddings, the published SVD `_encode_image`
    flow (antialiased bicubic 224 resize of the [-1, 1] frames, back to
    [0, 1], CLIP-normalize, CLS + post-LN + projection), in chunks of
    `chunk` frames."""
    from flexam_tpu_torch.core.resize import resize
    from flexam_tpu_torch.models.clip import (CLIP_MEAN, CLIP_STD,
                                              clip_image_embed)
    dev = resolve_device(device)
    params = cast_floats(clip_params, dtype)
    size = clip_cfg.image_size
    mean = torch.tensor(CLIP_MEAN, device=dev)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=dev)[None, :, None, None]

    @torch.no_grad()
    def run(x):                       # x: [b, 3, h, w] in [0, 1]
        x = resize(x * 2.0 - 1.0, (x.shape[0], 3, size, size), "bicubic")
        x = ((x + 1.0) / 2.0 - mean) / std
        return clip_image_embed(params, clip_cfg, x.to(dtype))

    def fn(frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(
            frames, np.float32).transpose(0, 3, 1, 2))).to(dev)
        return torch.cat([run(x[i:i + chunk]).float()
                          for i in range(0, x.shape[0], chunk)]
                         ).cpu().numpy()

    return fn


def _load_svd_clip(path: str, coverage_threshold: float, dtype,
                   device) -> Callable:
    """FLEXAM_SVD_CLIP -> the tower's image_embed_fn (coverage-gated);
    num_heads / hidden_act from a config.json beside the weights when there
    is one (shapes cannot give them), SVD's ViT-H defaults otherwise."""
    import json

    from flexam_tpu_torch.io.checkpoints import _load_one
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.models.clip import clip_vision_params_from_hf

    num_heads, act = 16, "gelu"
    cfg_file = os.path.join(os.path.dirname(path) or ".", "config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            hf = json.load(f)
        num_heads = int(hf.get("num_attention_heads", num_heads))
        act = {"quick_gelu": "quick_gelu"}.get(hf.get("hidden_act"), "gelu")
    p, ccfg, rep = clip_vision_params_from_hf(
        _load_one(path), num_heads=num_heads, activation=act, device=device)
    check_mapping(rep, f"svd-clip:{os.path.basename(path)}",
                  threshold=coverage_threshold, strict=True)
    return make_clip_image_embed_fn(p, ccfg, dtype=dtype, device=device)


def temporal_decoder_config(vae_cfg: FluxVAEConfig):
    """The temporal decoder whose channel ladder mirrors the encoder's."""
    from flexam_tpu_torch.models.svd_vae import TemporalDecoderConfig
    return TemporalDecoderConfig(
        z_channels=vae_cfg.z_channels,
        block_out_channels=tuple(vae_cfg.ch * m for m in vae_cfg.ch_mult),
        layers_per_block=vae_cfg.num_res_blocks,
        scale_factor=vae_cfg.scale_factor)


def load_depthcrafter_denoiser(
        ckpt: Optional[str] = None, vae: Optional[str] = None,
        cfg: SVDUNetConfig = SVDUNetConfig(),
        vae_cfg: FluxVAEConfig = SD_VAE_CONFIG, dtype=torch.bfloat16,
        coverage_threshold: float = 0.95, device="cuda",
        **kw) -> DepthCrafterDenoiser:
    """Coverage-gated load from FLEXAM_DEPTHCRAFTER_CKPT / FLEXAM_SVD_VAE
    (and FLEXAM_SVD_CLIP or `clip=`), each tensor mapped onto `device`."""
    from flexam_tpu_torch.io.checkpoints import _load_one
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.models.flux_vae import \
        flux_vae_params_from_state_dict
    from flexam_tpu_torch.models.svd_unet import \
        svd_unet_params_from_state_dict

    dev = resolve_device(device)
    ckpt = ckpt or os.environ.get("FLEXAM_DEPTHCRAFTER_CKPT")
    vae = vae or os.environ.get("FLEXAM_SVD_VAE")
    if not ckpt or not vae:
        raise FileNotFoundError(
            "native DepthCrafter needs FLEXAM_DEPTHCRAFTER_CKPT (UNet) "
            "and FLEXAM_SVD_VAE (KL VAE) checkpoint files")
    unet, rep = svd_unet_params_from_state_dict(_load_one(ckpt), cfg,
                                                dtype=dtype, device=dev)
    check_mapping(rep, f"depthcrafter:{os.path.basename(ckpt)}",
                  threshold=coverage_threshold, strict=True)
    clip_path = kw.pop("clip", None) or os.environ.get("FLEXAM_SVD_CLIP")
    if clip_path and "image_embed_fn" not in kw:
        kw["image_embed_fn"] = _load_svd_clip(clip_path, coverage_threshold,
                                              dtype, dev)
    vae_sd = _load_one(vae)
    if "decoder.time_conv_out.weight" in vae_sd:
        # the video release's VAE: the SD encoder + the TEMPORAL decoder
        from flexam_tpu_torch.models.svd_vae import (
            make_temporal_decode_fn, svd_vae_params_from_state_dict)
        dec_cfg = temporal_decoder_config(vae_cfg)
        vae_p, vrep = svd_vae_params_from_state_dict(
            vae_sd, vae_cfg, dec_cfg, dtype=dtype, device=dev)
        check_mapping(vrep, f"svd-vae-temporal:{os.path.basename(vae)}",
                      threshold=coverage_threshold, strict=True)
        kw.setdefault("decode_fn",
                      make_temporal_decode_fn(vae_p, dec_cfg, dtype))
        enc_tree = {k: vae_p[k] for k in ("encoder", "quant_conv")
                    if k in vae_p}
        return DepthCrafterDenoiser(unet, enc_tree, cfg=cfg, vae_cfg=vae_cfg,
                                    dtype=dtype, device=dev, **kw)
    vae_p, vrep = flux_vae_params_from_state_dict(vae_sd, vae_cfg,
                                                  dtype=dtype, device=dev)
    check_mapping(vrep, f"svd-vae:{os.path.basename(vae)}",
                  threshold=coverage_threshold, strict=True)
    return DepthCrafterDenoiser(unet, vae_p, cfg=cfg, vae_cfg=vae_cfg,
                                dtype=dtype, device=dev, **kw)


TINY_VAE_CONFIG = FluxVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                z_channels=4, scale_factor=0.18215,
                                shift_factor=0.0)


def make_tiny_denoiser(seed: int = 0, dtype=torch.float32, device="cuda",
                       **kw) -> DepthCrafterDenoiser:
    """Random-init tiny geometry (tests / smoke runs)."""
    dev = resolve_device(device)
    return DepthCrafterDenoiser(
        init_svd_unet_params(SVDUNetConfig.tiny(), seed=seed, dtype=dtype,
                             device=dev),
        init_flux_vae_params(TINY_VAE_CONFIG, seed=seed + 1, dtype=dtype,
                             device=dev),
        cfg=SVDUNetConfig.tiny(), vae_cfg=TINY_VAE_CONFIG, dtype=dtype,
        device=dev, **kw)
