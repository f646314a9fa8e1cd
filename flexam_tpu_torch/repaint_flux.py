"""The FLUX.1-Depth repaint backend.

Port of `flexam_tpu/repaint_flux.py`. The reference's first-frame
repainter builds a ``FluxControlPipeline`` around FLUX.1-Depth-dev and
runs 30 steps at guidance 7.5 (`pipelines.py:137-173`). This module
assembles that pipeline from the port's models: `models/flux.py`
(MMDiT), `models/flux_vae.py` (KL VAE), `models/t5.py` (T5 v1.1, its
shared-position mode) and `models/clip_text.py` (CLIP-L pooled).

The flow (the Control pipeline's contract):
  1. depth map -> RGB control image (antialiased bilinear resize,
     `core.resize`, as `jax.image.resize`) -> VAE encode (posterior mean)
     -> 2x2 pack -> control tokens [1, L, 64];
  2. text: T5 features [1, 512, 4096] + CLIP pooled [1, 768] (tokenizers
     injectable; without them the same hashed prompt ids as JAX's, refused
     when the text towers hold a checkpoint's weights);
  3. rectified-flow Euler over the resolution-shifted schedule with the
     guidance scale embedded (no CFG pair): the update in fp32, the carry
     in the storage dtype;
  4. VAE decode (in float32, as JAX feeds it float32 latents) -> uint8.

Noise: JAX draws it from `jax.random.PRNGKey(seed)`, which torch cannot
replay; `latents=` ([1, z, H/8, W/8], JAX's draw before packing) takes it
explicitly, else a `torch.Generator` seeded with `seed` draws it. JAX's
`steps_per_launch` chunking (its executable watchdog) is dropped.

Weights: `load_flux_repainter()` reads the official single files
(FLEXAM_FLUX_CKPT -> flux1-depth-dev.safetensors, FLEXAM_FLUX_AE ->
ae.safetensors, optional FLEXAM_FLUX_T5 / FLEXAM_FLUX_CLIP HF state
dicts) through the exact name maps, gated by `io/verify_load.check_mapping`
(coverage 0.95, strict).
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.config import T5Config
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.io.convert import cast_floats
from flexam_tpu_torch.models.clip_text import (CLIPTextConfig,
                                               clip_text_forward)
from flexam_tpu_torch.models.flux import (FluxConfig, flux_forward,
                                          flux_schedule, init_flux_params,
                                          make_img_ids, pack_latents,
                                          unpack_latents)
from flexam_tpu_torch.models.flux_vae import (FluxVAEConfig,
                                              flux_vae_decode,
                                              flux_vae_encode,
                                              init_flux_vae_params)
from flexam_tpu_torch.models.t5 import t5_encode

FLUX_T5_CONFIG = T5Config(vocab=32128, dim=4096, dim_attn=4096,
                          dim_ffn=10240, num_heads=64, num_layers=24,
                          num_buckets=32, shared_pos=True, text_length=512)


class FluxDepthRepainter:
    """Depth-conditioned FLUX image generation behind the reference's
    repaint call shape (30 steps, guidance 7.5, `pipelines.py:166-173`).
    `as_repaint_fn()` plugs it into `repaint.FirstFrameRepainter`. The
    trees are the port's, on `device`; the transformer and the VAE are
    cast to `dtype`, the text towers kept as given."""

    def __init__(self, params: dict, vae_params: dict,
                 t5_params: Optional[dict] = None,
                 clip_params: Optional[dict] = None,
                 cfg: FluxConfig = FluxConfig(),
                 vae_cfg: FluxVAEConfig = FluxVAEConfig(),
                 t5_cfg: T5Config = FLUX_T5_CONFIG,
                 clip_cfg: CLIPTextConfig = CLIPTextConfig(),
                 t5_tokenizer=None, clip_tokenizer=None,
                 dtype=torch.bfloat16, text_from_checkpoint: bool = False,
                 device="cuda"):
        # text_from_checkpoint: the text towers hold REAL weights, so
        # hashed prompt ids are refused in encode_text
        self.device = resolve_device(device)
        self.text_from_checkpoint = text_from_checkpoint
        self.params = cast_floats(params, dtype)
        self.vae_params = cast_floats(vae_params, dtype)
        self.t5_params = t5_params
        self.clip_params = clip_params
        self.cfg, self.vae_cfg = cfg, vae_cfg
        self.t5_cfg, self.clip_cfg = t5_cfg, clip_cfg
        self.t5_tokenizer, self.clip_tokenizer = t5_tokenizer, clip_tokenizer
        self.dtype = dtype
        self._vae_factor = 2 ** (len(vae_cfg.ch_mult) - 1)

    # -- text ---------------------------------------------------------------

    def _hash_ids(self, prompt: str, length: int, vocab: int) -> np.ndarray:
        ids = np.zeros((1, length), np.int32)
        raw = np.frombuffer(prompt.encode()[:length] or b"\x01",
                            np.uint8).astype(np.int32)
        ids[0, :len(raw)] = raw % max(vocab, 2)
        return ids

    def _refuse_hashed(self, tower: str):
        if (self.text_from_checkpoint
                and os.environ.get("FLEXAM_ALLOW_HASHED_IDS") != "1"):
            raise RuntimeError(
                f"FLUX {tower} weights were loaded from a checkpoint but "
                f"no {tower} tokenizer is attached: hashed prompt ids "
                "through trained embeddings are garbage conditioning. "
                "Pass the tokenizer (FLEXAM_FLUX_T5_TOKENIZER / "
                "FLEXAM_FLUX_CLIP_TOKENIZER point at HF tokenizer dirs) "
                "or set FLEXAM_ALLOW_HASHED_IDS=1 to override (debug).")

    def _ids(self, tokenizer, tower, prompt, length, vocab) -> torch.Tensor:
        if tokenizer is None:
            self._refuse_hashed(tower)
            ids = self._hash_ids(prompt, length, vocab)
        else:
            ids = tokenizer([prompt], padding="max_length", truncation=True,
                            max_length=length, return_tensors="np"
                            )["input_ids"].astype(np.int32)
        return torch.from_numpy(ids).to(self.device)

    @torch.no_grad()
    def encode_text(self, prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T5 features [1, L, context_dim], CLIP pooled [1, vec_dim]).
        Without the towers: JAX's hashed pseudo-features (numpy draws
        seeded by the prompt's crc32), 64 tokens."""
        if self.t5_params is not None:
            ids = self._ids(self.t5_tokenizer, "T5", prompt,
                            self.t5_cfg.text_length, self.t5_cfg.vocab)
            txt = t5_encode(self.t5_params, self.t5_cfg, ids)
        else:
            rng = np.random.default_rng(
                zlib.crc32(prompt.encode()) & 0x7FFFFFFF)
            txt = torch.from_numpy(rng.standard_normal(
                (1, 64, self.cfg.context_dim)).astype(np.float32))
        if self.clip_params is not None:
            ids = self._ids(self.clip_tokenizer, "CLIP", prompt,
                            self.clip_cfg.max_positions, self.clip_cfg.vocab)
            _, pooled = clip_text_forward(self.clip_params, self.clip_cfg,
                                          ids)
        else:
            rng = np.random.default_rng(
                zlib.crc32(("clip" + prompt).encode()) & 0x7FFFFFFF)
            pooled = torch.from_numpy(rng.standard_normal(
                (1, self.cfg.vec_dim)).astype(np.float32))
        return (txt.to(self.device, self.dtype),
                pooled.to(self.device, self.dtype))

    # -- generation ---------------------------------------------------------

    def control_tokens(self, control_depth, height: int,
                       width: int) -> torch.Tensor:
        """The depth map (any range, [H, W]) or an RGB control image ([H, W,
        3], uint8 or float) -> the packed VAE latents [1, L, 4z]."""
        from flexam_tpu_torch.core.resize import resize
        ctrl = np.asarray(control_depth, np.float32)
        if ctrl.ndim == 2:
            lo, hi = float(ctrl.min()), float(ctrl.max())
            ctrl = (ctrl - lo) / max(hi - lo, 1e-6)
            ctrl = np.repeat(ctrl[..., None], 3, axis=-1)
        elif ctrl.max() > 1.5:          # pixel bytes (JAX's test, after
            ctrl = ctrl / 255.0         # its float32 cast)
        c = torch.from_numpy(np.ascontiguousarray(ctrl)).to(self.device)
        if tuple(c.shape[:2]) != (height, width):
            c = resize(c, (height, width, 3), "bilinear")
        c = (c * 2.0 - 1.0).to(self.dtype).permute(2, 0, 1)[None]
        z = flux_vae_encode(self.vae_params, self.vae_cfg, c)
        return pack_latents(z, self.cfg.patch)

    @torch.no_grad()
    def __call__(self, prompt: str, control_depth: np.ndarray,
                 height: int, width: int, num_inference_steps: int = 30,
                 guidance_scale: float = 7.5, seed: int = 0,
                 latents=None) -> np.ndarray:
        """control_depth: [H, W] float (any range) or [H, W, 3] uint8,
        rendered to the RGB control image, VAE-encoded, packed and
        channel-concatenated each step. `latents`: the initial noise
        [1, z, H/8, W/8] (else drawn from `seed`). Returns uint8
        [H, W, 3]."""
        f, p = self._vae_factor, self.cfg.patch
        height -= height % (f * p)
        width -= width % (f * p)
        lh, lw = height // f, width // f
        ctrl_tok = self.control_tokens(control_depth, height, width)
        shape = (1, self.vae_cfg.z_channels, lh, lw)
        if latents is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=self.device)
        else:
            noise = torch.as_tensor(np.array(latents, np.float32)).to(
                self.device)
            if tuple(noise.shape) != shape:
                raise ValueError(f"latents {tuple(noise.shape)}, expected "
                                 f"{shape}")
        img = pack_latents(noise, p).to(self.dtype)
        img_ids = torch.from_numpy(make_img_ids(lh, lw, p)).to(self.device)
        txt, pooled = self.encode_text(prompt)
        txt_ids = torch.zeros((txt.shape[1], 3), dtype=torch.int32,
                              device=self.device)
        guidance = torch.full((1,), guidance_scale, dtype=torch.float32,
                              device=self.device)
        ctrl_tok = ctrl_tok.to(img.dtype)
        sigmas = flux_schedule(num_inference_steps, img.shape[1])
        for i in range(num_inference_steps):
            t = torch.full((1,), float(sigmas[i]), dtype=torch.float32,
                           device=self.device)
            v = flux_forward(self.params, self.cfg,
                             torch.cat([img, ctrl_tok], dim=-1), img_ids,
                             txt, txt_ids, t, pooled, guidance)
            # the fp32 Euler update; the carry stays in the storage dtype
            img = (img.float() + float(sigmas[i + 1] - sigmas[i])
                   * v.float()).to(self.dtype)
        z = unpack_latents(img.float(), lh, lw, p)
        out = flux_vae_decode(self.vae_params, self.vae_cfg, z)
        out = out.float()[0].permute(1, 2, 0).cpu().numpy()
        return (np.clip(out * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)

    def as_repaint_fn(self, seed: int = 0) -> Callable:
        """Adapter for `FirstFrameRepainter(repaint_fn=...)`; `latents`
        last, as the port's other repaint backend takes it."""
        def fn(prompt, depth, height, width, num_inference_steps=30,
               guidance_scale=7.5, latents=None):
            return self(prompt, depth, height, width,
                        num_inference_steps=num_inference_steps,
                        guidance_scale=guidance_scale, seed=seed,
                        latents=latents)
        return fn


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_flux_repainter(ckpt: Optional[str] = None,
                        ae: Optional[str] = None,
                        t5: Optional[str] = None,
                        clip: Optional[str] = None,
                        cfg: FluxConfig = FluxConfig(),
                        vae_cfg: FluxVAEConfig = FluxVAEConfig(),
                        dtype=torch.bfloat16,
                        coverage_threshold: float = 0.95,
                        device="cuda") -> FluxDepthRepainter:
    """A repainter from the official checkpoint files (paths, or the
    FLEXAM_FLUX_CKPT / FLEXAM_FLUX_AE / FLEXAM_FLUX_T5 / FLEXAM_FLUX_CLIP
    variables), each tensor mapped onto `device` as it is read. The
    transformer and VAE maps are coverage-gated (strict): a mis-shaped
    file is refused instead of repainting with noise. Without T5 / CLIP
    files the hashed pseudo-conditioning stands in (smoke runs)."""
    from flexam_tpu_torch.io.checkpoints import _load_one
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.models.clip_text import \
        clip_text_params_from_state_dict
    from flexam_tpu_torch.models.flux import flux_params_from_state_dict
    from flexam_tpu_torch.models.flux_vae import \
        flux_vae_params_from_state_dict
    from flexam_tpu_torch.models.t5 import t5_params_from_hf_state_dict

    dev = resolve_device(device)
    ckpt = ckpt or os.environ.get("FLEXAM_FLUX_CKPT")
    ae = ae or os.environ.get("FLEXAM_FLUX_AE")
    t5 = t5 or os.environ.get("FLEXAM_FLUX_T5")
    clip = clip or os.environ.get("FLEXAM_FLUX_CLIP")
    if not ckpt or not ae:
        raise FileNotFoundError(
            "FLUX repaint needs the transformer (FLEXAM_FLUX_CKPT) and "
            "autoencoder (FLEXAM_FLUX_AE) checkpoint files")
    params, rep = flux_params_from_state_dict(_load_one(ckpt), cfg,
                                              dtype=dtype, device=dev)
    check_mapping(rep, f"flux:{os.path.basename(ckpt)}",
                  threshold=coverage_threshold, strict=True)
    vae_params, vrep = flux_vae_params_from_state_dict(
        _load_one(ae), vae_cfg, dtype=dtype, device=dev)
    check_mapping(vrep, f"flux-ae:{os.path.basename(ae)}",
                  threshold=coverage_threshold, strict=True)
    t5_params = clip_params = t5_tok = clip_tok = None
    if t5:
        t5_params = t5_params_from_hf_state_dict(
            _load_one(t5), FLUX_T5_CONFIG, dtype=dtype, device=dev)
    if clip:
        clip_params = clip_text_params_from_state_dict(
            _load_one(clip), CLIPTextConfig(), dtype=dtype, device=dev)
    # real text weights demand real tokenizers (encode_text refuses the
    # hashed-id fallback when text_from_checkpoint is set)
    t5_tok_dir = os.environ.get("FLEXAM_FLUX_T5_TOKENIZER")
    clip_tok_dir = os.environ.get("FLEXAM_FLUX_CLIP_TOKENIZER")
    if t5_params is not None and t5_tok_dir:
        from transformers import AutoTokenizer
        t5_tok = AutoTokenizer.from_pretrained(t5_tok_dir)
    if clip_params is not None and clip_tok_dir:
        from transformers import AutoTokenizer
        clip_tok = AutoTokenizer.from_pretrained(clip_tok_dir)
    return FluxDepthRepainter(params, vae_params, t5_params, clip_params,
                              cfg=cfg, vae_cfg=vae_cfg, dtype=dtype,
                              t5_tokenizer=t5_tok, clip_tokenizer=clip_tok,
                              text_from_checkpoint=bool(t5 or clip),
                              device=dev)


def make_tiny_repainter(seed: int = 0, dtype=torch.float32,
                        device="cuda") -> FluxDepthRepainter:
    """Random-init tiny-geometry repainter (tests / smoke runs)."""
    cfg = FluxConfig.tiny(in_channels=32)
    vae_cfg = FluxVAEConfig.tiny()
    dev = resolve_device(device)
    return FluxDepthRepainter(
        init_flux_params(cfg, seed=seed, dtype=dtype, device=dev),
        init_flux_vae_params(vae_cfg, seed=seed + 1, dtype=dtype,
                             device=dev),
        cfg=cfg, vae_cfg=vae_cfg, dtype=dtype, device=dev)
