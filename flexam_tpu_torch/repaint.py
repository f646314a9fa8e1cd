"""First-frame repainting.

Port of `flexam_tpu/repaint.py`. The reference (`pipelines.py:108-193`,
`FirstFrameRepainter`) conditions a FLUX.1-Depth-dev run on a depth map to
regenerate the first frame under a new prompt. Both stages plug in as
callables here; `make_flexam_repaint_fn` is the native repaint backend,
depth-conditioned single-frame generation with the FlexAM model itself.
The FLUX backend is not ported yet (ROADMAP A item 7: the demo raises for
FLEXAM_FLUX_*).

Deliberate divergences, for want of PIL: a precomputed depth map
(`depth_path`) is read by `utils/media.py` (`.npy` / `.npz` images,
PIL's grey conversion and bicubic resize rebuilt there), and the repainted
frame is written as `temp_repainted.npy` where JAX writes
`temp_repainted.png`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


class FirstFrameRepainter:
    """Orchestrates depth -> repaint. Both stages are injectable:

    depth_fn(image [H, W, 3] uint8) -> depth [H, W] float
    repaint_fn(prompt, control_depth [H, W] float, height, width)
        -> image [H, W, 3] uint8  (the FLUX.1-Depth call, 30 steps cfg 7.5)
    """

    def __init__(self, height: int = 480, width: int = 720,
                 output_dir: str = "outputs",
                 depth_fn: Optional[Callable] = None,
                 repaint_fn: Optional[Callable] = None):
        self.height, self.width = height, width
        self.output_dir = output_dir
        self.depth_fn = depth_fn
        self.repaint_fn = repaint_fn
        os.makedirs(output_dir, exist_ok=True)

    def estimate_depth(self, image: np.ndarray,
                       depth_path: Optional[str] = None) -> np.ndarray:
        """Depth for conditioning: a precomputed map (`depth_path`,
        mirroring `pipelines.py:144-150`) or the injected estimator."""
        if depth_path is not None:
            from flexam_tpu_torch.utils.media import (read_image,
                                                      resize_image_u8,
                                                      to_gray_u8)
            g = to_gray_u8(read_image(depth_path))
            if g.shape != (self.height, self.width):
                g = resize_image_u8(g, (self.height, self.width))
            return g.astype(np.float32) / 255.0
        if self.depth_fn is None:
            raise RuntimeError(
                "no depth estimator: pass depth_path, or inject depth_fn "
                "(perception.estimate_depth, UniDepth V2 with "
                "FLEXAM_UNIDEPTH_CKPT)")
        return np.asarray(self.depth_fn(image), np.float32)

    def repaint(self, first_frame: np.ndarray, prompt: str,
                depth_path: Optional[str] = None,
                num_inference_steps: int = 30,
                guidance_scale: float = 7.5, latents=None) -> np.ndarray:
        """first_frame: [3, H, W] float in [0,1] -> repainted [1,3,1,H,W].
        Saves `temp_repainted.npy` (the reference's `:176` writes a png).
        `latents`, if given, goes to the repaint backend as its initial
        noise (the port's pipelines take it last)."""
        img_u8 = (np.clip(first_frame.transpose(1, 2, 0), 0, 1)
                  * 255).astype(np.uint8)
        depth = self.estimate_depth(img_u8, depth_path)
        if self.repaint_fn is None:
            raise RuntimeError(
                "no repaint backend: inject repaint_fn "
                "(make_flexam_repaint_fn) or pass --repaint <image> upstream")
        kw = {} if latents is None else {"latents": latents}
        out = np.asarray(self.repaint_fn(
            prompt, depth, self.height, self.width,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, **kw), np.uint8)
        np.save(os.path.join(self.output_dir, "temp_repainted.npy"), out)
        return (out.astype(np.float32) / 255.0
                ).transpose(2, 0, 1)[None, :, None]


def make_flexam_repaint_fn(pipe, seed: int = 1234):
    """Native repaint backend: depth-conditioned SINGLE-FRAME generation
    with the FlexAM model itself. A 1-frame clip generated with only the
    depth channel active (no tracking, everything masked as "generate") is
    a depth-conditioned image generation with the checkpoints the user
    already has, where the reference reaches for FLUX.1-Depth-dev.

    Returns `repaint_fn(prompt, depth, h, w, num_inference_steps=30,
    guidance_scale=7.5, latents=None) -> uint8 [H, W, 3]` for
    FirstFrameRepainter; `latents` is the port's explicit initial noise,
    last, as `generate` takes it."""
    def fn(prompt, depth, height, width, num_inference_steps=30,
           guidance_scale=7.5, latents=None):
        d = np.asarray(depth, np.float32)
        d = (d - d.min()) / max(d.max() - d.min(), 1e-6)
        d3 = np.repeat(d[None], 3, axis=0)[None, :, None]  # [1,3,1,H,W]
        zeros = np.zeros((1, 3, 1, height, width), np.float32)
        out = pipe.generate(
            zeros, prompt,
            mask_video=np.ones((1, 1, 1, height, width), np.float32),
            control_video=zeros, depth_video=d3,
            cos_videos=[zeros] * 4,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, density=0.0,
            latents=latents)
        frame = np.asarray(out)[0, :, 0].transpose(1, 2, 0)
        return (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return fn
