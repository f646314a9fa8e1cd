"""Top-level orchestrator: tracks -> control videos -> generation.

Port of `flexam_tpu/orchestrator.py` (behavioral reference `pipelines.py`
`FlexAMPipeline`: `visualize_tracking_DELTA` :1852-1903,
`convert_moge_to_delta_format` :1255-1291, `apply_tracking` / `_infer`
:1905 / :1072-1190). `apply_tracks` is the device path (the control videos
are rasterized on the pipeline's device and never reach the host);
`visualize_tracking` + `apply_tracking` are the host path through the
numpy rasterizers. Keyword arguments beyond the named ones reach
`generate_from_cond` / `generate` (`latents=`, the TeaCache and scheduler
options).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                           rasterize_cos_videos,
                                           rasterize_depth_video,
                                           rasterize_tracking_video)
from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline
from flexam_tpu_torch.utils.media import get_maskvideo_input, save_video


def convert_moge_to_delta_format(
    moge_points: np.ndarray,    # [T, H, W, 3] normalized uv + depth
    mask: np.ndarray,           # [H, W] bool
    height: int, width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalized MoGe point maps -> DELTA pixel tracks + visibility
    (`pipelines.py:1255-1291`)."""
    t, h, w, _ = moge_points.shape
    px = moge_points.copy()
    px[..., 0] *= width
    px[..., 1] *= height
    flat = px.reshape(t, h * w, 3)
    valid = flat[:, np.asarray(mask).reshape(-1).astype(bool), :]
    vis = np.ones(valid.shape[:2], dtype=bool)
    return valid.astype(np.float32), vis


class FlexAMOrchestrator:
    """Owns a generation pipeline + the track->control-video front-end."""

    def __init__(self, pipeline: FlexAMGenerationPipeline,
                 output_dir: str = "outputs", fps: int = 16,
                 save_tracking: bool = True):
        self.pipe = pipeline
        self.output_dir = output_dir
        self.fps = fps
        self.save_tracking = save_tracking
        os.makedirs(output_dir, exist_ok=True)

    def load_mask_video(self, mask_path: Optional[str], generate_type: str,
                        num_frames: int, height: int,
                        width: int) -> Optional[np.ndarray]:
        """`_load_mask_video` (`pipelines.py:1822-1840`): [T, H, W] float
        {0,1}; inverted for background edits."""
        if generate_type not in ("foreground_edit", "background_edit") \
                or mask_path is None:
            return None
        mv = get_maskvideo_input(mask_path, num_frames, (height, width))
        m = mv.mean(axis=1) > 0.5
        if generate_type == "background_edit":
            m = ~m
        return m.astype(np.float32)

    def visualize_tracking(
        self, tracks: np.ndarray, visibility: Optional[np.ndarray],
        height: int, width: int, point_wise: int = 4, cos_level: int = 4,
        generate_type: str = "full_edit", mask_path: Optional[str] = None,
    ) -> Tuple[np.ndarray, Dict[int, np.ndarray], np.ndarray]:
        """`visualize_tracking_DELTA` (`pipelines.py:1852-1903`): tracking
        video + cos-PE videos + depth video, with optional fg/bg filtering;
        artifacts saved when save_tracking is set."""
        mask_video = self.load_mask_video(mask_path, generate_type,
                                          tracks.shape[0], height, width)
        tracking = rasterize_tracking_video(
            tracks, visibility, height, width, point_wise=point_wise,
            mask_video=mask_video, generate_type=generate_type)
        encoded = cosine_positional_encoding(tracks, height, width,
                                             L=cos_level)
        cos_videos = rasterize_cos_videos(
            encoded, tracks, visibility, height, width,
            mask_video=mask_video, generate_type=generate_type)
        depth = rasterize_depth_video(
            tracks, visibility, height, width, point_wise=point_wise,
            mask_video=mask_video, generate_type=generate_type)
        if self.save_tracking:
            save_video(tracking, os.path.join(self.output_dir,
                                              "tracking_video_delta.mp4"),
                       fps=self.fps)
            for lvl, v in cos_videos.items():
                save_video(v, os.path.join(self.output_dir,
                                           f"delta_cos_i_{lvl}.mp4"),
                           fps=self.fps)
            save_video(depth, os.path.join(self.output_dir,
                                           "depth_video_delta.mp4"),
                       fps=self.fps)
        return tracking, cos_videos, depth

    def apply_tracks(
        self, tracks: np.ndarray, visibility: Optional[np.ndarray],
        height: int, width: int, prompt: str,
        point_wise: int = 4, generate_type: str = "full_edit",
        mask_path: Optional[str] = None,
        first_frame: Optional[np.ndarray] = None,  # [1,3,(1,)H,W] in [0,1]
        video: Optional[np.ndarray] = None,        # [1,3,T,H,W] in [0,1]
        mask_video: Optional[np.ndarray] = None,   # [1,1,T,H,W] in [0,1]
        ref_image: Optional[np.ndarray] = None,
        num_inference_steps: int = 50, guidance_scale: float = 6.0,
        density: float = 0.1, seed: int = 1245644,
        negative_prompt: Optional[str] = None,
        output_name: str = "result.mp4", **kwargs,
    ) -> np.ndarray:
        """Device-rasterized generation: the tracks go to the pipeline's
        device (`conditioning/rasterize_device.py`) and the control videos
        never reach the host. The same result as visualize_tracking +
        apply_tracking. Artifact videos are written only when save_tracking
        is set (they copy the full-size streams to the host)."""
        raster_mask = self.load_mask_video(mask_path, generate_type,
                                           tracks.shape[0], height, width)
        cond = self.pipe.prepare_conditioning_from_tracks(
            tracks, visibility, height, width, point_wise=point_wise,
            generate_type=generate_type, raster_mask=raster_mask,
            video=video, first_frame=first_frame, mask_video=mask_video,
            ref_image=ref_image, return_videos=self.save_tracking)
        for name, v in cond.pop("videos", {}).items():
            fname = {"tracking": "tracking_video_delta.mp4",
                     "depth": "depth_video_delta.mp4"}.get(
                         name, f"delta_{name.replace('cos_', 'cos_i_')}.mp4")
            save_video(v, os.path.join(self.output_dir, fname), fps=self.fps)
        context = self.pipe.encode_prompt(prompt, negative_prompt,
                                          do_cfg=guidance_scale > 1.0)
        out = self.pipe.generate_from_cond(
            cond, context, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, density=density,
            **kwargs)
        path = os.path.join(os.path.abspath(self.output_dir), output_name)
        path = save_video(out, path, fps=self.fps)
        print(f"Final video generated successfully at: {path}")
        return out

    def apply_tracking(
        self, tracking_video: np.ndarray, cos_videos: Dict[int, np.ndarray],
        depth_video: np.ndarray, full_ref: np.ndarray,
        inpaint_video: np.ndarray, inpaint_video_mask: np.ndarray,
        prompt: str, num_inference_steps: int = 50,
        guidance_scale: float = 6.0, density: float = 0.1,
        seed: int = 1245644, output_name: str = "result.mp4",
        **kwargs,
    ) -> np.ndarray:
        """`apply_tracking` / `_infer` (`pipelines.py:1905-1947,1072-1190`).
        The reference hardcodes 50 steps and CFG 6.0 (`:1174-1175`); the
        arguments are honoured here."""
        mask01 = (np.asarray(inpaint_video_mask, np.float32) / 255.0
                  if inpaint_video_mask.max() > 1.0 else
                  np.asarray(inpaint_video_mask, np.float32))
        out = self.pipe.generate(
            video=np.asarray(inpaint_video, np.float32),
            prompt=prompt,
            mask_video=mask01,
            control_video=tracking_video,
            depth_video=depth_video,
            cos_videos=[cos_videos[k] for k in sorted(cos_videos)],
            ref_image=full_ref,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            density=density,
            seed=seed,
            **kwargs,
        )
        path = os.path.join(os.path.abspath(self.output_dir), output_name)
        path = save_video(out, path, fps=self.fps)
        print(f"Final video generated successfully at: {path}")
        return out
