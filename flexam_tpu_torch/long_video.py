"""Long-video generation through overlapping sliding windows.

A copy of `flexam_tpu/long_video.py` (numpy): the Gradio "Long Video
Generation" mode of the reference (`FlexAM/ui/cogvideox_fun_ui.py:214-270`,
`partial_video_length` / `overlap_video_length`). Each window generates
`partial` frames; each later window is seeded with the previous window's
last `overlap` frames as known frames, and the overlap is cross-faded.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def generate_long_video(
    generate_window: Callable[..., np.ndarray],
    total_frames: int,
    partial_video_length: int,
    overlap_video_length: int,
    temporal_compression: int = 4,
    start_frames: Optional[np.ndarray] = None,   # [1, 3, k, H, W] in [0,1]
    **window_kwargs,
) -> np.ndarray:
    """Drive `generate_window(video, mask_video, num_frames, **kw)` across
    overlapping windows. `video`/`mask_video` follow the pipeline layout
    ([1,3,T,H,W] in [0,1]; mask 1 = generate). Returns [1,3,total,H,W]."""
    assert overlap_video_length < partial_video_length
    tc = temporal_compression
    out = None
    init_frames = 0
    seed_frames = start_frames
    while init_frames < total_frames:
        # A window that would reach past the end is the FINAL one
        # (`cogvideox_fun_ui.py:216-262`): the reference snaps it to 4k+1
        # and stops. When the snap covers the remainder exactly, that is
        # done verbatim; when it would truncate (the reference silently
        # returns FEWER frames than asked there) the final window is
        # instead re-anchored at total - partial so the advertised
        # video_length is always delivered — the re-anchored window
        # overlaps everything already generated past its start.
        final = init_frames + partial_video_length >= total_frames
        if final:
            remaining = total_frames - init_frames
            window = (remaining - 1) // tc * tc + 1
            if window == remaining:        # reference-exact final window
                ov_eff = overlap_video_length if out is not None else 0
                start = init_frames
            else:                          # re-anchored exact coverage
                start = max(0, total_frames - partial_video_length)
                span = total_frames - start
                # round UP to 4k+1 (trimmed after the loop) so e.g. an
                # 11-frame request with partial > total still yields 11
                w_up = ((span + tc - 2) // tc) * tc + 1
                window = min(partial_video_length, w_up)
                ov_eff = out.shape[2] - start if out is not None else 0
            if window <= ov_eff or window <= 0:
                break
            seed_frames = (out[:, :, -ov_eff:] if ov_eff > 0 else
                           (seed_frames if out is None else None))
        else:
            start, window = init_frames, partial_video_length
            ov_eff = overlap_video_length if out is not None else 0

        sample = generate_window(
            start_frames=seed_frames, num_frames=window,
            frame_offset=start, **window_kwargs)
        sample = np.array(sample, copy=True)

        if out is None:
            out = sample
        else:
            mix = (np.arange(ov_eff, dtype=np.float32) / ov_eff
                   )[None, None, :, None, None]
            out[:, :, -ov_eff:] = out[:, :, -ov_eff:] * (1 - mix) \
                + sample[:, :, :ov_eff] * mix
            out = np.concatenate([out, sample[:, :, ov_eff:]], axis=2)

        if final:
            break
        seed_frames = out[:, :, -overlap_video_length:]
        init_frames += window - overlap_video_length
    if out is not None and out.shape[2] > total_frames:
        out = out[:, :, :total_frames]     # round-up final window trim
    return out


def window_inputs_from_seed(seed_frames: Optional[np.ndarray],
                            num_frames: int, height: int, width: int):
    """Build (video, mask) for one window: the seed frames are known
    (mask 0), the rest generated (mask 1) — the multi-start-image branch
    of `get_image_to_video_latent` (`utils.py:318-331`)."""
    video = np.zeros((1, 3, num_frames, height, width), np.float32)
    mask = np.ones((1, 1, num_frames, height, width), np.float32)
    if seed_frames is not None:
        k = seed_frames.shape[2]
        video[:, :, :k] = seed_frames
        video[:, :, k:] = seed_frames[:, :, -1:]
        mask[:, :, :k] = 0.0
    return video, mask
