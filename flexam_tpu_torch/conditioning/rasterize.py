"""Track rasterization: points -> control videos.

Behavioral reference: `pipelines.py:1501-1850` — the reference's biggest
CPU bottleneck: per-frame per-point PIL `draw.rectangle` loops under a
painter's algorithm (far-to-near sort, `sort_points_by_depth` :1215-1232,
`draw_rectangle` :1234-1253).

Vectorized redesign: for each frame, expand every surviving point into its
(side+1)^2-pixel square (PIL's rectangle includes both corners, so
side_length=4 paints 5x5), order all pixels by the point depth sort, and
use a single fancy-index assignment — with duplicate indices numpy applies
writes in order, so "last write wins" reproduces the painter's overdraw
exactly. ~1000x fewer python iterations than the reference.

Rendered semantics preserved per stream:
  * tracking video: colors from frame-0 (u/W, v/H, inv-depth percentile);
    bounds check uses y > 0 strictly (`valid_mask` quirk, :1212);
  * 4 cosine-PE videos: per-level colors from frame-0 encoding, points at
    original positions, y >= 0 bounds (`_render_cosine_encoded_frame`);
  * depth video: per-frame Spectral colormap of percentile-clipped depth;
  * fg/bg mask filtering by the point CENTER (`_should_draw_point`, :1842).

The port's own copy of `flexam_tpu/conditioning/rasterize.py`, numpy only
(the JAX package's optional C++ painter gives the same pixels and is left
out). It is the oracle that `rasterize_device.DeviceRasterizer` is held to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flexam_tpu_torch.conditioning.tracks import (cos_level_colors,
                                                  spectral_depth_colors,
                                                  tracking_colors)


def _center_mask_filter(pixels: np.ndarray, mask_video: Optional[np.ndarray],
                        frame_idx: int, generate_type: str,
                        width: int, height: int) -> np.ndarray:
    """`_should_draw_point` (`pipelines.py:1842-1850`) vectorized."""
    if mask_video is None or generate_type not in ("foreground_edit",
                                                   "background_edit"):
        return np.ones(len(pixels), bool)
    x = pixels[:, 0]
    y = pixels[:, 1]
    inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    keep = np.zeros(len(pixels), bool)
    m = mask_video[frame_idx]
    keep[inb] = m[y[inb], x[inb]] > 0.5
    return keep


def _paint_frame(height: int, width: int, pixels: np.ndarray,
                 colors: np.ndarray, depths: np.ndarray,
                 side_length: int) -> np.ndarray:
    """One frame: depth-sorted square splat, last-write-wins overdraw."""
    img = np.zeros((height * width + 1, 3), np.uint8)
    if len(pixels) == 0:
        return img[:-1].reshape(height, width, 3)
    order = np.argsort(depths)[::-1]            # far -> near
    px = pixels[order]
    col = colors[order]
    half = side_length // 2
    offs = np.arange(-half, half + 1)
    dy, dx = np.meshgrid(offs, offs, indexing="ij")
    xs = px[:, 0, None] + dx.reshape(-1)[None, :]    # [M, k]
    ys = px[:, 1, None] + dy.reshape(-1)[None, :]
    flat = ys * width + xs
    oob = (xs < 0) | (xs >= width) | (ys < 0) | (ys >= height)
    flat = np.where(oob, height * width, flat)       # dump pixel
    k = flat.shape[1]
    img[flat.reshape(-1)] = np.repeat(col, k, axis=0)
    return img[:-1].reshape(height, width, 3)


def _prepare_points(points_t: np.ndarray, vis_t: np.ndarray,
                    colors: np.ndarray, width: int, height: int,
                    y_strict: bool) -> tuple:
    """Visibility -> finite -> int cast -> bounds filter, matching the
    reference's order so downstream color indexing lines up."""
    pts = points_t[vis_t]
    col = colors[vis_t]
    pix = pts[:, :2]
    dep = pts[:, 2]
    finite = np.isfinite(pix).all(axis=1)
    pix = pix[finite].astype(int)
    dep = dep[finite]
    col = col[finite]
    if y_strict:   # tracking video `valid_mask`: y > 0 (`:1212`)
        inb = ((pix[:, 0] >= 0) & (pix[:, 0] < width)
               & (pix[:, 1] > 0) & (pix[:, 1] < height))
    else:
        inb = ((pix[:, 0] >= 0) & (pix[:, 0] < width)
               & (pix[:, 1] >= 0) & (pix[:, 1] < height))
    return pix[inb], dep[inb], col[inb]


def _to_video_tensor(frames: List[np.ndarray]) -> np.ndarray:
    """[T][H, W, 3] uint8 -> [1, 3, T, H, W] float in [0, 1]
    (`_convert_frames_to_tensor`, `pipelines.py:1658-1660`)."""
    v = np.stack(frames).astype(np.float32) / 255.0
    return v.transpose(3, 0, 1, 2)[None]


def rasterize_tracking_video(
    tracks: np.ndarray,                 # [T, N, 3] (u, v, depth)
    visibility: Optional[np.ndarray],   # [T, N] bool
    height: int, width: int, point_wise: int = 4,
    mask_video: Optional[np.ndarray] = None,
    generate_type: str = "full_edit",
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """`fun_visualize_tracking_with_depth` (`pipelines.py:1501-1573`)."""
    tracks = np.asarray(tracks)
    t, n, _ = tracks.shape
    vis = (np.ones((t, n), bool) if visibility is None
           else np.asarray(visibility).reshape(t, n).astype(bool))
    colors = tracking_colors(tracks, height, width, rng=rng)
    frames = []
    for i in range(t):
        pix, dep, col = _prepare_points(tracks[i], vis[i], colors,
                                        width, height, y_strict=True)
        keep = _center_mask_filter(pix, mask_video, i, generate_type,
                                   width, height)
        frames.append(_paint_frame(height, width, pix[keep], col[keep],
                                   dep[keep], point_wise))
    return _to_video_tensor(frames)


def rasterize_cos_videos(
    encoded_tracks_list: Sequence[np.ndarray],  # L x [T, N, 3] in [-1, 1]
    original_tracks: np.ndarray,                # [T, N, 3]
    visibility: Optional[np.ndarray],
    height: int, width: int,
    mask_video: Optional[np.ndarray] = None,
    generate_type: str = "full_edit",
) -> Dict[int, np.ndarray]:
    """`_visualize_cosine_encoded_tracking` (`pipelines.py:1730-1761`);
    the square is fixed 5x5 (`_render_cosine_encoded_frame` :1697-1700)."""
    original_tracks = np.asarray(original_tracks)
    t, n, _ = original_tracks.shape
    vis = (np.ones((t, n), bool) if visibility is None
           else np.asarray(visibility).reshape(t, n).astype(bool))
    level_colors = [cos_level_colors(np.asarray(e)[0])
                    for e in encoded_tracks_list]
    # positions/visibility/depth sort are shared across levels — prepare
    # each frame once and paint all levels from it
    frames_per_level = [[] for _ in level_colors]
    for i in range(t):
        idx = np.arange(n)
        pix, dep, sel = _prepare_points(original_tracks[i], vis[i],
                                        idx[:, None], width, height,
                                        y_strict=False)
        sel = sel[:, 0]
        keep = _center_mask_filter(pix, mask_video, i, generate_type,
                                   width, height)
        pix, dep, sel = pix[keep], dep[keep], sel[keep]
        for lvl, colors in enumerate(level_colors):
            frames_per_level[lvl].append(
                _paint_frame(height, width, pix, colors[sel], dep,
                             side_length=4))
    return {lvl: _to_video_tensor(frames)
            for lvl, frames in enumerate(frames_per_level)}


def rasterize_depth_video(
    tracks: np.ndarray, visibility: Optional[np.ndarray],
    height: int, width: int, point_wise: int = 4,
    mask_video: Optional[np.ndarray] = None,
    generate_type: str = "full_edit",
) -> np.ndarray:
    """`_visualize_depth_tracking` (`pipelines.py:1763-1820`): per-frame
    percentile depth normalization + Spectral colormap."""
    tracks = np.asarray(tracks)
    t, n, _ = tracks.shape
    vis = (np.ones((t, n), bool) if visibility is None
           else np.asarray(visibility).reshape(t, n).astype(bool))
    frames = []
    for i in range(t):
        uv = tracks[i, :, :2][vis[i]]
        dep = tracks[i, :, 2][vis[i]]
        if len(uv) == 0:
            frames.append(np.zeros((height, width, 3), np.uint8))
            continue
        colors = spectral_depth_colors(dep)
        finite = np.isfinite(uv).all(axis=1)
        pix = uv[finite].astype(int)
        depf = dep[finite]
        col = colors[finite]
        inb = ((pix[:, 0] >= 0) & (pix[:, 0] < width)
               & (pix[:, 1] >= 0) & (pix[:, 1] < height))
        pix, depf, col = pix[inb], depf[inb], col[inb]
        keep = _center_mask_filter(pix, mask_video, i, generate_type,
                                   width, height)
        frames.append(_paint_frame(height, width, pix[keep], col[keep],
                                   depf[keep], point_wise))
    return _to_video_tensor(frames)
