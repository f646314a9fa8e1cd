"""Track rasterization on the device, in torch ops.

Port of `flexam_tpu/conditioning/rasterize_device.py`: the same splat
semantics as `conditioning.rasterize` (the numpy oracle), run on the
pipeline's device, so that only the tracks [T, N, 3] and [N, 3] or
[T, N, 3] uint8 colour tables leave the host, and the full-resolution
control videos exist only on the device.

Algorithm (exact painter's-algorithm equivalence):
  1. points are ranked by depth: far -> near paint order means the
     nearest point has the highest rank (`sort_points_by_depth`,
     `pipelines.py:1215-1232`);
  2. each frame scatters rank+1 of every valid point into its CENTER
     pixel with a scatter-max (duplicate centers: nearest wins);
  3. the square splat (side+1 x side+1, PIL `draw.rectangle` includes
     both corners) is a max dilation of the rank image: a pixel is
     covered by exactly the points whose center lies within Chebyshev
     distance side/2, and the maximum rank among them wins, identical
     to last-write-wins overdraw in depth order;
  4. winner rank -> point index -> color gather.

Both sorts are stable, as `jnp.argsort` is, so that for tied depths the
winner of a pixel is the JAX rasterizer's. (The numpy oracle sorts with an
unstable quicksort: for tied depths the JAX rasterizer is the only oracle;
for distinct depths the three agree bit for bit.) The dilation is a
separable max of shifted int32 slices padded with 0, which is exact and
the same code on every device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.conditioning.tracks import (cos_level_colors,
                                                  cosine_positional_encoding,
                                                  spectral_depth_colors,
                                                  tracking_colors)
from flexam_tpu_torch.device import resolve_device

FrameFn = Callable[[int, int], torch.Tensor]


def _dilate_max(img: torch.Tensor, window: int) -> torch.Tensor:
    """Max over a window x window neighbourhood of [T, H, W] non-negative
    ints, zero outside: `lax.reduce_window(max, "SAME", init 0)`."""
    r = window // 2
    for dim in (1, 2):
        n = img.shape[dim]
        pad = [0, 0, 0, 0]
        pad[2 * (2 - dim)] = pad[2 * (2 - dim) + 1] = r
        padded = torch.nn.functional.pad(img, pad)
        out = padded.narrow(dim, 0, n)
        for k in range(1, window):
            out = torch.maximum(out, padded.narrow(dim, k, n))
        img = out
    return img


def rank_point_image(pix: torch.Tensor,       # [T, N, 2] float (x, y)
                     depth: torch.Tensor,     # [T, N] float
                     valid: torch.Tensor,     # [T, N] bool
                     height: int, width: int, window: int,
                     y_strict: bool) -> torch.Tensor:
    """Winner POINT INDEX per pixel ([T, H, W] int32, -1 = background).

    `valid` carries visibility + any mask filtering; finite and bounds
    checks are applied here, on the floats and before any index exists (a
    float -> int cast of NaN, inf or an out-of-range value is undefined in
    torch). The kept positions are cast toward zero, as numpy's
    `.astype(int)`; the tracking video uses y >= 1 (`pipelines.py:1212`).
    """
    t = pix.shape[0]
    x, y = pix[..., 0], pix[..., 1]
    finite = torch.isfinite(pix).all(dim=-1)
    # for finite x: trunc(x) >= 0 <=> x > -1, trunc(x) < W <=> x < W,
    # trunc(y) >= 1 <=> y >= 1
    y_ok = (y >= 1) if y_strict else (y > -1)
    ok = valid & finite & (x > -1) & (x < width) & y_ok & (y < height)
    ix = torch.where(ok, x, 0).to(torch.int64)
    iy = torch.where(ok, y, 0).to(torch.int64)
    flat = torch.where(ok, iy * width + ix, height * width)

    # far -> near paint order; invalid points sort last (never scattered)
    key = torch.where(ok, depth, -torch.inf)
    order = torch.argsort(-key, dim=1, stable=True)    # [T, N], far first
    rank = torch.argsort(order, dim=1, stable=True)    # inverse permutation

    img = torch.zeros((t, height * width + 1), dtype=torch.int32,
                      device=pix.device)
    img.scatter_reduce_(1, flat, (rank + 1).to(torch.int32), "amax")
    rimg = img[:, :-1].reshape(t, height, width)
    if window > 1:
        rimg = _dilate_max(rimg, window)
    # winner rank -> original point index
    pimg = torch.gather(order, 1, (rimg - 1).clamp_min(0).reshape(t, -1)
                        .to(torch.int64)).reshape(t, height, width)
    return torch.where(rimg > 0, pimg, -1).to(torch.int32)


# uint8 k -> k / 255 in fp32 as an IEEE division gives it, and the VAE's
# [-1, 1] form of it. A lookup, not a division on the device: CUDA divides a
# tensor by a scalar as a multiply by the reciprocal, one ulp off for some k.
_UNIT = np.arange(256, dtype=np.float32) / np.float32(255.0)
_SIGNED = _UNIT * np.float32(2.0) - np.float32(1.0)


def colorize(pimg: torch.Tensor,              # [T, H, W] int32, -1 = bg
             colors: torch.Tensor,            # [N, 3] or [T, N, 3] uint8
             per_frame: bool, normalize: bool = False,
             dtype=torch.float32) -> torch.Tensor:
    """Point-index image -> [1, 3, T, H, W] video in [0, 1] (or in [-1, 1],
    the VAE's input, when normalize=True), in fp32 and cast to `dtype`
    once; the background is colour 0."""
    t, h, w = pimg.shape
    table = torch.from_numpy(_SIGNED if normalize else _UNIT).to(pimg.device)
    cf = table[colors.long()]                 # the colour table in fp32
    safe = pimg.clamp_min(0).to(torch.int64)
    if per_frame:
        out = torch.gather(cf, 1, safe.reshape(t, -1, 1).expand(-1, -1, 3)
                           ).reshape(t, h, w, 3)
    else:
        out = cf[safe]
    out = torch.where(pimg[..., None] >= 0, out, table[0])
    return out.to(dtype).permute(3, 0, 1, 2)[None]


def _depth_frame_colors(tracks: np.ndarray, vis: np.ndarray) -> np.ndarray:
    """Per-frame Spectral colormap colors [T, N, 3] uint8, from the VISIBLE
    depth set of each frame, as the host path computes them
    (`_visualize_depth_tracking`, `pipelines.py:1782-1795`)."""
    t, n, _ = tracks.shape
    out = np.zeros((t, n, 3), np.uint8)
    for i in range(t):
        m = vis[i]
        if not m.any():
            continue
        out[i, m] = spectral_depth_colors(tracks[i, m, 2])
    return out


class DeviceRasterizer:
    """Rasterizes all 6 control streams on `device` (CUDA unless the caller
    asks for the CPU) from tracks.

    Only the tracks, the visibility and the colour tables are shipped; the
    full-resolution videos exist only on the device. Rank images are cached
    per (window, y_strict) until `drop` / `free`.
    """

    def __init__(self, tracks: np.ndarray, visibility: Optional[np.ndarray],
                 height: int, width: int, point_wise: int = 4,
                 cos_level: int = 4,
                 raster_mask: Optional[np.ndarray] = None,  # [T,H,W] {0,1}
                 generate_type: str = "full_edit",
                 rng: Optional[np.random.RandomState] = None,
                 device="cuda"):
        tracks = np.asarray(tracks, np.float32)
        t, n, _ = tracks.shape
        vis = (np.ones((t, n), bool) if visibility is None
               else np.asarray(visibility).reshape(t, n).astype(bool))
        self.device = resolve_device(device)
        self.height, self.width = height, width
        self.t = t
        self.track_window = 2 * (point_wise // 2) + 1
        self.cos_window = 5          # fixed 5x5 (`pipelines.py:1697-1700`)

        # host: small colour tables (colours depend only on the tracks)
        self._track_colors = self._put(tracking_colors(tracks, height, width,
                                                       rng=rng))
        encoded = cosine_positional_encoding(tracks, height, width,
                                             L=cos_level)
        self._cos_colors = self._put(np.stack(
            [cos_level_colors(e[0]) for e in encoded]))        # [L, N, 3]
        self._depth_colors = self._put(_depth_frame_colors(tracks, vis))

        # device: positions + validity (mask-centre filter,
        # `_should_draw_point` `pipelines.py:1842-1850`)
        self._pix = self._put(tracks[..., :2])
        self._depth = self._put(tracks[..., 2])
        valid = self._put(vis)
        if raster_mask is not None and generate_type in (
                "foreground_edit", "background_edit"):
            m = self._put(np.asarray(raster_mask, np.float32) > 0.5)
            # the point's centre, clipped into the frame (non-finite and
            # far-out positions are clamped before the cast; such points
            # fail rank_point_image's checks whatever the mask says)
            p = torch.nan_to_num(self._pix)
            ix = p[..., 0].clamp(-1, width).to(torch.int64).clamp(0, width - 1)
            iy = p[..., 1].clamp(-1, height).to(torch.int64).clamp(
                0, height - 1)
            frames = torch.arange(t, device=self.device)[:, None]
            valid = valid & m[frames, iy, ix]
        self._valid = valid
        self._pimg_cache: Dict[Tuple[int, bool], torch.Tensor] = {}

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _pimg(self, window: int, y_strict: bool) -> torch.Tensor:
        key = (window, y_strict)
        if key not in self._pimg_cache:
            self._pimg_cache[key] = rank_point_image(
                self._pix, self._depth, self._valid, self.height, self.width,
                window, y_strict)
        return self._pimg_cache[key]

    def tracking_video(self, normalize=False, dtype=torch.float32
                       ) -> torch.Tensor:
        """`fun_visualize_tracking_with_depth`: [1, 3, T, H, W] in [0, 1]."""
        return colorize(self._pimg(self.track_window, True),
                        self._track_colors, False, normalize, dtype)

    def cos_videos(self, normalize=False, dtype=torch.float32
                   ) -> List[torch.Tensor]:
        """`_visualize_cosine_encoded_tracking` x L levels."""
        return [self.cos_video(lvl, normalize, dtype)
                for lvl in range(self.num_cos_levels)]

    def cos_video(self, level: int, normalize=False,
                  dtype=torch.float32) -> torch.Tensor:
        """One cosine level."""
        return colorize(self._pimg(self.cos_window, False),
                        self._cos_colors[level], False, normalize, dtype)

    @property
    def num_cos_levels(self) -> int:
        return len(self._cos_colors)

    def depth_video(self, normalize=False, dtype=torch.float32
                    ) -> torch.Tensor:
        """`_visualize_depth_tracking`: per-frame Spectral colours."""
        return colorize(self._pimg(self.track_window, False),
                        self._depth_colors, True, normalize, dtype)

    # -- frame producers for `models.vae_stream.vae_encode_stream_fn`:
    #    frames [1, 3, n, H, W] in [-1, 1], group by group --

    def tracking_frame_fn(self, dtype=torch.float32) -> FrameFn:
        pimg = self._pimg(self.track_window, True)
        return lambda a, n: colorize(pimg[a:a + n], self._track_colors,
                                     False, True, dtype)

    def cos_frame_fn(self, level: int, dtype=torch.float32) -> FrameFn:
        pimg = self._pimg(self.cos_window, False)
        colors = self._cos_colors[level]
        return lambda a, n: colorize(pimg[a:a + n], colors, False, True,
                                     dtype)

    def depth_frame_fn(self, dtype=torch.float32) -> FrameFn:
        pimg = self._pimg(self.track_window, False)
        return lambda a, n: colorize(pimg[a:a + n],
                                     self._depth_colors[a:a + n], True, True,
                                     dtype)

    def drop(self, window: int, y_strict: bool):
        """Free one cached rank image ([T, H, W] int32, 178 MB at
        512x896x97f)."""
        self._pimg_cache.pop((window, y_strict), None)

    def free(self):
        self._pimg_cache.clear()
