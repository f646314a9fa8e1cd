"""Dense optical flow and track chaining on the device (pyramidal
Lucas-Kanade).

Port of `flexam_tpu/perception/flow_jax.py`, the same algorithm in torch
ops on the caller's device (CUDA unless the caller asks for the CPU):

  * coarse-to-fine dense LK flow: image pyramids by 2x average pooling
    (odd sizes truncated); per level, iterative refinement: warp the next
    frame by the current flow (bilinear gather), box-filtered structure
    tensor (separable sums over cumulative sums, edge-padded), closed-form
    2x2 solve per pixel. Every frame pair is batched;
  * track chaining over frames: advance the query grid by the bilinearly
    sampled forward flow, kill tracks on forward<->backward inconsistency
    and out-of-bounds.

Only tracks [T, N, 3] and visibility cross back to the host. As in JAX,
`tracking.dispatch_tracking` takes this tracker on the accelerator (or
under FLEXAM_FLOW=device) and OpenCV's Farneback (`tracking.
track_video_flow`) on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.core.resize import bilinear_gather, edge_pad, resize
from flexam_tpu_torch.device import resolve_device

LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """[.., H, W] -> [.., H//2, W//2] 2x2 mean (pyramid downsample)."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., : h2 * 2, : w2 * 2]
    return x.reshape(*x.shape[:-2], h2, 2, w2, 2).mean(dim=(-3, -1))


def _window_sum(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    k = 2 * r + 1
    c = torch.cumsum(edge_pad(x, r, dim), dim=dim)
    n = c.shape[dim]
    head = c.narrow(dim, k - 1, n - k + 1)
    prev = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)),
                      c.narrow(dim, 0, n - k)], dim=dim)
    return head - prev


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Separable (2r+1)^2 box SUM over the last two axes (edge-padded)."""
    return _window_sum(_window_sum(x, r, x.dim() - 2), r, x.dim() - 1)


def _grad(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference image gradients (edge-replicated)."""
    xp = edge_pad(edge_pad(x, 1, x.dim() - 2), 1, x.dim() - 1)
    gx = (xp[..., 1:-1, 2:] - xp[..., 1:-1, :-2]) * 0.5
    gy = (xp[..., 2:, 1:-1] - xp[..., :-2, 1:-1]) * 0.5
    return gx, gy


def _lk_level(prev: torch.Tensor, nxt: torch.Tensor, flow: torch.Tensor,
              radius: int, iters: int, eps: float = 1e-4) -> torch.Tensor:
    """One pyramid level of iterative LK. prev/nxt [B, H, W];
    flow [B, H, W, 2] (x, y) in pixels at this level's scale."""
    b, h, w = prev.shape
    gx, gy = _grad(prev)
    gxx = _box_filter(gx * gx, radius)
    gxy = _box_filter(gx * gy, radius)
    gyy = _box_filter(gy * gy, radius)
    det = gxx * gyy - gxy * gxy
    inv_det = torch.where(det > eps, 1.0 / torch.clamp(det, min=eps),
                          torch.zeros_like(det))
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=prev.device),
        torch.arange(w, dtype=torch.float32, device=prev.device),
        indexing="ij")
    for _ in range(iters):
        warped = bilinear_gather(nxt[..., None], xs[None] + flow[..., 0],
                                 ys[None] + flow[..., 1])[..., 0]
        it = warped - prev
        bx = _box_filter(gx * it, radius)
        by = _box_filter(gy * it, radius)
        du = -(gyy * bx - gxy * by) * inv_det
        dv = -(-gxy * bx + gxx * by) * inv_det
        # clamp per-iteration update: LK linearization is only locally valid
        du = du.clamp(-radius, radius)
        dv = dv.clamp(-radius, radius)
        flow = flow + torch.stack([du, dv], dim=-1)
    return flow


def _clamp_levels(levels: int, h: int, w: int, radius: int) -> int:
    """Pyramid depth such that the coarsest level stays larger than the LK
    window (a 6-pixel level under a radius-7 box filter gives garbage
    coarse flow that poisons every finer level)."""
    min_dim = 2 * radius + 2
    lv = 1
    hh, ww = h, w
    while lv < levels and hh // 2 >= min_dim and ww // 2 >= min_dim:
        hh //= 2
        ww //= 2
        lv += 1
    return lv


def dense_flow(prev: torch.Tensor, nxt: torch.Tensor, levels: int = 3,
               radius: int = 7, iters: int = 4) -> torch.Tensor:
    """Batched dense flow: prev/nxt [B, H, W] grayscale 0..1 ->
    flow [B, H, W, 2] (x, y) such that nxt(p + flow(p)) ~= prev(p)."""
    levels = _clamp_levels(levels, prev.shape[-2], prev.shape[-1], radius)
    pyr_p = [prev]
    pyr_n = [nxt]
    for _ in range(levels - 1):
        pyr_p.append(_avg_pool2(pyr_p[-1]))
        pyr_n.append(_avg_pool2(pyr_n[-1]))
    flow = torch.zeros(pyr_p[-1].shape + (2,), dtype=torch.float32,
                       device=prev.device)
    for lvl in range(levels - 1, -1, -1):
        p, n = pyr_p[lvl], pyr_n[lvl]
        if lvl != levels - 1:
            flow = 2.0 * resize(flow, (flow.shape[0], p.shape[1],
                                       p.shape[2], 2), "bilinear")
        flow = _lk_level(p, n, flow, radius, iters)
    return flow


def _sample_points(field: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """field [H, W] at pts [N, 2] (x, y) -> [N]."""
    return bilinear_gather(field[None, ..., None], pts[None, :, 0],
                           pts[None, :, 1])[0, :, 0]


def _track_device(gray: torch.Tensor, depth: torch.Tensor, density: int,
                  fb_thresh: float, levels: int, radius: int, iters: int):
    """gray [T, H, W] 0..1; depth [T, H, W] -> (tracks [T, N, 3],
    vis [T, N]): the whole chaining loop on the device."""
    t, h, w = gray.shape
    dev = gray.device
    fwd = dense_flow(gray[:-1], gray[1:], levels, radius, iters)
    bwd = dense_flow(gray[1:], gray[:-1], levels, radius, iters)

    ys = torch.arange(density // 2, h, density, dtype=torch.float32,
                      device=dev)
    xs = torch.arange(density // 2, w, density, dtype=torch.float32,
                      device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    cur = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)    # [N, 2]
    alive = torch.ones(cur.shape[0], dtype=torch.bool, device=dev)

    def inbounds(p):
        return ((p[:, 0] >= 0) & (p[:, 0] < w)
                & (p[:, 1] >= 0) & (p[:, 1] < h))

    tracks, vis = [], []
    for i in range(t - 1):
        alive = alive & inbounds(cur)
        d = _sample_points(depth[i], cur)
        tracks.append(torch.cat([cur, d[:, None]], dim=1))
        vis.append(alive)
        stepv = torch.stack([_sample_points(fwd[i, ..., 0], cur),
                             _sample_points(fwd[i, ..., 1], cur)], dim=1)
        nxt_pos = cur + stepv
        back = torch.stack([_sample_points(bwd[i, ..., 0], nxt_pos),
                            _sample_points(bwd[i, ..., 1], nxt_pos)], dim=1)
        err = torch.linalg.vector_norm(stepv + back, dim=1)
        alive = alive & (err < fb_thresh)
        cur = nxt_pos
    alive = alive & inbounds(cur)
    tracks.append(torch.cat([cur, _sample_points(depth[-1], cur)[:, None]],
                            dim=1))
    vis.append(alive)
    return torch.stack(tracks), torch.stack(vis)


def track_video_flow_device(
    video: np.ndarray,                # [1,3,T,H,W] or [T,H,W,3] in [0,1]
    density: int = 10,
    depth_backend: Optional[str] = None,
    fb_thresh: float = 1.5,
    levels: int = 4,
    radius: int = 7,
    iters: int = 4,
    downscale: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The flow tracker: tracks [T, N, 3] (u, v, depth) and vis [T, N]
    bool, the contract of `tracking.track_video_flow`. The video goes to
    `device` once as fp16; only the sparse tracks come back.

    `downscale` runs the flow pyramid at 1/ds resolution (auto: 2 at
    >=384p, 1 below): tracks sample a `density`-pixel grid, so half-res
    flow costs ~4x less while the chained positions stay within the
    bilinear-resample error of the full-res flow. Off when `density` or
    the geometry is not divisible by ds (the grid would change size).

    The gray and depth inputs are rounded to float16 before they go to the
    device, as the JAX package ships them over its host link: the rounding
    moves values by up to 2^-11 of their size, and so the tracks, so it
    stays for the two packages to compute one function."""
    from flexam_tpu_torch.perception.depth import estimate_depth
    from flexam_tpu_torch.perception.tracking import _to_thwc

    dev = resolve_device(device)
    v = _to_thwc(video)
    t, h, w, _ = v.shape
    if downscale is None:
        downscale = 2 if min(h, w) >= 384 else 1
    ds = int(downscale)
    if ds < 1 or (ds & (ds - 1)) or density % ds or h % ds or w % ds:
        ds = 1
    depth = estimate_depth(v, backend=depth_backend, device=dev)  # [T,H,W]
    gray = torch.from_numpy((v @ LUMA).astype(np.float16)).to(dev).float()
    depth_t = torch.from_numpy(np.asarray(depth, np.float16)).to(dev).float()
    for _ in range(int(np.log2(ds)) if ds > 1 else 0):
        gray = _avg_pool2(gray)
        depth_t = _avg_pool2(depth_t)
    with torch.no_grad():
        tracks, vis = _track_device(
            gray, depth_t, int(density) // ds, float(fb_thresh) / ds,
            int(levels), int(radius), int(iters))
    if ds > 1:
        tracks = tracks * torch.tensor([ds, ds, 1.0], device=dev)
    return (tracks.float().cpu().numpy(), vis.cpu().numpy())
