"""Dense 3D tracking of a video: DELTA (DenseTrack3D) and the flow tracker.

Port of `flexam_tpu/perception/tracking.py`. The reference's tracks come
from DELTA DenseTrack3D + UniDepth (`pipelines.py:1362-1499`);
`track_video_delta` runs the port's DenseTrack3D on a depth from the
registry (`perception/depth.py`) and subsamples its dense grid by
`density`. `track_video_flow` is JAX's baseline: OpenCV's Farneback flow
(`perception/farneback.py`, here on `device`) chained over a stride-
`density` grid with a forward-backward check. `dispatch_tracking` is the
demo's and the server's choice between them and the device LK tracker
(`perception/flow_device.py`), by JAX's rule.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def find_delta_checkpoint() -> Optional[str]:
    """Locate densetrack3d.pth like the reference does
    (`pipelines.py:1383`, `annotator/nodes.py:325-343`): the
    FLEXAM_DELTA_CKPT env var, then the reference's default checkpoint
    layout under ./checkpoints."""
    cand = os.environ.get("FLEXAM_DELTA_CKPT")
    if cand and os.path.exists(cand):
        return cand
    for base in ("checkpoints/Wan2.2-Fun-5B-FLEXAM", "checkpoints",
                 "checkpoints/DELTA"):
        p = os.path.join(base, "densetrack3d.pth")
        if os.path.exists(p):
            return p
    return None


def dispatch_tracking(video, method: str = "auto", density: int = 10,
                      ckpt: Optional[str] = None,
                      depth_backend: Optional[str] = None,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Shared tracker dispatch (demo CLI and serve): 'delta' uses the
    learned tracker when a checkpoint exists and falls back to the flow
    tracker otherwise (random-weight DELTA gives noise tracks; never serve
    those silently); 'auto' picks delta iff a checkpoint is found; 'flow'
    forces the flow tracker. Runs on `device`; the flow method is the
    device LK tracker there unless `device` is the CPU or FLEXAM_FLOW=host,
    which run the Farneback tracker on the CPU (FLEXAM_FLOW=device forces
    the LK tracker)."""
    method = (method or "auto").lower()
    ckpt = ckpt or find_delta_checkpoint()
    if method in ("delta", "auto") and ckpt:
        # a file is no evidence of trained weights: the mapper matches by
        # shape, so gate on its coverage report and fall back to the flow
        # tracker rather than run a mostly-random model; FLEXAM_FORCE_DELTA=1
        # takes a low-coverage load anyway
        from flexam_tpu_torch.perception.densetrack3d import \
            load_densetrack3d
        model = load_densetrack3d(ckpt, device=device)
        if model.load_ok or os.environ.get("FLEXAM_FORCE_DELTA") == "1":
            return track_video_delta(video, density=density, model=model,
                                     depth_backend=depth_backend,
                                     device=device)
        print(f"WARNING: {ckpt} mapped below coverage threshold — "
              "falling back to the optical-flow tracker (set "
              "FLEXAM_FORCE_DELTA=1 to use the partial load anyway)")
    elif method == "delta":
        print("NOTE: no densetrack3d.pth found — using the optical-flow "
              "baseline tracker instead of random weights")
    # the flow method, JAX's rule: the device LK tracker on the accelerator
    # (CUDA here, the TPU in JAX) or under FLEXAM_FLOW=device, Farneback on
    # the CPU; FLEXAM_FLOW=host runs Farneback on the CPU
    choice = os.environ.get("FLEXAM_FLOW", "auto")
    if choice != "host":
        if choice == "device" or torch.device(device).type != "cpu":
            from flexam_tpu_torch.perception.flow_device import \
                track_video_flow_device
            return track_video_flow_device(video, density=density,
                                           depth_backend=depth_backend,
                                           device=device)
    return track_video_flow(video, density=density,
                            depth_backend=depth_backend, device="cpu")


def track_video_delta(
    video: np.ndarray,                 # [1,3,T,H,W] or [T,H,W,3] in [0,1]
    density: int = 10,
    ckpt: Optional[str] = None,
    depth_backend: Optional[str] = None,
    model=None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Learned dense tracking, the `generate_tracking_DELTA` flow
    (`pipelines.py:1362-1499`): depth estimation -> DenseTrack3D ->
    stride-`density` subsample of the dense grid. Returns
    (tracks [T, N, 3] with (u, v, depth), visibility [T, N] bool).

    Runs on `model`'s device; without a model, on `device` (CUDA unless
    the caller asks for the CPU). The density subsample runs on the device,
    so only the sparse tracks come back."""
    from flexam_tpu_torch.perception.densetrack3d import (
        DensePredictor3D, DenseTrack3D, load_densetrack3d)
    from flexam_tpu_torch.perception.depth import estimate_depth

    v = _to_thwc(video)
    if model is None:
        dev = "cuda" if device is None else device
        ckpt = ckpt or find_delta_checkpoint()
        if ckpt:
            model = load_densetrack3d(ckpt, device=dev)
        else:
            print("WARNING: no densetrack3d.pth found — random-weight "
                  "DenseTrack3D (set FLEXAM_DELTA_CKPT; quality needs "
                  "trained weights)")
            model = DenseTrack3D(device=dev)
    depth = estimate_depth(v, backend=depth_backend,
                           device=model.device)            # [T, H, W]
    out = DensePredictor3D(model)(
        v.transpose(0, 3, 1, 2)[None],                     # [1,T,3,H,W]
        depth[None, :, None],                              # [1,T,1,H,W]
        grid_query_frame=0, downsample=density)
    uv = out["trajs_uv"][0].float().cpu().numpy()          # [T, N, 2]
    dep = out["trajs_depth"][0, ..., 0].float().cpu().numpy()
    vis = out["vis"][0].cpu().numpy() > 0.5
    tracks = np.concatenate([uv, dep[..., None]], axis=-1)
    return tracks.astype(np.float32), vis


def _to_thwc(video) -> np.ndarray:
    v = np.asarray(video, np.float32)
    if v.ndim == 5:
        v = v[0].transpose(1, 2, 3, 0)
    return v


def _sample_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """img [H, W(, C)], xy [N, 2] -> [N(, C)] float64 with border clamp:
    JAX's numpy `_sample_bilinear` in its dtypes (a float32 `xy` is
    clipped at float32 bounds; the fractions, and so the sums, are
    float64)."""
    h, w = img.shape[:2]
    hi_x, hi_y = w - 1.001, h - 1.001
    if xy.dtype == torch.float32:
        hi_x, hi_y = float(np.float32(hi_x)), float(np.float32(hi_y))
    x = xy[:, 0].clamp(0, hi_x)
    y = xy[:, 1].clamp(0, hi_y)
    x0 = x.to(torch.int32).long()
    y0 = y.to(torch.int32).long()
    fx = x.double() - x0.double()
    fy = y.double() - y0.double()
    if img.dim() == 3:
        fx, fy = fx[:, None], fy[:, None]
    a = img[y0, x0]
    b = img[y0, x0 + 1]
    c = img[y0 + 1, x0]
    d = img[y0 + 1, x0 + 1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


FLOW_PAIRS = 8          # frame pairs whose flows track_video_flow batches


def track_video_flow(
    video: np.ndarray,                 # [1,3,T,H,W] or [T,H,W,3] in [0,1]
    density: int = 10,
    depth_backend: Optional[str] = None,
    fb_thresh: float = 1.5,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's host baseline tracker on `device`: OpenCV's Farneback flow
    (pyr_scale 0.5, 3 levels, winsize 15, 3 iterations, poly_n 5,
    poly_sigma 1.2) forward and backward between consecutive frames,
    FLOW_PAIRS pairs a batch (the memory stays that of FLOW_PAIRS pairs
    whatever the clip's length), chained over a stride-`density` grid of
    frame 0;
    a track dies out of bounds or when its forward-backward error reaches
    `fb_thresh`. Returns (tracks [T, N, 3] with (u, v, depth), visibility
    [T, N]) in the DELTA format the rasterizers take."""
    from flexam_tpu_torch.device import resolve_device
    from flexam_tpu_torch.perception.depth import estimate_depth
    from flexam_tpu_torch.perception.farneback import farneback_pairs

    dev = resolve_device(device)
    v = _to_thwc(video)
    t, h, w, _ = v.shape
    # JAX's gray frames, the same numpy expression on the host
    gray = np.stack([(f @ np.array([0.299, 0.587, 0.114], np.float32) * 255
                      ).astype(np.uint8) for f in v])

    ys = np.arange(density // 2, h, density, dtype=np.float32)
    xs = np.arange(density // 2, w, density, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)   # [N, 2]
    n = len(pts)

    depth = estimate_depth(v, backend=depth_backend, device=dev)  # [T,H,W]
    depth = torch.from_numpy(np.asarray(depth, np.float32)).to(dev)
    frames = torch.from_numpy(gray).to(dev)

    tracks = torch.zeros((t, n, 3), dtype=torch.float32, device=dev)
    vis = torch.zeros((t, n), dtype=torch.bool, device=dev)
    cur = torch.from_numpy(pts).to(dev)     # float64 from the first step
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for i in range(t):
        inb = ((cur[:, 0] >= 0) & (cur[:, 0] < w)
               & (cur[:, 1] >= 0) & (cur[:, 1] < h))
        alive &= inb
        tracks[i, :, :2] = cur
        tracks[i, :, 2] = _sample_bilinear(depth[i], cur)
        vis[i] = alive
        if i == t - 1:
            break
        if i % FLOW_PAIRS == 0:       # the next pairs' flows, both ways
            p = np.arange(i, min(i + FLOW_PAIRS, t - 1))
            flows = farneback_pairs(frames, np.concatenate([p, p + 1]),
                                    np.concatenate([p + 1, p]))
            fwd, bwd = flows[:len(p)], flows[len(p):]
        step = _sample_bilinear(fwd[i % FLOW_PAIRS], cur)      # [N, 2]
        nxt = cur + step
        # forward-backward consistency: a point that lands somewhere the
        # backward flow does not return from is occluded / lost
        back = _sample_bilinear(bwd[i % FLOW_PAIRS], nxt)
        err = torch.sqrt(((step + back) ** 2).sum(dim=1))
        alive &= err < fb_thresh
        cur = nxt
    return tracks.cpu().numpy(), vis.cpu().numpy()
