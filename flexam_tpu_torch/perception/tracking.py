"""Dense 3D tracking of a video: DELTA (DenseTrack3D) and the flow tracker.

Port of `flexam_tpu/perception/tracking.py`. The reference's tracks come
from DELTA DenseTrack3D + UniDepth (`pipelines.py:1362-1499`);
`track_video_delta` runs the port's DenseTrack3D on a depth from the
registry (`perception/depth.py`) and subsamples its dense grid by
`density`. `dispatch_tracking` is the demo's and the server's choice
between it and the flow tracker.

Deliberate divergence: the JAX package's host flow tracker
(`track_video_flow`) is OpenCV's Farneback, and the port has no OpenCV.
Here `track_video_flow` keeps JAX's signature and raises, and the flow
method is the device tracker (`perception/flow_device.py`, JAX's
`flow_jax.py`) on every device; FLEXAM_FLOW=host raises.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


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


def _opencv_flow():
    return NotImplementedError(
        "the host flow tracker is OpenCV's Farneback, which the PyTorch "
        "port does not use; the flow method runs the device tracker "
        "(perception.flow_device.track_video_flow_device; unset "
        "FLEXAM_FLOW=host)")


def dispatch_tracking(video, method: str = "auto", density: int = 10,
                      ckpt: Optional[str] = None,
                      depth_backend: Optional[str] = None,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Shared tracker dispatch (demo CLI and serve): 'delta' uses the
    learned tracker when a checkpoint exists and falls back to the flow
    tracker otherwise (random-weight DELTA gives noise tracks; never serve
    those silently); 'auto' picks delta iff a checkpoint is found; 'flow'
    forces the flow tracker. Runs on `device`."""
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
    if os.environ.get("FLEXAM_FLOW", "auto") == "host":
        raise _opencv_flow()
    from flexam_tpu_torch.perception.flow_device import \
        track_video_flow_device
    return track_video_flow_device(video, density=density,
                                   depth_backend=depth_backend,
                                   device=device)


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


def track_video_flow(
    video: np.ndarray,                 # [1,3,T,H,W] or [T,H,W,3] in [0,1]
    density: int = 10,
    depth_backend: Optional[str] = None,
    fb_thresh: float = 1.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's host baseline, OpenCV's Farneback: not in the port, which has
    no OpenCV (the module docstring). `dispatch_tracking(video, "flow")`
    runs the device tracker instead."""
    raise _opencv_flow()
