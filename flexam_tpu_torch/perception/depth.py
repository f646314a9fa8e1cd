"""Depth-estimation backends for video-input conditioning.

Port of `flexam_tpu/perception/depth.py`, the same registry:

  * `register_depth_backend(name, fn)` plugs a model in:
    fn(video [T,H,W,3] float 0..1, **kw) -> depth [T,H,W] float;
  * "unidepth": UniDepth V2 (`perception/unidepth.py`), weights from
    FLEXAM_UNIDEPTH_CKPT (random weights, with a warning, without it);
  * "luminance": a geometry-free placeholder (inverse luminance as
    pseudo-depth), so that paths run end to end without a model;
  * "dav2" / "dav": Depth-Anything-V2-Large (`perception/depth_anything.py`),
    weights from FLEXAM_DAV2_CKPT;
  * "zoe": ZoeDepth ZoeD_M12_N (`perception/zoedepth.py`), weights from
    FLEXAM_ZOE_CKPT (random weights, with a warning, without it);
  * "onnx": a user's ONNX depth model (FLEXAM_DEPTH_ONNX, e.g. a MiDaS /
    Depth-Anything export). JAX runs it through onnxruntime on the host;
    the port through its own reader and graph runner (`io/onnx.py`,
    `perception/onnx_graph.py`) on the caller's device;
  * "depthcrafter": the DepthCrafter surface (`perception/depthcrafter.py`)
    around the SVD UNet (FLEXAM_DEPTHCRAFTER_CKPT + FLEXAM_SVD_VAE), or
    JAX's substitute denoiser without them.

`estimate_depth` picks a backend as JAX's does: the argument, then
FLEXAM_DEPTH_BACKEND, then the first model whose checkpoint exists
(FLEXAM_UNIDEPTH_CKPT, FLEXAM_DAV2_CKPT, FLEXAM_ZOE_CKPT), then luminance.
Keyword arguments go to the backend; the port's model backends take
`device=` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict

import numpy as np

DEPTH_BACKENDS: Dict[str, Callable] = {}


def register_depth_backend(name: str, fn: Callable) -> None:
    DEPTH_BACKENDS[name] = fn


def _luminance_depth(video: np.ndarray, **kw) -> np.ndarray:
    print("WARNING: 'luminance' pseudo-depth backend (placeholder; "
          "register a real depth model for geometric accuracy)",
          file=sys.stderr)
    lum = video @ np.array([0.299, 0.587, 0.114], np.float32)
    return 1.0 / (lum + 0.5)


def _onnx_depth(video: np.ndarray, size: int = 384, device="cuda",
                **kw) -> np.ndarray:
    """The ONNX hook: each frame resized to `size` x `size` (OpenCV's
    INTER_LINEAR, `utils/media.resize_frames_linear`, as JAX's
    `cv2.resize`), run through the graph as [1, 3, size, size] float32,
    its output squeezed and resized back to the frame's size."""
    from flexam_tpu_torch.perception.onnx_graph import OnnxGraph
    from flexam_tpu_torch.utils.media import resize_frames_linear
    path = os.environ.get("FLEXAM_DEPTH_ONNX")
    if not path:
        raise RuntimeError("set FLEXAM_DEPTH_ONNX=<model.onnx>")
    graph = OnnxGraph(path, device=device)
    t, h, w, _ = video.shape
    out = np.zeros((t, h, w), np.float32)
    for i, frame in enumerate(video):
        x = resize_frames_linear(frame[None], (size, size))[0]
        x = x.transpose(2, 0, 1)[None].astype(np.float32)
        d = np.squeeze(graph(x)[0][0].float().cpu().numpy())
        out[i] = resize_frames_linear(d[None, :, :, None], (h, w))[0, ..., 0]
    return out


def _unidepth_lazy(video: np.ndarray, **kw) -> np.ndarray:
    """UniDepth V2, the reference's depth model (`pipelines.py:1393-1405`),
    in `perception/unidepth.py`; lazy so the registry import stays light.
    Weights: FLEXAM_UNIDEPTH_CKPT."""
    from flexam_tpu_torch.perception.unidepth import _unidepth_backend
    return _unidepth_backend(video, **kw)


def _zoe_lazy(video: np.ndarray, **kw) -> np.ndarray:
    """ZoeDepth (ZoeD_M12_N), the `VideoToDepth` annotator's model
    (`annotator/nodes.py:153-233`). Weights: FLEXAM_ZOE_CKPT."""
    from flexam_tpu_torch.perception.zoedepth import zoe_depth_video
    return zoe_depth_video(video, **kw)


def _depthcrafter_lazy(video: np.ndarray, **kw) -> np.ndarray:
    """The DepthCrafter surface (`pipelines.py:1307-1360`, a disabled
    branch there) around the SVD UNet denoiser. Weights:
    FLEXAM_DEPTHCRAFTER_CKPT + FLEXAM_SVD_VAE (+ FLEXAM_SVD_CLIP)."""
    from flexam_tpu_torch.perception.depthcrafter import \
        _depthcrafter_backend
    return _depthcrafter_backend(video, **kw)


def _dav2_lazy(video: np.ndarray, **kw) -> np.ndarray:
    """Depth-Anything-V2-Large, the reference repaint's default depth model
    ("dav", `pipelines.py:158-161`). Weights: FLEXAM_DAV2_CKPT."""
    from flexam_tpu_torch.perception.depth_anything import _dav2_backend
    return _dav2_backend(video, **kw)


register_depth_backend("luminance", _luminance_depth)
register_depth_backend("onnx", _onnx_depth)
register_depth_backend("unidepth", _unidepth_lazy)
register_depth_backend("zoe", _zoe_lazy)
register_depth_backend("depthcrafter", _depthcrafter_lazy)
register_depth_backend("dav2", _dav2_lazy)
register_depth_backend("dav", _dav2_lazy)      # the reference's name


def estimate_depth(video: np.ndarray, backend: str = None, **kw
                   ) -> np.ndarray:
    """video [T,H,W,3] float 0..1 (or [1,3,T,H,W]) -> depth [T,H,W]."""
    v = np.asarray(video, np.float32)
    if v.ndim == 5:
        v = v[0].transpose(1, 2, 3, 0)
    if backend is None:
        backend = os.environ.get("FLEXAM_DEPTH_BACKEND") or None
    if backend is None:
        # a real model when its checkpoint is there: UniDepth (the
        # reference pipeline's depth model) first, then DAv2, then ZoeDepth
        uni = os.environ.get("FLEXAM_UNIDEPTH_CKPT")
        zoe = os.environ.get("FLEXAM_ZOE_CKPT")
        dav = os.environ.get("FLEXAM_DAV2_CKPT")
        if uni and os.path.exists(uni):
            backend = "unidepth"
        elif dav and os.path.exists(dav):
            backend = "dav2"
        elif zoe and os.path.exists(zoe):
            backend = "zoe"
        else:
            backend = "luminance"
    if backend not in DEPTH_BACKENDS:
        raise KeyError(f"unknown depth backend {backend!r}; "
                       f"have {sorted(DEPTH_BACKENDS)}")
    return np.asarray(DEPTH_BACKENDS[backend](v, **kw), np.float32)
