"""Pi3: the permutation-equivariant multi-view pose and geometry model.

Port of `flexam_tpu/perception/pi3.py`, in torch ops on the caller's
device (CUDA unless the caller asks for the CPU). The reference's video
camera path runs `Pi3.from_pretrained("yyfz233/Pi3")(imgs[None]) ->
pred['camera_poses'] [B, N, 4, 4]` (c2w) inside `CameraMotionGenerator.
process_video_file`, then converts c2w -> w2c and synthesizes intrinsics
from a fixed 55-degree FoV. The Pi3 source is absent from the reference
snapshot, so, as in JAX, this is the published architecture family (the
DINOv2 encoder of the UniDepth port, an alternating view-local / global
attention decoder, pose and point heads) behind that surface:

  * `Pi3.from_pretrained(...)`: a local path, else FLEXAM_PI3_CKPT (never
    the network), through the shape-signature mapper with coverage gating,
    else random init with a warning;
  * `model(imgs[None])` with imgs [N, 3, H, W] in 0..1 -> dict of numpy
    `camera_poses` [B, N, 4, 4] c2w, `points` [B, N, H, W, 3] and `conf`
    [B, N, H, W, 1];
  * `load_images_as_tensor(path, interval=1)` -> [N, 3, H, W]: the port
    reads no `.mp4`; it takes the `<name>.mp4.npz` frame dump that
    `save_video` writes without an encoder when only the dump exists, as
    JAX's does, and a real video raises naming the decoder.

Views interact only through order-agnostic global attention (no
view-index encoding anywhere), so permuting the views permutes the
outputs. The pose head's last layer is zero-initialised and its
quaternion biased to identity, so a random Pi3 emits identity rotations.
Frames are resized as OpenCV's INTER_AREA does
(`utils.media.resize_frames_area`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.core.layers import linear, linear_init
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.perception.unidepth import (IMAGENET_MEAN,
                                                  IMAGENET_STD,
                                                  UniDepthV2Config,
                                                  _attn_block,
                                                  _attn_block_init, _gelu,
                                                  _ln, _ln_init,
                                                  encode_image, encoder_init)


@dataclass(frozen=True)
class Pi3Config:
    # encoder: DINOv2 ViT-L/14 (shared family with the UniDepth/MoGe ports)
    patch_size: int = 14
    embed_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    num_register_tokens: int = 4
    pretrain_img_size: int = 518
    # decoder: alternating view-local / global attention
    dec_dim: int = 1024
    dec_depth: int = 12            # pairs of (frame, global) blocks
    dec_heads: int = 16
    mlp_expansion: int = 4
    # inference resize target (multiple of patch_size); the reference
    # requests width=672, height=384 -> snapped to /14
    infer_hw: Tuple[int, int] = (378, 672)
    compute: str = "float32"

    def encoder_cfg(self) -> UniDepthV2Config:
        return UniDepthV2Config(
            patch_size=self.patch_size, embed_dim=self.embed_dim,
            depth=self.enc_depth, num_heads=self.enc_heads,
            num_register_tokens=self.num_register_tokens,
            output_idx=(self.enc_depth,),
            pretrain_img_size=self.pretrain_img_size)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute == "bfloat16" else torch.float32


def pi3_init(gen, cfg: Pi3Config, device="cuda") -> dict:
    device = resolve_device(device)
    d = cfg.dec_dim

    def block():
        return _attn_block_init(gen, d, cfg.mlp_expansion, cfg.dec_heads,
                                0.0, device)

    return {
        "encoder": encoder_init(gen, cfg.encoder_cfg(), device),
        "proj_in": linear_init(gen, cfg.embed_dim, d, device=device),
        "dec_frame": [block() for _ in range(cfg.dec_depth)],
        "dec_global": [block() for _ in range(cfg.dec_depth)],
        "dec_norm": _ln_init(d, device),
        # camera head: learnable query attends over a view's tokens
        "cam_query": torch.randn((1, 1, d), generator=gen,
                                 device=device) * 0.02,
        "cam_pool": block(),
        "cam_fc1": linear_init(gen, d, d, device=device),
        # 7 outputs: quat wxyz + translation; zero-init the final layer so
        # init poses are exactly identity (quat bias in _quat_trans_to_c2w)
        "cam_fc2": {"weight": torch.zeros((7, d), device=device),
                    "bias": torch.zeros((7,), device=device)},
        # point head: per-token linear -> patch of 3D points + confidence
        "pt_fc1": linear_init(gen, d, d, device=device),
        "pt_fc2": linear_init(gen, d, cfg.patch_size * cfg.patch_size * 4,
                              device=device),
    }


def _quat_trans_to_c2w(qt: torch.Tensor) -> torch.Tensor:
    """[..., 7] (quat wxyz biased to identity + trans) -> [..., 4, 4]."""
    bias = torch.tensor([1.0, 0, 0, 0], dtype=qt.dtype, device=qt.device)
    quat = qt[..., :4] + bias
    t = qt[..., 4:7]
    q = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(qt.shape[:-1] + (3, 3))
    top = torch.cat([R, t[..., None]], dim=-1)                  # [..., 3, 4]
    bottom = torch.tensor([0, 0, 0, 1], dtype=qt.dtype,
                          device=qt.device).expand(qt.shape[:-1] + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def _f32(lin):
    return {k: v.float() for k, v in lin.items()}


def pi3_forward(params: dict, cfg: Pi3Config, imgs: torch.Tensor) -> dict:
    """imgs [B, N, 3, H, W] in 0..1 -> {"camera_poses" [B, N, 4, 4],
    "points" [B, N, H, W, 3], "conf" [B, N, H, W, 1]}."""
    b, n, _, h, w = imgs.shape
    x = imgs.permute(0, 1, 3, 4, 2).reshape(b * n, h, w, 3)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device, dtype=x.dtype)
    std = torch.as_tensor(IMAGENET_STD, device=x.device, dtype=x.dtype)
    x = ((x - mean) / std).to(cfg.dtype)

    feats, _ = encode_image(params["encoder"], x, cfg.encoder_cfg())
    f = feats[-1]                                       # [B*N, h0, w0, C]
    h0, w0 = f.shape[1], f.shape[2]
    ptoks = h0 * w0
    tok = linear(f.reshape(b * n, ptoks, cfg.embed_dim), params["proj_in"])

    # alternating view-local / order-agnostic global attention (the
    # permutation-equivariant core: no view-index encoding anywhere)
    for fp, gp in zip(params["dec_frame"], params["dec_global"]):
        tok = _attn_block(fp, tok, cfg.dec_heads)               # per view
        tok = tok.reshape(b, n * ptoks, cfg.dec_dim)
        tok = _attn_block(gp, tok, cfg.dec_heads)               # all views
        tok = tok.reshape(b * n, ptoks, cfg.dec_dim)
    tok = _ln(tok, params["dec_norm"])

    # camera head: query-token attention pool per view -> quat+trans
    q = params["cam_query"].to(tok.dtype).expand(b * n, 1, cfg.dec_dim)
    pooled = _attn_block(params["cam_pool"], q, cfg.dec_heads,
                         context=tok)[:, 0]                     # [B*N, D]
    qt = linear(_gelu(linear(pooled.float(), _f32(params["cam_fc1"]))),
                _f32(params["cam_fc2"]))
    poses = _quat_trans_to_c2w(qt).reshape(b, n, 4, 4)

    # point head: per-token patch of (xyz, conf)
    pt = linear(_gelu(linear(tok, params["pt_fc1"])), params["pt_fc2"])
    ps = cfg.patch_size
    pt = pt.reshape(b * n, h0, w0, ps, ps, 4)
    pt = pt.permute(0, 1, 3, 2, 4, 5).reshape(b, n, h0 * ps, w0 * ps, 4)
    return {
        "camera_poses": poses.float(),
        "points": pt[..., :3].float(),
        "conf": torch.sigmoid(pt[..., 3:4]).float(),
    }


class Pi3:
    """Reference call surface (`pipelines.py:276-290`); the params live on
    `device`."""

    def __init__(self, cfg: Optional[Pi3Config] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg or Pi3Config()
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = pi3_init(gen, self.cfg, self.device)
        self.load_report = None
        self.load_ok = False

    # torch-API shims (the reference does .to(device).eval())
    def to(self, *a, **k):
        return self

    def eval(self):
        return self

    def cuda(self):
        return self

    @classmethod
    def from_pretrained(cls, name_or_path: str = "yyfz233/Pi3",
                        cfg: Optional[Pi3Config] = None,
                        device="cuda") -> "Pi3":
        """A local path, else FLEXAM_PI3_CKPT; never the network."""
        path = None
        if os.path.exists(str(name_or_path)):
            path = str(name_or_path)
        elif os.environ.get("FLEXAM_PI3_CKPT"):
            path = os.environ["FLEXAM_PI3_CKPT"]
        if path:
            return load_pi3(path, cfg=cfg, device=device)
        print("WARNING: no Pi3 weights found (set FLEXAM_PI3_CKPT) — "
              "random-weight Pi3 emits near-identity poses; the "
              "track-based Kabsch solver (perception.pose_solver) is "
              "the better no-checkpoint fallback")
        return cls(cfg, device=device)

    @torch.no_grad()
    def __call__(self, imgs) -> dict:
        x = torch.as_tensor(np.asarray(imgs, np.float32), device=self.device)
        if x.dim() == 4:
            x = x[None]
        if x.dim() != 5:
            raise ValueError("imgs must be [N, 3, H, W] or [B, N, 3, H, W]")
        return {k: v.cpu().numpy()
                for k, v in pi3_forward(self.params, self.cfg, x).items()}


def load_pi3(path: str, model: Optional[Pi3] = None,
             coverage_threshold: float = 0.9,
             cfg: Optional[Pi3Config] = None, device="cuda") -> Pi3:
    """Shape-signature checkpoint mapping with coverage gating (the policy
    of load_densetrack3d/load_moge), into `model` or a new Pi3 of `cfg` on
    `device`. The file is read before a model is built."""
    from flexam_tpu_torch.io.verify_load import check_mapping
    from flexam_tpu_torch.perception.densetrack3d import (
        map_torch_state_dict, read_state_dict)

    sd = read_state_dict(path, ("model.safetensors", "model.pt",
                                "pytorch_model.bin"))
    model = model or Pi3(cfg, device=device)
    model.params, report = map_torch_state_dict(model.params, sd)
    model.load_report = report
    model.load_ok = check_mapping(report, quiet=True,
                                  threshold=coverage_threshold)
    print(f"pi3: mapped {len(report['loaded'])} tensors, "
          f"{len(report['missed'])} unmatched (best-effort)")
    if not model.load_ok:
        check_mapping(report, name=f"pi3[{path}]",
                      threshold=coverage_threshold)
        print("WARNING: pi3 checkpoint mapping is LOW-COVERAGE — "
              "unmatched modules stay at random init")
    return model


def load_images_as_tensor(path: str, interval: int = 1,
                          target_hw: Optional[Tuple[int, int]] = None
                          ) -> np.ndarray:
    """Video file -> [N, 3, H, W] float32 in 0..1, every `interval`-th
    frame, resized (OpenCV's INTER_AREA) to a patch-multiple target (the
    Pi3 loader surface, `pipelines.py:281`). Reads the `.npz` frame dump
    (`path` itself, or `path + ".npz"` when only the dump exists); a video
    file needs a decoder the port does not use, and raises."""
    from flexam_tpu_torch.utils.media import _no_decoder, resize_frames_area

    hw = target_hw or Pi3Config().infer_hw
    npz = path if path.endswith(".npz") else (
        path + ".npz" if os.path.exists(path + ".npz")
        and not os.path.exists(path) else None)
    if not (npz and os.path.exists(npz)):
        raise _no_decoder(path, "video")
    with np.load(npz) as z:
        raw = z["video"]                                # [T, H, W, 3] u8
    frames = resize_frames_area(raw[::interval], hw)
    arr = frames.astype(np.float32) / 255.0
    return arr.transpose(0, 3, 1, 2)


def pi3_video_poses(video: np.ndarray, model: Optional[Pi3] = None,
                    chunk: int = 8, device="cuda") -> np.ndarray:
    """[T, H, W, 3] (or [T, 3, H, W]) 0..1 -> c2w poses [T, 4, 4].

    Views are processed in ONE forward (global attention needs all views
    jointly); `chunk` bounds the N*P global-attention cost by striding the
    frames (every ceil(T / (4 chunk))-th, plus the last), then the poses
    are interpolated back: the nearest earlier view's rotation and a
    linearly interpolated translation. Without `model`,
    `Pi3.from_pretrained` on `device`."""
    from flexam_tpu_torch.utils.media import resize_frames_area

    v = np.asarray(video, np.float32)
    if not (v.ndim == 4 and v.shape[-1] == 3):
        v = v.transpose(0, 2, 3, 1)
    t = v.shape[0]
    model = model or Pi3.from_pretrained(device=device)
    resized = resize_frames_area(v, model.cfg.infer_hw).transpose(0, 3, 1, 2)
    idx = pi3_views(t, chunk)
    pred = model(resized[idx])
    poses = pred["camera_poses"][0]                    # [len(idx), 4, 4]
    if len(idx) == t:
        return poses
    out = np.empty((t, 4, 4), np.float32)
    for i in range(t):
        j = np.searchsorted(idx, i, side="right") - 1
        out[i] = poses[min(j, len(idx) - 1)]
    for a in range(3):
        out[:, a, 3] = np.interp(np.arange(t), idx, poses[:, a, 3])
    return out


def pi3_views(t: int, chunk: int = 8) -> np.ndarray:
    """The frames `pi3_video_poses` runs of a T-frame clip."""
    stride = max(1, int(np.ceil(t / (chunk * 4))))
    idx = np.arange(0, t, stride)
    if idx[-1] != t - 1:
        idx = np.concatenate([idx, [t - 1]])
    return idx
