"""The flow tracker's accuracy on a clip with a known motion.

    python -m flexam_tpu_torch.tools.flow_accuracy [--platform cpu]
        [--frames 97] [--size 512 896] [--shift 1 1] [--seed 1304]

A smooth random texture (`textured_clip`) seen through a window that
slides `shift` px a frame, so every scene point moves by -shift a frame:
the one check of a tracker that needs no trained weights. Prints one JSON
line: the per-step error of the tracks' steps against -shift (its mean and
standard deviation per axis, over the steps of visible tracks), and at the
last frame, over the tracks whose true position stays 16 px inside the
frame and that are still visible, the median and p90 end-point error, the
mean error vector's length and the visible share. `chip_smoke.py` holds
the card's tracker to these (its phase `track`, part (b)).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def textured_clip(frames: int, height: int, width: int, shift, seed: int,
                  device="cpu") -> np.ndarray:
    """uint8 [T, H, W, 3]: Gaussian noise on a grid 8x coarser, bicubically
    upsampled (`core.resize`), seen through a window that slides `shift` =
    (dx, dy) px a frame."""
    import torch

    from flexam_tpu_torch.core.resize import resize
    dx, dy = shift
    bh = (height + dy * (frames - 1)) // 8 + 4
    bw = (width + dx * (frames - 1)) // 8 + 4
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((1, bh, bw, 3), generator=gen, device=device)
    big = resize(base, (1, bh * 8, bw * 8, 3), "bicubic", antialias=False)[0]
    big = (big - big.min()) / (big.max() - big.min())
    out = torch.stack([big[8 + dy * i: 8 + dy * i + height,
                           8 + dx * i: 8 + dx * i + width]
                       for i in range(frames)])
    return (out * 255).round().to(torch.uint8).cpu().numpy()


def end_point_errors(tracks: np.ndarray, vis: np.ndarray, shift,
                     height: int, width: int, margin: int = 16) -> dict:
    """The statistics of the module docstring for tracks [T, N, 3] and
    vis [T, N] of a clip moving by -shift a frame."""
    t = tracks.shape[0]
    v = -np.asarray(shift, np.float32)
    end = tracks[0, :, :2] + v * (t - 1)
    inside = ((end[:, 0] >= margin) & (end[:, 0] < width - margin)
              & (end[:, 1] >= margin) & (end[:, 1] < height - margin))
    sel = inside & vis[-1]
    miss = tracks[-1, :, :2] - end
    err = np.linalg.norm(miss, axis=1)
    steps = (tracks[1:, :, :2] - tracks[:-1, :, :2] - v)[vis[1:]]
    return {
        "step_error_mean_px": steps.mean(0).tolist(),
        "step_error_std_px": steps.std(0).tolist(),
        "median_end_point_error_px": float(np.median(err[sel])),
        "p90_end_point_error_px": float(np.percentile(err[sel], 90)),
        "mean_error_px": float(np.linalg.norm(miss[sel].mean(0))),
        "end_point_error_std_px": miss[sel].std(0).tolist(),
        "inside_tracks": int(inside.sum()),
        "visible_share": float(sel.sum() / max(inside.sum(), 1))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU; none or cuda on the card")
    p.add_argument("--frames", type=int, default=97)
    p.add_argument("--size", type=int, nargs=2, default=[512, 896],
                   metavar=("H", "W"))
    p.add_argument("--shift", type=int, nargs=2, default=[1, 1],
                   metavar=("DX", "DY"))
    p.add_argument("--density", type=int, default=10)
    p.add_argument("--seed", type=int, default=1304)
    args = p.parse_args(argv)

    from flexam_tpu_torch.demo import _device
    from flexam_tpu_torch.perception.flow_device import \
        track_video_flow_device
    device = _device(args.platform)
    h, w = args.size
    clip = textured_clip(args.frames, h, w, args.shift, args.seed, device)
    tracks, vis = track_video_flow_device(clip.astype(np.float32) / 255.0,
                                          density=args.density,
                                          device=device)
    print(json.dumps({"device": device, "frames": args.frames,
                      "size": [h, w], "shift": args.shift,
                      "tracks": list(tracks.shape),
                      **end_point_errors(tracks, vis, args.shift, h, w)}))


if __name__ == "__main__":
    main()
