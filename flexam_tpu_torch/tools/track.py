"""CLI: video -> DELTA-format tracks npz (+ solved camera poses).

Port of `flexam_tpu/tools/track.py`. Produces the `--tracks_npz` files the
demo and the server read, with the port's perception stack on the card
(or the CPU with `--platform cpu`): DenseTrack3D (FLEXAM_DELTA_CKPT or
`--delta_ckpt`) or the flow tracker, the depth registry
(FLEXAM_UNIDEPTH_CKPT / FLEXAM_DEPTH_BACKEND), and the track-based
camera-pose solver:

    python -m flexam_tpu_torch.tools.track --input clip.npz \\
        --output tracks.npz [--density 10] [--method auto|delta|flow] \\
        [--solve_poses]

The input is what `utils/media.py` reads without a decoder: an `.npz`
frame dump (`video` uint8 [T, H, W, 3]) or a 4-dim `.npy`. `--method flow`
runs JAX's baseline, the Farneback tracker (`perception/tracking.py
track_video_flow`), on the chosen device.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="video path")
    p.add_argument("--output", required=True, help="npz output path")
    p.add_argument("--density", type=int, default=10)
    p.add_argument("--method", default="auto",
                   choices=["auto", "delta", "flow"])
    p.add_argument("--video_length", type=int, default=97)
    p.add_argument("--sample_size", type=int, nargs=2, default=None,
                   metavar=("H", "W"))
    p.add_argument("--depth_backend", default=None)
    p.add_argument("--delta_ckpt", default=None)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU; none or cuda on the card")
    p.add_argument("--solve_poses", action="store_true",
                   help="also store extrinsics/intrinsics solved from "
                        "the tracks (camera-control ready)")
    args = p.parse_args(argv)

    from flexam_tpu_torch.demo import _device
    from flexam_tpu_torch.perception.tracking import (find_delta_checkpoint,
                                                      track_video_delta,
                                                      track_video_flow)
    from flexam_tpu_torch.utils.media import get_video_input

    device = _device(args.platform)
    size = tuple(args.sample_size) if args.sample_size else (512, 896)
    video, _, _ = get_video_input(args.input, args.video_length, size)
    if video is None:
        raise SystemExit(f"could not read {args.input}")
    t, h, w = video.shape[2], video.shape[3], video.shape[4]
    print(f"video: {t} frames @ {h}x{w}")

    method = args.method
    ckpt = args.delta_ckpt or find_delta_checkpoint()
    if method == "auto":
        method = "delta" if ckpt else "flow"
    if method == "delta":
        if not ckpt:
            raise SystemExit("--method delta needs densetrack3d.pth "
                             "(--delta_ckpt / FLEXAM_DELTA_CKPT)")
        print(f"tracking: DenseTrack3D ({ckpt})")
        tracks, vis = track_video_delta(video, density=args.density,
                                        ckpt=ckpt,
                                        depth_backend=args.depth_backend,
                                        device=device)
    else:
        print("tracking: optical-flow baseline")
        tracks, vis = track_video_flow(video, density=args.density,
                                       depth_backend=args.depth_backend,
                                       device=device)

    out = {"tracks": tracks.astype(np.float32),
           "visibility": vis.astype(bool)}
    if args.solve_poses:
        from flexam_tpu_torch.perception.pose_solver import \
            solve_camera_poses
        extr, intr = solve_camera_poses(tracks, vis, width=w, height=h)
        out["extrinsics"] = extr
        out["intrinsics"] = intr
        print("poses: solved per-frame extrinsics (frame-0 world)")
    np.savez(args.output, **out)
    print(f"wrote {args.output}: tracks {tracks.shape}, "
          f"vis {vis.shape}" + (", extr/intr" if args.solve_poses else ""))


if __name__ == "__main__":
    main()
