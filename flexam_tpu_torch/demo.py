"""CLI driver of the PyTorch port (`python -m flexam_tpu_torch.demo`).

Port of `flexam_tpu/demo.py` (the reference's `demo.py:146-415`): the
generate modes full_edit (motion transfer), foreground_edit and
background_edit, camera control (`--camera_motion`, `--pose_file`) and
object manipulation (`--object_motion` + `--object_mask`), composable as in
the reference. It runs on the CUDA card, or on the CPU with
`--platform cpu`.

Inputs come from files, as in the JAX CLI; the port reads the formats that
need no decoder (`utils/media.py`: numpy arrays, `.npy`, and `.npz` frame
dumps with `video` [T, H, W, 3] uint8 and `fps`):
  --input_path       a video (.npz dump or 4-dim .npy) or an image (.npy);
                     none: zeros
  --tracks_npz       tracks [T,N,3] (u, v, depth) + visibility [T,N]
                     (+ optional extrinsics [T,3,4] / intrinsics [T,3,3])
  --moge_npz         MoGe point map: points [H,W,3] + mask [H,W]
                     + intrinsics [3,3] (the image-input path)
  --poses_npz        recorded camera poses (`perception/poses.py`);
                     without it, or extrinsics in the tracks, poses are
                     solved from the tracks (`perception/pose_solver.py`)
  --repaint PATH     the repainted first frame (.npy image)
  --mask_path        the mask video of fg/bg edits (.npz dump or .npy)
  --object_mask      the object mask image (.npy)
  --synthetic_tracks a deterministic drifting grid of tracks

Weights: `--checkpoint_path` with {the DiT's *.safetensors shards,
Wan2.2_VAE.pth, models_t5_umt5-xxl-enc-bf16.pth, google/umt5-xxl}, or
`--random_init tiny|5b`. Without a tokenizer (random weights) the prompt
goes in as hashed ids.

Quantized DiT weights: `--quant int8|fp8` (or FLEXAM_QUANT) quantizes the
DiT when the pipeline is built, from the float32 values of a checkpoint as
it loads; `--prequant FILE` serves a `tools/prequant_ckpt.py` file (or a
serve bundle with `dit/` + `vae/`) in its mode, in place of the
checkpoint's or the random DiT.

A video without tracks is tracked on the device (`perception/
tracking.py dispatch_tracking`): `--tracking_method DELTA` (the default)
runs DenseTrack3D from `--delta_ckpt` / FLEXAM_DELTA_CKPT, or the flow
tracker when no checkpoint maps; `--tracking_method flow` runs JAX's
baseline, the Farneback tracker (`perception/tracking.py
track_video_flow`, OpenCV's Farneback rebuilt in `perception/
farneback.py`), on the demo's device. `--repaint true` generates the
first frame natively, depth-conditioned (`repaint.py`, depth from
`perception/depth.py`), or through FLUX.1-Depth (`repaint_flux.py`) when
FLEXAM_FLUX_CKPT and FLEXAM_FLUX_AE name its files (FLEXAM_FLUX_T5 /
FLEXAM_FLUX_CLIP its text towers).

Geometry models (`perception/{moge,vggt,pi3}.py`), from shape-mapped
checkpoints: an image input without `--moge_npz` runs MoGe-2 from
FLEXAM_MOGE_CKPT on its first frame; camera control on a video without
recorded poses takes VGGT's poses (FLEXAM_VGGT_CKPT), then Pi3's
(FLEXAM_PI3_CKPT), each when its checkpoint maps, before the track solver;
`--camera_motion path --pose_file clip.mp4` runs Pi3 on the clip's `.npz`
frame dump (`conditioning/camera.py process_video_file`).

`main` returns the generated video, [1, 3, T, H, W] float in [0, 1], and
writes it to `<output_dir>/result.mp4` (`utils.media.save_video`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FlexAM demo (PyTorch port)")
    p.add_argument("--input_path", type=str, default=None)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--random_init", type=str, default=None,
                   choices=["tiny", "5b"],
                   help="random weights instead of a checkpoint (smoke)")
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8", "fp8"],
                   help="DiT weight quantization: int8 block GEMMs or fp8 "
                        "storage (both halve the resident weights); also "
                        "via FLEXAM_QUANT")
    p.add_argument("--prequant", type=str, default=None,
                   help="prequantized DiT .npz from tools/prequant_ckpt "
                        "(replaces the transformer weights of "
                        "--checkpoint_path or --random_init; no quantize "
                        "pass at start-up); serve bundles also carry the "
                        "VAE under vae/")
    p.add_argument("--num_inference_steps", type=int, default=40)
    p.add_argument("--repaint", type=str, default=None)
    p.add_argument("--camera_motion", type=str, default=None)
    p.add_argument("--pose_file", type=str, default=None)
    p.add_argument("--override_extrinsics", type=str, default="append",
                   choices=["override", "append"])
    p.add_argument("--object_motion", type=str, default=None)
    p.add_argument("--object_mask", type=str, default=None)
    p.add_argument("--tracking_method", type=str, default="DELTA",
                   choices=["DELTA", "moge", "flow"])
    p.add_argument("--sample_size", type=int, nargs=2, default=[512, 896])
    p.add_argument("--video_length", type=int, default=49)
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--generate_type", type=str, default="full_edit",
                   choices=["full_edit", "foreground_edit",
                            "background_edit"])
    p.add_argument("--density", type=int, default=10)
    p.add_argument("--dilation_pixels", type=int, default=200)
    p.add_argument("--tracks_npz", type=str, default=None)
    p.add_argument("--delta_ckpt", type=str, default=None,
                   help="densetrack3d.pth for DELTA tracking of a video "
                        "(else FLEXAM_DELTA_CKPT)")
    p.add_argument("--poses_npz", type=str, default=None,
                   help="recorded camera poses for --camera_motion: "
                        "extrinsics[T,3,4](+intrinsics), VGGT "
                        "pose_encoding[T,9], or Pi3 camera_poses[T,4,4]")
    p.add_argument("--moge_npz", type=str, default=None)
    p.add_argument("--synthetic_tracks", action="store_true")
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=1245644)
    p.add_argument("--scheduler", type=str, default=None,
                   choices=[None, "flow_match_euler", "flow_unipc",
                            "flow_dpm"])
    p.add_argument("--teacache_thresh", type=float, default=0.0)
    p.add_argument("--cfg_skip_ratio", type=float, default=0.0)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--platform", type=str, default=None,
                   help="cpu runs on the CPU; none or cuda on the card")
    p.add_argument("--host_rasterize", action="store_true",
                   help="rasterize the control videos on the host (the "
                        "reference's path; the default rasterizes on the "
                        "device)")
    p.add_argument("--save_artifacts", action="store_true",
                   help="write the tracking / cos / depth videos")
    return p


def _device(platform):
    if platform in (None, "", "cuda"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"--platform {platform!r}: the PyTorch port runs on "
                     "'cuda' (the default) or 'cpu'")


def _synthetic_grid_tracks(video_length, height, width, density):
    """Deterministic stand-in for DELTA: a static dense grid with a slow
    drift (the whole rasterize -> generate path without a tracker)."""
    ys = np.arange(0, height, density, dtype=np.float32) + density / 2
    xs = np.arange(0, width, density, dtype=np.float32) + density / 2
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    base = np.stack([gx.reshape(-1), gy.reshape(-1),
                     np.full(gx.size, 2.0, np.float32)], axis=1)
    t = np.arange(video_length, dtype=np.float32)[:, None, None]
    drift = np.concatenate([t * 0.5, t * 0.2, t * 0.0], axis=2)
    tracks = base[None] + drift
    vis = np.ones((video_length, base.shape[0]), bool)
    return tracks.astype(np.float32), vis


def _load_prequant(path, device):
    """A prequantized DiT `.npz` (tools/prequant_ckpt, either package's):
    returns (host tree in the port's layout, the quant mode its leaves
    imply, the bundle's VAE on `device` or None), so the pipeline's
    conversion passes it through and its narrow leaves cross as they are.
    Serve bundles carry the VAE under vae/, stored bf16 and cast to float32
    on the device."""
    import torch

    from flexam_tpu_torch.io.checkpoints import restore_pytree_nested
    from flexam_tpu_torch.io.convert import (from_jax_params, map_leaves,
                                             tree_leaves)
    from flexam_tpu_torch.ops.qlinear import is_quantized
    from flexam_tpu_torch.utils.fp8 import FP8

    tree = restore_pytree_nested(path)
    bvae = None
    if isinstance(tree, dict) and "dit" in tree and "vae" in tree:
        bvae = map_leaves(
            from_jax_params(tree["vae"], device),
            lambda k, t, b: t.float() if t.dtype == torch.bfloat16 else t)
        tree = tree["dit"]
    tree = from_jax_params(tree, "cpu")
    if is_quantized(tree):
        return tree, "int8", bvae
    if any(t.dtype == FP8 for t in tree_leaves(tree)):
        return tree, "fp8", bvae
    raise ValueError(
        f"{path} holds no quantized leaves — produce it with "
        "tools/prequant_ckpt, or load it via --checkpoint_path")


def _build_models(args):
    """The pipeline of `--checkpoint_path` or `--random_init`. Random weights
    are drawn on the device from fixed seeds: float32 for tiny, bf16 for 5b
    (the JAX CLI draws the 5B VAE and umT5 in float32; either way they are
    random values, and the pipeline computes in the DiT's dtype). A
    Namespace without the quant attributes (a serve-style caller) runs
    unquantized."""
    import torch

    from flexam_tpu_torch.config import WAN22_5B_FLEXAM, tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    quant = getattr(args, "quant", None)
    prequant = getattr(args, "prequant", None)
    device = _device(getattr(args, "platform", None))
    bundle_vae = None
    if prequant:
        dit, quant, bundle_vae = _load_prequant(prequant, device)

    if args.checkpoint_path:
        from flexam_tpu_torch.io.checkpoints import (load_dit_checkpoint,
                                                     load_t5_checkpoint,
                                                     load_vae_checkpoint)
        cfg = WAN22_5B_FLEXAM
        if not prequant:
            # float32 as JAX loads it, then the JAX CLI's bf16 cast, leaf
            # by leaf on the device; a quant mode quantizes the weights it
            # stores narrow from their float32 values as they load, as the
            # JAX CLI quantizes its float32 host tree
            mode = quant or os.environ.get("FLEXAM_QUANT", "")
            dit = load_dit_checkpoint(
                args.checkpoint_path, cfg.dit, dtype=torch.float32,
                device=device, matrix_dtype=torch.bfloat16,
                quant=mode if mode not in ("", "none") else None)
        vae = (bundle_vae if bundle_vae is not None else load_vae_checkpoint(
            os.path.join(args.checkpoint_path, "Wan2.2_VAE.pth"), cfg.vae,
            device=device))
        t5 = load_t5_checkpoint(
            os.path.join(args.checkpoint_path,
                         "models_t5_umt5-xxl-enc-bf16.pth"), cfg.t5,
            device=device)
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(
            os.path.join(args.checkpoint_path, "google/umt5-xxl"))
        models = FlexAMModels(cfg=cfg, dit_params=dit, vae_params=vae,
                              t5_params=t5, t5_from_checkpoint=True)
        return FlexAMGenerationPipeline(models, tokenizer=tokenizer,
                                        device=device, quant=quant,
                                        compute_dtype=torch.bfloat16)

    if args.random_init not in ("tiny", "5b"):
        raise SystemExit("pass --checkpoint_path or --random_init tiny|5b")
    tiny = args.random_init == "tiny"
    cfg = tiny_test_config() if tiny else WAN22_5B_FLEXAM
    dtype = torch.float32 if tiny else torch.bfloat16
    models = FlexAMModels(
        cfg=cfg,
        dit_params=(dit if prequant else init_dit_params(
            cfg.dit, seed=0, dtype=dtype, device=device)),
        vae_params=(bundle_vae if bundle_vae is not None else
                    init_vae_params(cfg.vae, seed=1, dtype=dtype,
                                    device=device)),
        t5_params=init_t5_params(cfg.t5, seed=2, dtype=dtype, device=device))
    return FlexAMGenerationPipeline(models, device=device, quant=quant,
                                    compute_dtype=dtype)


def _repaint_first_frame(args, pipe, input_video, h, w, device):
    """`--repaint true`: the first frame, [1, 3, 1, H, W], regenerated from
    its depth by FLUX.1-Depth (`repaint_flux.load_flux_repainter`) when
    FLEXAM_FLUX_CKPT and FLEXAM_FLUX_AE are set (the reference's backend,
    `pipelines.py:137-173`), else by the FlexAM model itself
    (`repaint.make_flexam_repaint_fn`)."""
    from flexam_tpu_torch.perception.depth import estimate_depth
    from flexam_tpu_torch.repaint import (FirstFrameRepainter,
                                          make_flexam_repaint_fn)
    if (os.environ.get("FLEXAM_FLUX_CKPT")
            and os.environ.get("FLEXAM_FLUX_AE")):
        from flexam_tpu_torch.repaint_flux import load_flux_repainter
        print("NOTE: --repaint true -> native FLUX.1-Depth port "
              "(FLEXAM_FLUX_CKPT)")
        repaint_fn = load_flux_repainter(device=device).as_repaint_fn(
            args.seed)
    else:
        if os.environ.get("FLEXAM_FLUX_CKPT"):
            print("WARNING: FLEXAM_FLUX_CKPT set without FLEXAM_FLUX_AE — "
                  "falling back to the native FlexAM repaint")
        print("NOTE: --repaint true -> native depth-conditioned single-frame "
              "generation (the reference uses external FLUX.1-Depth here; "
              "set FLEXAM_FLUX_CKPT/FLEXAM_FLUX_AE to run the native FLUX "
              "port instead)")
        repaint_fn = make_flexam_repaint_fn(pipe, seed=args.seed)
    rp = FirstFrameRepainter(
        h, w, args.output_dir,
        depth_fn=lambda img: estimate_depth(
            (np.asarray(img, np.float32) / 255.0)[None], device=device)[0],
        repaint_fn=repaint_fn)
    return rp.repaint(np.asarray(input_video)[0, :, 0], args.prompt,
                      num_inference_steps=args.num_inference_steps)


def _moge_geometry(path, input_video, device) -> dict:
    """MoGe's `infer` dict for the first frame of `input_video`, from the
    checkpoint at `path` (which must map: `load_moge` raises below its
    coverage bar unless FLEXAM_MOGE_BESTEFFORT=1). The model is dropped on
    return, before the pipeline is built."""
    from flexam_tpu_torch.perception.moge import load_moge
    return load_moge(path, device=device).infer(
        np.asarray(input_video)[0, :, 0])


def _model_poses(kind, input_video, width, height, device):
    """(extr [T, 3, 4], intr [T, 3, 3]) of the video from the VGGT or Pi3
    model of FLEXAM_VGGT_CKPT / FLEXAM_PI3_CKPT, or (None, None) when its
    checkpoint does not map (JAX's `load_ok` gate: random-weight poses are
    the identity). The model is dropped on return."""
    frames = np.asarray(input_video)[0].transpose(1, 0, 2, 3)  # [T,3,H,W]
    if kind == "vggt":
        from flexam_tpu_torch.perception.vggt import VGGT, vggt_video_poses
        model = VGGT.from_pretrained(device=device)
        if not model.load_ok:
            return None, None
        print("NOTE: camera poses from the native VGGT model")
        return vggt_video_poses(frames, model=model)
    from flexam_tpu_torch.perception.pi3 import Pi3, pi3_video_poses
    from flexam_tpu_torch.perception.poses import pi3_poses_to_extri_intri
    model = Pi3.from_pretrained(device=device)
    if not model.load_ok:
        return None, None
    print("NOTE: camera poses from the native Pi3 model")
    return pi3_poses_to_extri_intri(pi3_video_poses(frames, model=model),
                                    width, height)


def _load_mask_image(path, h, w):
    if path is None:
        raise SystemExit("--object_motion requires --object_mask")
    from flexam_tpu_torch.utils.media import load_mask_image
    return load_mask_image(path, (h, w)) > 127


def main(argv=None):
    from flexam_tpu_torch.conditioning import (CameraMotionGenerator,
                                               ObjectMotionGenerator)
    from flexam_tpu_torch.orchestrator import (FlexAMOrchestrator,
                                               convert_moge_to_delta_format)
    from flexam_tpu_torch.utils.masks import (generate_mask_bg_tracking,
                                              generate_mask_fg_tracking)
    from flexam_tpu_torch.utils.media import (get_image_latent,
                                              get_image_to_video_input,
                                              get_maskvideo_input,
                                              get_video_input, is_video_path,
                                              save_video)

    args = build_argparser().parse_args(argv)
    device = _device(args.platform)
    h, w = args.sample_size
    os.makedirs(args.output_dir, exist_ok=True)

    # ---- input ----
    is_video = is_video_path(args.input_path)
    if args.input_path:
        if is_video:
            input_video, _, _ = get_video_input(
                args.input_path, args.video_length, (h, w))
        else:
            frame = get_image_latent(args.input_path, (h, w))
            input_video = np.tile(frame, (1, 1, args.video_length, 1, 1))
            args.tracking_method = "moge"
    else:
        input_video = np.zeros((1, 3, args.video_length, h, w), np.float32)

    # ---- repaint (path input, or native depth-conditioned generation) ----
    repaint = None
    repaint_native = False
    if args.repaint and args.repaint.lower() != "true":
        repaint = get_image_latent(args.repaint, (h, w))
    elif args.repaint:
        # `--repaint true`: the reference runs FLUX.1-Depth here
        # (`pipelines.py:137-173`); natively the FlexAM model generates the
        # frame from its own depth conditioning (after the models load)
        repaint_native = True

    # ---- tracks ----
    cam = CameraMotionGenerator(args.camera_motion or "",
                                frame_num=args.video_length, H=h, W=w,
                                pose_file=args.pose_file, device=device)
    extr = intr = None
    if args.moge_npz or (args.tracking_method == "moge" and not is_video):
        if args.moge_npz:
            moge = dict(np.load(args.moge_npz))
        elif os.environ.get("FLEXAM_MOGE_CKPT"):
            # the MoGe model (perception/moge.py) on the loaded first
            # frame, like `demo.py:220-223`
            moge = _moge_geometry(os.environ["FLEXAM_MOGE_CKPT"],
                                  input_video, device)
        else:
            raise SystemExit(
                "image input needs MoGe geometry: pass --moge_npz (output "
                "fixture) or set FLEXAM_MOGE_CKPT for the MoGe model "
                "(flexam_tpu_torch.perception.moge)")
        points = np.asarray(moge["points"], np.float32)     # [H', W', 3]
        moge_mask = np.asarray(moge["mask"]).astype(bool)
        if "intrinsics" in moge:
            cam.set_intr(np.asarray(moge["intrinsics"], np.float32))
        pred = np.tile(points[None], (args.video_length, 1, 1, 1))
        if args.object_motion:
            mask_img = _load_mask_image(args.object_mask, h, w)
            pred = ObjectMotionGenerator().apply_motion(
                pred, mask_img, args.object_motion, 50,
                num_frames=args.video_length, tracking_method="moge")
        poses = (cam.get_default_motion() if args.camera_motion
                 else np.tile(np.eye(4, dtype=np.float32),
                              (args.video_length, 1, 1)))
        hh, ww = pred.shape[1:3]
        uvd = cam.w2s_moge(pred.reshape(args.video_length, hh * ww, 3), poses)
        tracks, vis = convert_moge_to_delta_format(
            uvd.reshape(args.video_length, hh, ww, 3), moge_mask, h, w)
        point_wise = 2      # the reference's point_wise on this path
    else:
        if args.tracking_method == "flow" and not args.tracks_npz:
            if not is_video:
                raise SystemExit("--tracking_method flow needs a video "
                                 "--input_path")
            from flexam_tpu_torch.perception.tracking import \
                track_video_flow
            print("NOTE: built-in optical-flow baseline tracker "
                  "(plug DELTA via --tracks_npz for learned tracking)")
            tracks, vis = track_video_flow(input_video,
                                           density=args.density,
                                           device=device)
        elif args.tracks_npz:
            data = np.load(args.tracks_npz)
            tracks = np.asarray(data["tracks"], np.float32)
            vis = np.asarray(data["visibility"]).astype(bool)
            extr = (np.asarray(data["extrinsics"], np.float32)
                    if "extrinsics" in data else None)
            intr = (np.asarray(data["intrinsics"], np.float32)
                    if "intrinsics" in data else None)
        elif args.synthetic_tracks:
            tracks, vis = _synthetic_grid_tracks(args.video_length, h, w,
                                                 args.density)
        elif args.tracking_method.upper() == "DELTA" and is_video:
            # the reference's flagship path (`pipelines.py:1362-1499`):
            # DenseTrack3D + depth backend; with no trained checkpoint the
            # flow tracker gives better tracks than random weights
            from flexam_tpu_torch.perception.tracking import \
                dispatch_tracking
            tracks, vis = dispatch_tracking(
                input_video, "delta", density=args.density,
                ckpt=args.delta_ckpt, device=device)
        else:
            raise SystemExit(
                "no tracks: pass --tracks_npz, --synthetic_tracks, a video "
                "--input_path (DELTA/flow tracking), or --moge_npz")
        if args.camera_motion:
            if (extr is None or intr is None) and args.poses_npz:
                from flexam_tpu_torch.perception import \
                    poses_npz_to_extri_intri
                extr, intr = poses_npz_to_extri_intri(args.poses_npz, w, h)
            # the reference's video camera path: VGGT's poses
            # (`demo.py:296-325`), then Pi3's (`pipelines.py:259-321`),
            # each when its checkpoint maps
            for kind in ("vggt", "pi3"):
                if (extr is None or intr is None) and os.environ.get(
                        f"FLEXAM_{kind.upper()}_CKPT"):
                    extr, intr = _model_poses(kind, input_video, w, h,
                                              device)
            if extr is None or intr is None:
                # no-checkpoint fallback: rigid per-frame poses solved from
                # the 3D tracks themselves (robust Kabsch)
                from flexam_tpu_torch.perception.pose_solver import \
                    solve_camera_poses
                print("NOTE: solving camera poses from tracks (no "
                      "--poses_npz; robust Kabsch, frame-0 world)")
                extr, intr = solve_camera_poses(tracks, vis,
                                                width=w, height=h)
            poses = cam.get_default_motion()
            world = cam.s2w_vggt(tracks, extr, intr)
            tracks = cam.w2s_vggt(
                world, extr, intr, poses,
                override_extrinsics=args.override_extrinsics == "override")
        if args.object_motion:
            mask_img = _load_mask_image(args.object_mask, h, w)
            tracks = ObjectMotionGenerator().apply_motion(
                tracks, mask_img, args.object_motion, 50,
                num_frames=args.video_length, tracking_method="DELTA")
        point_wise = 4

    # ---- pipeline ----
    pipe = _build_models(args)
    orch = FlexAMOrchestrator(
        pipe, output_dir=args.output_dir, fps=args.fps,
        save_tracking=args.save_artifacts or args.host_rasterize)
    run = dict(num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale, seed=args.seed,
               scheduler_type=args.scheduler,
               cfg_skip_ratio=args.cfg_skip_ratio,
               teacache_thresh=args.teacache_thresh)

    if repaint_native:
        repaint = _repaint_first_frame(args, pipe, input_video, h, w,
                                       device)

    # ---- inpaint video + mask per mode (`demo.py:361-395`) ----
    if args.generate_type == "full_edit":
        first = repaint[:, :, 0] if repaint is not None \
            else input_video[:, :, 0]
        full_ref = first[:, :, None]
        if not args.host_rasterize:
            # device path: only the first frame and the tracks go over
            if pipe.tokenizer is None:
                print("NOTE: no tokenizer (random init); "
                      "using hashed prompt ids")
            return orch.apply_tracks(
                tracks, vis, h, w, prompt=args.prompt,
                point_wise=point_wise, generate_type=args.generate_type,
                mask_path=args.mask_path, first_frame=full_ref,
                density=1.0 / args.density, **run)
        inpaint_video, inpaint_mask = get_image_to_video_input(
            (first[0].transpose(1, 2, 0) * 255).astype(np.uint8),
            args.video_length, (h, w))
    else:
        if repaint is None:
            raise SystemExit("repaint image must be provided for "
                             "foreground_edit/background_edit")
        mv = get_maskvideo_input(args.mask_path, args.video_length, (h, w))
        if args.generate_type == "foreground_edit":
            m = generate_mask_fg_tracking(mv,
                                          dilation_pixels=args.dilation_pixels,
                                          device=device)
        else:
            m = generate_mask_bg_tracking(mv)
        inpaint_mask = (m.astype(np.float32) * 255).transpose(1, 0, 2, 3)[None]
        inpaint_video = np.concatenate(
            [repaint[:, :, :1], input_video[:, :, 1:]], axis=2)
        full_ref = repaint
        if not args.host_rasterize:
            if pipe.tokenizer is None:
                print("NOTE: no tokenizer (random init); "
                      "using hashed prompt ids")
            return orch.apply_tracks(
                tracks, vis, h, w, prompt=args.prompt,
                point_wise=point_wise, generate_type=args.generate_type,
                mask_path=args.mask_path, video=inpaint_video,
                mask_video=inpaint_mask / 255.0, ref_image=full_ref,
                density=1.0 / args.density, **run)

    tracking, cos_videos, depth = orch.visualize_tracking(
        tracks, vis, h, w, point_wise=point_wise,
        generate_type=args.generate_type, mask_path=args.mask_path)

    # tokenizer-less random weights: the prompt as hashed ids
    if pipe.tokenizer is None:
        import torch
        print("NOTE: no tokenizer (random init); using hashed prompt ids")
        ids = (np.frombuffer(args.prompt.encode()[:64].ljust(64), np.uint8)
               .astype(np.int32)[: pipe.cfg.t5.text_length]
               % pipe.cfg.t5.vocab)[None]
        ids = np.pad(ids, ((0, 0), (0, pipe.cfg.t5.text_length - ids.shape[1])))
        mask = (ids > 0).astype(np.int32)
        ctx = pipe.encode_prompt_ids(ids, mask)
        context = torch.cat([ctx, ctx], dim=0)
        cond = pipe.prepare_conditioning(
            inpaint_video, inpaint_mask / 255.0, tracking, depth,
            [cos_videos[k] for k in sorted(cos_videos)], full_ref)
        out = pipe.generate_from_cond(cond, context,
                                      density=1.0 / args.density, **run)
        path = save_video(out, os.path.join(args.output_dir, "result.mp4"),
                          fps=args.fps)
        print(f"Final video generated at {path}")
        return out

    return orch.apply_tracking(
        tracking, cos_videos, depth, full_ref, inpaint_video, inpaint_mask,
        prompt=args.prompt, density=1.0 / args.density, **run)


if __name__ == "__main__":
    main()
