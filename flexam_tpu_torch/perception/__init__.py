"""Perception: the video-input stack and the parts the CLI runs without a
model.

  densetrack3d  DELTA-family dense 3D tracker (shape-mapped
                densetrack3d.pth loader)
  unidepth      UniDepth V2 metric depth (exact checkpoint name map)
  moge          MoGe-2 point map / mask / intrinsics (exact focal/shift
                camera-recovery solver; shape-mapped loader)
  vggt          VGGT multi-view poses, the reference's video camera path
                (shape-mapped loader)
  pi3           Pi3 permutation-equivariant multi-view poses (shape-mapped
                loader; `.npz` frame dumps as video input)
  zoedepth      ZoeDepth ZoeD_M12_N metric depth (exact checkpoint name map)
  depth_anything  Depth-Anything-V2-Large relative depth (name-mapped,
                coverage-gated loader)
  flow_device   the pyramidal Lucas-Kanade flow tracker on the device
  farneback     OpenCV's Farneback dense flow, in torch
  tracking      DELTA tracking, the Farneback tracker and the dispatch
  depth         the pluggable depth-backend registry
  pose_solver   camera extrinsics from 3D tracks (robust Kabsch)
  poses         VGGT/Pi3 pose-encoding post-processing + npz fixtures
  dwpose        DWPose: YOLOX + RTMPose ONNX graphs (onnx_graph) on the
                device, numpy pre- and post-processing
  pose_render   the OpenPose skeleton drawing of raw wholebody keypoints

DepthCrafter (`depthcrafter`, `depthcrafter_model`) runs behind the depth
registry's `depthcrafter` backend.

Checkpoint env vars: FLEXAM_DELTA_CKPT, FLEXAM_UNIDEPTH_CKPT,
FLEXAM_MOGE_CKPT, FLEXAM_VGGT_CKPT, FLEXAM_PI3_CKPT, FLEXAM_ZOE_CKPT,
FLEXAM_DAV2_CKPT, FLEXAM_DWPOSE_DET + FLEXAM_DWPOSE_POSE."""

from flexam_tpu_torch.perception.depth import (  # noqa: F401
    estimate_depth,
    register_depth_backend,
)
from flexam_tpu_torch.perception.pose_solver import (  # noqa: F401
    default_intrinsics,
    solve_camera_poses,
    unproject_tracks,
)
from flexam_tpu_torch.perception.poses import (  # noqa: F401
    pi3_poses_to_extri_intri,
    pose_encoding_to_extri_intri,
    poses_npz_to_extri_intri,
    quat_to_rotmat,
    rotmat_to_quat,
)
from flexam_tpu_torch.perception.tracking import (  # noqa: F401
    find_delta_checkpoint,
    track_video_delta,
    track_video_flow,
)


def __getattr__(name):
    # the models load on first use, as in JAX
    if name in ("DenseTrack3D", "DensePredictor3D", "load_densetrack3d",
                "DenseTrack3DConfig"):
        from flexam_tpu_torch.perception import densetrack3d as _m
        return getattr(_m, name)
    if name in ("UniDepthV2", "UniDepthV2Config", "load_unidepth",
                "predict_depth_video"):
        from flexam_tpu_torch.perception import unidepth as _m
        return getattr(_m, name)
    if name in ("MoGeModel", "MoGeConfig", "load_moge",
                "recover_focal_shift"):
        from flexam_tpu_torch.perception import moge as _m
        return getattr(_m, name)
    if name in ("Pi3", "Pi3Config", "load_pi3", "load_images_as_tensor",
                "pi3_video_poses"):
        from flexam_tpu_torch.perception import pi3 as _m
        return getattr(_m, name)
    if name in ("VGGT", "VGGTConfig", "load_vggt", "vggt_video_poses"):
        from flexam_tpu_torch.perception import vggt as _m
        return getattr(_m, name)
    if name in ("ZoeDepth", "ZoeDepthConfig", "load_zoedepth",
                "zoe_depth_video"):
        from flexam_tpu_torch.perception import zoedepth as _m
        return getattr(_m, name)
    if name in ("DWPoseDetector", "dwpose_video"):
        from flexam_tpu_torch.perception import dwpose as _m
        return getattr(_m, name)
    if name in ("render_pose_video", "draw_pose", "wholebody_to_openpose"):
        from flexam_tpu_torch.perception import pose_render as _m
        return getattr(_m, name)
    if name in ("track_video_flow_device", "dense_flow"):
        from flexam_tpu_torch.perception import flow_device as _m
        return getattr(_m, name)
    raise AttributeError(name)
