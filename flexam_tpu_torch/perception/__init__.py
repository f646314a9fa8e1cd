"""Perception: the parts the CLI runs without a model. Camera poses solved
from 3D tracks (`pose_solver`) and the post-processing of recorded pose
fixtures (`poses`). The perception models themselves (DELTA, MoGe, VGGT,
Pi3, depth) are not ported yet."""

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
