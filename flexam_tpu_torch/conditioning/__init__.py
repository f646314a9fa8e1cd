"""Conditioning from tracks: camera motion, object motion, track colours
and the cosine encoding (numpy), the numpy rasterizer and the device
rasterizer (torch). The port's own copy of `flexam_tpu/conditioning/`."""

from flexam_tpu_torch.conditioning.camera import (  # noqa: F401
    Camera,
    CameraMotionGenerator,
    get_relative_pose,
    ray_condition,
)
from flexam_tpu_torch.conditioning.object_motion import (  # noqa: F401
    ObjectMotionGenerator,
)
from flexam_tpu_torch.conditioning.tracks import (  # noqa: F401
    cosine_positional_encoding,
    tracking_colors,
)
from flexam_tpu_torch.conditioning.rasterize import (  # noqa: F401
    rasterize_cos_videos,
    rasterize_depth_video,
    rasterize_tracking_video,
)
