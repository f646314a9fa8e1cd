"""Host utilities of the CLI: media input/output (`media`), the
foreground/background edit masks (`masks`), timing (`timing`), float8
weight storage (`fp8`) and the LoRA merge (`lora`)."""

from flexam_tpu_torch.utils.fp8 import (  # noqa: F401
    cast_weights,
    convert_weights_to_fp8,
)
from flexam_tpu_torch.utils.lora import merge_lora, unmerge_lora  # noqa: F401
from flexam_tpu_torch.utils.masks import (  # noqa: F401
    generate_mask_bg_tracking,
    generate_mask_fg_tracking,
)
from flexam_tpu_torch.utils.media import (  # noqa: F401
    get_image_latent,
    get_image_to_video_input,
    get_maskvideo_input,
    get_video_input,
    save_video,
    save_videos_grid,
)
from flexam_tpu_torch.utils.timing import metrics, timer  # noqa: F401
