from flexam_tpu_torch.core.layers import (  # noqa: F401
    gelu_tanh,
    group_norm,
    layer_norm,
    linear,
    linear_init,
    rms_norm,
    silu,
    sinusoidal_embedding_1d,
)
from flexam_tpu_torch.core.rope import (  # noqa: F401
    apply_rope,
    build_video_rope,
    riflex_rope_angles,
    rope_angles,
)
