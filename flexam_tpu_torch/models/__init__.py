from flexam_tpu_torch.models.dit import (  # noqa: F401
    dit_forward,
    dit_forward_teacache,
    get_teacache_coefficients,
    init_dit_params,
    init_teacache_state,
    make_rope_tables_for,
)
from flexam_tpu_torch.models.t5 import init_t5_params, t5_encode  # noqa: F401
from flexam_tpu_torch.models.vae import (  # noqa: F401
    init_vae_params,
    vae_decode,
    vae_encode,
    vae_encode_mode,
)
from flexam_tpu_torch.models.vae_stream import (  # noqa: F401
    vae_decode_streamed,
    vae_encode_streamed,
)
