"""PyTorch + CUDA port of the FlexAM video-diffusion stack for one NVIDIA
H100, beside the JAX/Pallas package `flexam_tpu` it is held against.

The package imports torch and numpy only. Its Pallas kernels are
hand-written CUDA C++ under `csrc/`, built with one `nvcc` call at first
use (`ops/build.py`); on a CPU tensor every wrapper takes the kernel's plain
PyTorch version instead.
"""

from flexam_tpu_torch.config import (  # noqa: F401
    WAN22_5B_FLEXAM,
    DiTConfig,
    FlexAMConfig,
    SchedulerConfig,
    T5Config,
    VAEConfig,
    tiny_test_config,
)
