"""PyTorch + CUDA port of the FlexAM video-diffusion stack for one NVIDIA
H100, beside the JAX/Pallas package `flexam_tpu` it is held against.

The package imports torch and numpy only. Its Pallas kernels are
hand-written CUDA C++ under `csrc/`, built with one `nvcc` call at first
use (`ops/build.py`); on a CPU tensor every wrapper takes the kernel's plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from flexam_tpu_torch.config import (  # noqa: F401
    WAN22_5B_FLEXAM,
    DiTConfig,
    FlexAMConfig,
    SchedulerConfig,
    T5Config,
    VAEConfig,
    tiny_test_config,
)


def __getattr__(name):
    """The lazy top-level API, as JAX's (keeps `import flexam_tpu_torch`
    light)."""
    if name in ("FlexAMGenerationPipeline", "FlexAMModels"):
        from flexam_tpu_torch import pipeline
        return getattr(pipeline, name)
    if name == "FlexAMOrchestrator":
        from flexam_tpu_torch.orchestrator import FlexAMOrchestrator
        return FlexAMOrchestrator
    if name == "FirstFrameRepainter":
        from flexam_tpu_torch.repaint import FirstFrameRepainter
        return FirstFrameRepainter
    raise AttributeError(name)
