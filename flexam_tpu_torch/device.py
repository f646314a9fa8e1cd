"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA where there is none raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flexam_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is false here; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev
