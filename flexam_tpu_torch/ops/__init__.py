"""The port's kernels: B1/B2 in `flash_attention`, B3/B4 in `fused`."""

from flexam_tpu_torch.ops import flash_attention, fused


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name (plain-version calls on CPU
    tensors are not launches and are not counted)."""
    return {**flash_attention.launches, **fused.launches}


def reset_launch_counts() -> None:
    for counts in (flash_attention.launches, fused.launches):
        for k in counts:
            counts[k] = 0
