"""The port's kernels: B1/B2 in `flash_attention`, B3/B4 in `fused`, B5 in
`sparse_attention`, B6 in `int8_attention`; the int8 linears (a cuBLASLt
GEMM, not a kernel of the port) in `qlinear`.

As in the JAX package, `flash_attention` and `int8_flash_attention` name
the functions; the launch counters are read from the modules first."""

from flexam_tpu_torch.ops import (flash_attention, fused, int8_attention,
                                  sparse_attention)

_COUNTERS = (flash_attention.launches, fused.launches,
             sparse_attention.launches, int8_attention.launches)

from flexam_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402,F401,F811
from flexam_tpu_torch.ops.int8_attention import (  # noqa: E402,F401
    int8_attention as int8_flash_attention)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name (plain-version calls on CPU
    tensors are not launches and are not counted)."""
    return {k: n for counts in _COUNTERS for k, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0
