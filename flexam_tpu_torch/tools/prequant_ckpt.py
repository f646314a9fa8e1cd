"""Prequantize a FlexAM DiT checkpoint for fast serving cold starts.

    python -m flexam_tpu_torch.tools.prequant_ckpt --checkpoint <dir-or-file> \
        --mode int8 --out dit_int8.npz

Port of `flexam_tpu/tools/prequant_ckpt.py`. It reads the reference-layout
checkpoint (a safetensors directory or file, or a `.pth`), quantizes the
block linears on the host (the int8 per-output-channel scheme of
`ops/qlinear.py`, or the float8 storage of `utils/fp8.py`) and writes one
`.npz` in JAX's `save_pytree` format and JAX's stacked block layout, so a
file written by either package loads in the other. At deploy time:

    python -m flexam_tpu_torch.demo --prequant dit_int8.npz ...

The pipeline's conversion passes an already-quantized tree through, and
the narrow leaves cross to the card as they are.

It runs on the CPU and never touches the card. A checkpoint is quantized
while it loads, one leaf at a time from its float32 values, and the other
leaves are cast as they load (`_cast_wide_to_bf16`'s rule), so no float32
5B tree is ever held; the result is the same as JAX's quantize-then-cast
of its float32 tree.
"""

from __future__ import annotations

import argparse
import sys


def log(msg):
    print(f"[prequant] {msg}", file=sys.stderr, flush=True)


def prequantize(dit_params: dict, mode: str) -> dict:
    """Quantize a host DiT tree in place and return it."""
    if mode == "int8":
        from flexam_tpu_torch.ops.qlinear import convert_dit_to_int8
        return convert_dit_to_int8(dit_params)
    if mode == "fp8":
        from flexam_tpu_torch.utils.fp8 import convert_weights_to_fp8
        return convert_weights_to_fp8(dit_params)
    raise ValueError(f"unknown mode {mode!r} (int8 | fp8)")


def _cast_wide_to_bf16(tree):
    """Unquantized float32 matrices are stored (and later uploaded) as bf16,
    the deploy dtype; quantization scales stay float32
    (`io.convert.deploy_dtype`, the pipeline's `_put_quantized` rule)."""
    from flexam_tpu_torch.io.convert import deploy_dtype, map_leaves

    def cast(key, t, in_block):
        wide = deploy_dtype(t, key, in_block)
        return t if wide is None else t.to(wide)
    return map_leaves(tree, cast)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="DiT checkpoint: safetensors dir/file or .pth, "
                         "or 'random:tiny' (test skeleton, no file)")
    ap.add_argument("--mode", default="int8", choices=("int8", "fp8"))
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)

    import torch

    from flexam_tpu_torch.io.checkpoints import save_pytree
    from flexam_tpu_torch.io.convert import stack_blocks, tree_leaves

    if args.checkpoint == "random:tiny":
        from flexam_tpu_torch.config import tiny_test_config
        from flexam_tpu_torch.models.dit import init_dit_params
        dit = init_dit_params(tiny_test_config().dit, seed=0,
                              dtype=torch.float32, device="cpu")
        dit = _cast_wide_to_bf16(prequantize(dit, args.mode))
    else:
        from flexam_tpu_torch.config import WAN22_5B_FLEXAM
        from flexam_tpu_torch.io.checkpoints import load_dit_checkpoint
        dit = load_dit_checkpoint(args.checkpoint, WAN22_5B_FLEXAM.dit,
                                  dtype=torch.float32, device="cpu",
                                  matrix_dtype=torch.bfloat16,
                                  quant=args.mode)
    n_in = 4 * sum(t.numel() for t in tree_leaves(dit))
    n_out = sum(t.nbytes for t in tree_leaves(dit))
    save_pytree(args.out, stack_blocks(dit))
    log(f"{args.mode}: {n_in / 1e9:.2f} GB as float32 -> "
        f"{n_out / 1e9:.2f} GB quantized -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
