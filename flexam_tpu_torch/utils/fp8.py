"""FP8 weight storage.

Port of `flexam_tpu/utils/fp8.py`: eligible weights are stored as
`torch.float8_e4m3fn` and cast to the compute dtype where they are used.
Every consumer of a weight of two or more dims in `models/dit.py` casts it
(`.to(x.dtype)` or `.float()`) before use, as JAX's `linear` does with
`.astype(x.dtype)`, so an fp8-stored tree runs the forward unchanged.

The conversion is a single rounding from the leaf's own dtype: a float32
tree converts from float32 (the checkpoint and prequantize paths, as JAX
converts its float32 host tree), a bf16 tree from bf16 (JAX's device
trees). Converting float32 through bf16 first would round twice and give
other bytes than JAX's.
"""

from __future__ import annotations

from typing import Sequence

import torch

# the reference excludes the AdaLN modulation tables; norms and biases stay
# high-precision too (tiny, precision-critical)
DEFAULT_EXCLUDE = ("modulation", "norm", "bias", "latents_")

FP8 = torch.float8_e4m3fn


def _map_with_path(fn, tree):
    """Apply fn(path, leaf) to the leaves, replacing dict and list entries
    in place as they are visited, so that each converted leaf's source is
    freed before the next one converts. Paths are '/'-joined keys and list
    indices ("blocks/0/ffn/fc1/weight")."""
    def visit(path, node):
        if isinstance(node, dict):
            for k in node:
                node[k] = visit(f"{path}/{k}" if path else str(k), node[k])
            return node
        if isinstance(node, list):
            for i, v in enumerate(node):
                node[i] = visit(f"{path}/{i}", v)
            return node
        if isinstance(node, tuple):
            return tuple(visit(f"{path}/{i}", v) for i, v in enumerate(node))
        return fn(path, node)
    return visit("", tree)


def convert_weights_to_fp8(params, exclude: Sequence[str] = DEFAULT_EXCLUDE):
    """Store floating weights of two or more dims outside the exclusions as
    float8_e4m3fn. The tree is changed IN PLACE and returned. (In JAX's
    stacked layout a per-block leaf has one more dim; the only per-block
    leaves of one dim are norms and biases, excluded by name, so both
    layouts convert the same leaves.)"""
    def conv(path, t):
        if (t.is_floating_point() and t.dim() >= 2
                and not any(p in path for p in exclude)):
            return t.to(FP8)
        return t
    return _map_with_path(conv, params)


def cast_weights(params, dtype=torch.bfloat16):
    """The per-forward cast of an fp8-stored tree: a new tree with every
    float8 leaf as `dtype`; the input tree is not changed."""
    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        if torch.is_tensor(node) and node.dtype == FP8:
            return node.to(dtype)
        return node
    return visit(params)
