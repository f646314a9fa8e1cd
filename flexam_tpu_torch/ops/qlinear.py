"""INT8 dynamic-quantized linears for the DiT block GEMMs.

Port of `flexam_tpu/ops/qlinear.py`. The scheme is JAX's:
  * weights: static per-output-channel symmetric int8
    (`w_q = round(w / (amax_row / 127))`, the scale kept float32);
  * activations: dynamic per-token symmetric int8 (amax over the feature
    dim on every call);
  * the product accumulates in int32 and is dequantized with the two
    scales, then the bias is added, all in float32.

The JAX package computes the int8 product in XLA (`lax.dot_general` with
an int32 result), outside any Pallas kernel, so here it is a library GEMM:
`torch._int_mm` (cuBLASLt's int8 GEMM on CUDA, an exact integer product on
the CPU). The quantize and dequantize around it are plain torch ops. On
CUDA `qlinear` launches `_int_mm` or raises: it pads fewer than 17 rows
with zero rows (the same function) and refuses widths that are not a
multiple of 8, naming the reason; it never falls back to a float matmul.

Every division here is tensor by tensor. CUDA divides a tensor by a Python
scalar as a multiply by the reciprocal, which can land one ulp off the
quotient and move a value on an int8 rounding tie; weight quantization must
equal numpy's (`_quantize_weight_host`) bit for bit on every device, since
prequantized files from either package are served by both.

Block layout: the port keeps the DiT blocks as a list of per-block dicts,
so a block's `w_scale` is JAX's `w_scale[l]` of its stacked [L, out] scale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# quantize the big block GEMMs only: norms, biases, AdaLN modulation
# tables, embeddings and the output head stay high-precision
QUANT_KEYS = ("self_attn", "cross_attn", "ffn")
LINEAR_NAMES = ("q", "k", "v", "o", "fc1", "fc2")

# cuBLASLt's int8 GEMM (`torch._int_mm` on CUDA) takes more than 16 rows
# and inner / output widths that are multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b as a true tensor-by-tensor division on every device."""
    return a / torch.full_like(a, b)


def _quantize_weight(w: torch.Tensor):
    """Per-output-channel int8 of a [..., out, in] weight on its device:
    the float32 cast, amax, round half to even, int8. Equal to
    `_quantize_weight_host` bit for bit."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(_div(amax, 127.0), 1e-12)
    return torch.round(wf / scale).to(torch.int8), scale[..., 0]


def _quantize_weight_host(w):
    """Numpy twin of `_quantize_weight` (the JAX function of the same name):
    the same float32 math and round-half-to-even, for host trees."""
    wf = np.asarray(w, np.float32)
    amax = np.max(np.abs(wf), axis=-1, keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12)
    return np.round(wf / scale).astype(np.int8), scale[..., 0]


def quantize_linear_params(p: dict) -> dict:
    """{"weight": [..., out, in]} -> {"weight_q", "w_scale", "bias"?}.

    A host weight (a CPU tensor) quantizes with numpy and stays on the
    host; a device weight quantizes on its device. The bias is carried
    over untouched."""
    w = p["weight"]
    if w.device.type == "cpu":
        w_q, w_scale = (torch.from_numpy(t) for t in
                        _quantize_weight_host(w.float().numpy()))
    else:
        w_q, w_scale = _quantize_weight(w)
    out = {"weight_q": w_q, "w_scale": w_scale}         # [..., out]
    if p.get("bias") is not None:
        out["bias"] = p["bias"]
    return out


def int_mm(q: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """int32 [M, out] = int8 q [M, in] @ int8 weight_q [out, in]^T.

    `weight_q.t()` of a contiguous [out, in] is the column-major operand of
    cuBLASLt's int8 GEMM, so no operand is copied. On CUDA, fewer than 17
    rows are padded with zero rows; widths that are not a multiple of 8
    raise."""
    m, k = q.shape
    n = weight_q.shape[0]
    if q.is_cuda:
        if k % _INT_MM_ALIGN or n % _INT_MM_ALIGN:
            raise ValueError(
                f"qlinear: torch._int_mm on CUDA needs the input width ({k}) "
                f"and the output width ({n}) to be multiples of "
                f"{_INT_MM_ALIGN}")
        if m < _INT_MM_MIN_ROWS:
            pad = q.new_zeros((_INT_MM_MIN_ROWS - m, k))
            return torch._int_mm(torch.cat([q, pad]), weight_q.t())[:m]
    return torch._int_mm(q, weight_q.t())


def qlinear_partial(x: torch.Tensor, p: dict,
                    amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W_q^T * (s_x * s_w) in float32, no bias: the per-token scale s_x
    from `amax` [tokens, 1] when given (a row-split linear passes the amax
    over the whole input width, of which x holds a slice), else from x."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = _div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    acc = int_mm(q, p["weight_q"])
    return (acc.float() * s_x * p["w_scale"].float()).reshape(*lead, -1)


def qlinear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """y = x @ W_q^T * (s_x * s_w) + b: dynamic per-token activation
    quantization, int32 accumulation. Takes the place of
    `core.layers.linear` when the params hold {"weight_q", "w_scale"}."""
    y = qlinear_partial(x, p)
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def _quantize_block_tree(blocks) -> None:
    """Quantize the blocks' linears in place, each source freed before the
    next quantizes."""
    for bp in blocks:
        for key in QUANT_KEYS:
            mod = bp.get(key, {})
            for name in LINEAR_NAMES:
                lin = mod.get(name)
                if (isinstance(lin, dict) and "weight" in lin
                        and lin["weight"].dim() >= 2):
                    mod[name] = quantize_linear_params(lin)


def convert_dit_to_int8(params: dict) -> dict:
    """Quantize the DiT block linears (self / cross attention q, k, v, o and
    ffn fc1 / fc2) to int8; everything else (embeddings, head, norms,
    modulation, cnn / ref convs) is untouched. The block list is changed
    IN PLACE (a bf16 5B never sits beside its int8 copy) and the same dict
    is returned; an already-quantized tree passes through. Apply after any
    LoRA merge: `utils.lora` needs float weights."""
    if "blocks" in params:
        _quantize_block_tree(params["blocks"])
    return params


def is_quantized(params) -> bool:
    """True if any sub-dict holds an int8-quantized linear."""
    if isinstance(params, dict):
        if "weight_q" in params:
            return True
        return any(is_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(is_quantized(v) for v in params)
    return False
