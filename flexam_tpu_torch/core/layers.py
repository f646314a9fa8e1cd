"""Numerics substrate: norms, activations, embeddings, linear.

Port of `flexam_tpu/core/layers.py`, with the same accumulate and cast
points: statistics in fp32, the normalized value cast back to the input
dtype before any learned scale. Parameters are plain dicts of tensors in
torch layout (Linear weight [out, in]); a linear holding {"weight_q",
"w_scale"} takes the int8 path of `ops/qlinear.py`, as in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with learned scale (fp32 accumulation)."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; affine only if weight/bias given."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation, computed in the input dtype with
    constants rounded to it (as the JAX version's `x.dtype.type(...)`)."""
    c = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + k * x * x * x)))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-first input [B, C, *spatial]: statistics over
    each group's channels and all spatial positions, in fp32."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, c // num_groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(2, 3), keepdim=True)
    xg = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (xg * weight.float().reshape(shape)
            + bias.float().reshape(shape)).to(x.dtype)


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] layout (cos half first), fp32.

    The fp64 frequencies are split into hi + lo fp32 terms so the angle
    keeps near-fp32-ulp accuracy at large positions (as in the JAX port)."""
    assert dim % 2 == 0
    pos = position.float()[..., None]
    hi, lo = _sinusoid_freqs(dim // 2, pos.device)
    sinusoid = pos * hi + pos * lo
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)


@functools.lru_cache(maxsize=None)
def _sinusoid_freqs(half: int, device: torch.device):
    """The hi / lo fp32 terms of 10000^(-i / half), on `device` once (no
    host copy a call, so a step can be captured in a CUDA graph)."""
    freqs64 = np.power(10000.0, -np.arange(half, dtype=np.float64) / half)
    f_hi = freqs64.astype(np.float32)
    f_lo = (freqs64 - f_hi.astype(np.float64)).astype(np.float32)
    return (torch.from_numpy(f_hi).to(device),
            torch.from_numpy(f_lo).to(device))


def linear(x: torch.Tensor, params: dict) -> torch.Tensor:
    """y = x @ W^T + b with torch Linear weight layout W: [out, in].

    Params holding {"weight_q", "w_scale"} take the int8 dynamic-quantized
    path (`ops/qlinear.py`, opt-in through `convert_dit_to_int8`); a stored
    float8 weight is cast to x's dtype like any other."""
    if "weight_q" in params:
        from flexam_tpu_torch.ops.qlinear import qlinear
        return qlinear(x, params)
    y = torch.matmul(x, params["weight"].to(x.dtype).t())
    if params.get("bias") is not None:
        y = y + params["bias"].to(x.dtype)
    return y


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32, device="cpu", bias: bool = True,
                scale: Optional[float] = None) -> dict:
    """Xavier-uniform weight (normal * `scale` when given) and a zero bias
    unless `bias` is false, as the JAX `linear_init`."""
    if scale is None:
        limit = math.sqrt(6.0 / (in_dim + out_dim))
        w = torch.empty((out_dim, in_dim), dtype=dtype, device=device)
        w.uniform_(-limit, limit, generator=gen)
    else:
        w = (torch.randn((out_dim, in_dim), generator=gen, device=device)
             * scale).to(dtype)
    p = {"weight": w}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


class ParamDraw:
    """Random parameters for an init, drawn on `device` from a
    `torch.Generator` seeded with `seed`: `normal(shape, std)` (float32
    normal times std, cast to `dtype`, as JAX's inits draw), `full(shape,
    value)`. With `seed` None every leaf is zero (the zero tree JAX's
    loaders fill); on the "meta" device nothing is stored (the shapes
    of a tree)."""

    def __init__(self, seed, dtype=torch.float32, device="cpu"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = (None if seed is None or self.device.type == "meta" else
                    torch.Generator(device=self.device).manual_seed(seed))

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.gen is None:
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * std).to(self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        if self.gen is None:
            value = 0.0
        return torch.full(shape, value, dtype=self.dtype, device=self.device)
