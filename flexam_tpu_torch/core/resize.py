"""Image resampling with the JAX package's semantics: separable resizing
as `jax.image.resize` computes it, the perception modules' clamped
bilinear gather, and `jnp.pad(mode="edge")`.

The perception modules of the JAX package resize with `jax.image.resize`,
whose "bilinear" is a triangle kernel that is WIDENED when it shrinks an
axis (antialiasing, on by default) and whose "bicubic" is Keys' cubic with
a = -0.5. Neither is what `torch.nn.functional.interpolate` computes
(its bicubic takes a = -0.75, and its antialiased weights are not promised
to match), so the port builds the same weight matrices and contracts each
resized axis with its matrix.

For an axis of `n_in` samples resized to `n_out` (scale s = n_out / n_in),
output sample j sits at input coordinate (j + 0.5) / s - 0.5; input sample
i weighs kernel(|that - i| / max(1/s, 1)) with antialiasing (kernel(|..|)
without), the weights of each output sample are normalised to sum to one,
and an output sample whose coordinate lies outside [-0.5, n_in - 0.5] gets
no weight. The weights are computed in float32 (on the host: they depend
only on the sizes), as JAX computes them, and cast to the input's dtype
before the contraction. The pipeline's trilinear resize uses the same
matrices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - x)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    f = np.float32
    x = np.abs(x)
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


_KERNELS = {"bilinear": _triangle, "linear": _triangle,
            "trilinear": _triangle, "triangle": _triangle,
            "bicubic": _keys_cubic, "cubic": _keys_cubic}


def weight_matrix(n_in: int, n_out: int, method: str = "bilinear",
                  antialias: bool = True) -> np.ndarray:
    """The [n_in, n_out] float32 matrix that resizes one axis."""
    kernel = _KERNELS[method]
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = max(inv, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kscale
    w = kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize(x, shape, method, antialias)`: every axis whose
    size changes is resized by its weight matrix; the others pass."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match the input's "
                         f"{x.dim()} dims")
    if not x.is_floating_point():
        x = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(weight_matrix(n_in, n_out, method,
                                           antialias)).to(x.device, x.dtype)
        x = torch.movedim(torch.matmul(torch.movedim(x, d, -1), w), -1, d)
    return x


def edge_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """`jnp.pad(mode="edge")` by r on both sides of one axis."""
    n = x.shape[dim]
    size = (*x.shape[:dim], r, *x.shape[dim + 1:])
    return torch.cat([x.narrow(dim, 0, 1).expand(size), x,
                      x.narrow(dim, n - 1, 1).expand(size)], dim=dim)


def bilinear_gather(field: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """field [B, H, W, C] sampled at (x, y) [B, *S] -> [B, *S, C], with
    integer coordinates at sample centres. Coordinates are clamped to the
    field and the corner cell owns fx in [0, 1], so a sample at w - 1
    returns the last column exactly (the JAX perception modules'
    `bilinear_sample` / `_bilinear`)."""
    b, h, w, c = field.shape
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = torch.floor(x).clamp(0, w - 2)
    y0 = torch.floor(y).clamp(0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    flat = field.reshape(b, h * w, c)
    sample = x.shape[1:]

    def g(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, *sample, c)

    return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x0 + 1) * fx * (1 - fy)
            + g(y0 + 1, x0) * (1 - fx) * fy + g(y0 + 1, x0 + 1) * fx * fy)
