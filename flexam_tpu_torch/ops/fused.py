"""Fused elementwise kernels of the DiT hot path: B3 and B4.

Port of `flexam_tpu/ops/fused.py`. The CUDA kernels live in
`csrc/rmsnorm_rope.cu` (B3) and `csrc/ln_modulation.cu` (B4):

  * `rmsnorm_rope` — RMSNorm over the full hidden dim (all heads), cast,
    gamma in the compute dtype, then interleaved-pair RoPE in fp32; returns
    the attention layout [B, S, H, dh];
  * `ln_modulation` — affine-free LayerNorm + `ln*(1+scale)+shift`, with the
    TI2V binary-timestep select (mask given: [B, 2, D] shift/scale pairs) or
    per-batch terms (no mask: [B, D]).

A CUDA tensor (bf16, the DiT's compute dtype) launches the kernel or
raises; a CPU tensor takes the plain version, which repeats the JAX math op
for op (`core/layers.rms_norm` + `core/rope.apply_rope`; `_ln_mod_unfused`).
"""

from __future__ import annotations

from typing import Optional

import torch

from flexam_tpu_torch.core.layers import layer_norm, rms_norm
from flexam_tpu_torch.core.rope import apply_rope
from flexam_tpu_torch.ops import build

# kernel launches on CUDA tensors, by kernel
launches = {"rmsnorm_rope": 0, "ln_mod_binary": 0, "ln_mod_bcast": 0}


def rmsnorm_rope_plain(x: torch.Tensor, gamma: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, num_heads: int,
                       eps: float = 1e-6) -> torch.Tensor:
    b, s, d = x.shape
    y = rms_norm(x, gamma, eps).reshape(b, s, num_heads, d // num_heads)
    return apply_rope(y, cos, sin)


def ln_modulation_plain(x: torch.Tensor, shift: torch.Tensor,
                        scale: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    ln = layer_norm(x, eps=eps)
    if mask is not None:
        m = mask.float()[:, :, None]
        shf, scf = shift.float(), scale.float()
        sh = m * shf[:, 0:1] + (1.0 - m) * shf[:, 1:2]
        sc = m * scf[:, 0:1] + (1.0 - m) * scf[:, 1:2]
        return (ln * (1.0 + sc.to(dtype)) + sh.to(dtype)).to(dtype)
    return (ln * (1.0 + scale.to(dtype)[:, None])
            + shift.to(dtype)[:, None]).to(dtype)


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous x [B, S, D], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16, got {x.dtype}")


def _on(t: torch.Tensor, like: torch.Tensor, dtype, shape, name: str):
    """t as a contiguous `dtype` tensor of `shape` on like's device."""
    if t.device != like.device:
        raise ValueError(f"{name}: all inputs must be on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(dtype).contiguous()


def rmsnorm_rope(x: torch.Tensor, gamma: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, num_heads: int,
                 eps: float = 1e-6) -> torch.Tensor:
    """B3: fused `rms_norm(x, gamma)` + `apply_rope` over x [B, S, H*dh].
    cos/sin are the [L_rot, dh/2] half tables; returns [B, S, H, dh]."""
    if not x.is_cuda:
        return rmsnorm_rope_plain(x, gamma, cos, sin, num_heads, eps)
    name = "rmsnorm_rope"
    _check_x(x, name)
    b, s, d = x.shape
    dh = d // num_heads
    if d % num_heads or dh % 2:
        raise ValueError(f"{name}: {d} features do not split into "
                         f"{num_heads} heads of an even head_dim")
    g = _on(gamma, x, x.dtype, (d,), name)
    lr = cos.shape[0]
    c = _on(cos, x, torch.float32, (lr, dh // 2), name)
    sn = _on(sin, x, torch.float32, (lr, dh // 2), name)
    out = torch.empty_like(x)
    err = build.library().flexam_rmsnorm_rope(
        x.data_ptr(), g.data_ptr(), c.data_ptr(), sn.data_ptr(),
        out.data_ptr(), b * s, s, d, dh, lr, float(eps),
        build.stream_handle(x))
    build.check(err, name)
    launches[name] += 1
    return out.view(b, s, num_heads, dh)


def ln_modulation(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """B4: fused affine-free LayerNorm + `ln*(1+scale)+shift` over
    x [B, S, D]. Binary mode (mask [B, S] given): shift/scale [B, 2, D]
    pairs, row 0 where mask = 1, row 1 where mask = 0. Broadcast mode:
    shift/scale [B, D] (or [B, 1, D])."""
    if mask is None and shift.dim() == 3:
        shift, scale = shift[:, 0], scale[:, 0]
    if not x.is_cuda:
        return ln_modulation_plain(x, shift, scale, mask, eps)
    name = "ln_mod_binary" if mask is not None else "ln_mod_bcast"
    _check_x(x, name)
    b, s, d = x.shape
    terms = (b, 2, d) if mask is not None else (b, d)
    sh = _on(shift, x, torch.float32, terms, name)
    sc = _on(scale, x, torch.float32, terms, name)
    m = _on(mask, x, torch.float32, (b, s), name) if mask is not None \
        else None
    out = torch.empty_like(x)
    err = build.library().flexam_ln_modulation(
        x.data_ptr(), sh.data_ptr(), sc.data_ptr(),
        m.data_ptr() if m is not None else None, out.data_ptr(),
        b * s, s, d, float(eps), build.stream_handle(x))
    build.check(err, name)
    launches[name] += 1
    return out
