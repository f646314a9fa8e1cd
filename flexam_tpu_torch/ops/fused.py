"""Fused elementwise kernels of the DiT hot path: B3 and B4.

Port of `flexam_tpu/ops/fused.py`. The CUDA kernels live in
`csrc/rmsnorm_rope.cu` (B3) and `csrc/ln_modulation.cu` (B4):

  * `rmsnorm_rope` — RMSNorm over the full hidden dim (all heads), cast,
    gamma in the compute dtype, then interleaved-pair RoPE in fp32; returns
    the attention layout [B, S, H, dh];
  * `ln_modulation` — affine-free LayerNorm + `ln*(1+scale)+shift`, with the
    TI2V binary-timestep select (mask given: [B, 2, D] shift/scale pairs) or
    per-batch terms (no mask: [B, D]).

Both kernels stream token rows held in registers as 16-byte vectors (bf16:
a warp a row; fp32, whose rows are twice the bytes: a CTA of 256 threads a
row); they take x 16-byte aligned with a width that is a multiple of 8 up
to `MAX_FEATURES` in both dtypes (B3: a head_dim that is a multiple of 8),
and B4 reads its terms through their strides. x is bf16 or fp32 (the DiT's
compute dtype; fp32 is `generate(compute_dtype=torch.float32)`), gamma
takes x's dtype, the RoPE tables and B4's terms stay fp32. A CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version, which
repeats the JAX math op for op (`core/layers.rms_norm` +
`core/rope.apply_rope`; `_ln_mod_unfused`), the casts no-ops in fp32.
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


# widest row the kernels hold in registers (csrc/common.cuh: bf16
# kMaxRowVectors 16-byte vectors a lane, 32 lanes, 8 bf16 a vector; fp32 8
# vectors a thread, 256 threads, 4 fp32 a vector)
MAX_FEATURES = 8192
DTYPES = (torch.bfloat16, torch.float32)


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous x [B, S, D], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes bf16 or fp32, got "
                        f"{x.dtype}")
    if x.shape[2] % 8 or x.shape[2] > MAX_FEATURES:
        raise ValueError(f"{name}: the kernel takes widths that are a "
                         f"multiple of 8 up to {MAX_FEATURES}, got "
                         f"{x.shape[2]}")
    _aligned(x, name)


def _entry(name: str, x: torch.Tensor):
    """The C entry point `name` for x's dtype (`name` + "_f32" for fp32)."""
    return getattr(build.library(),
                   name + ("_f32" if x.dtype == torch.float32 else ""))


def _aligned(t: torch.Tensor, name: str) -> torch.Tensor:
    """t, if its data starts on a 16-byte boundary (the kernels' vector
    loads need it); raise otherwise."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: a tensor's data is not 16-byte aligned "
                         f"(a view at an offset?)")
    return t


def _check_on(t: torch.Tensor, like: torch.Tensor, shape, name: str):
    if t.device != like.device:
        raise ValueError(f"{name}: all inputs must be on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _on(t: torch.Tensor, like: torch.Tensor, dtype, shape, name: str):
    """t as a contiguous `dtype` tensor of `shape` on like's device."""
    _check_on(t, like, shape, name)
    return t.to(dtype).contiguous()


def _terms(t: torch.Tensor, like: torch.Tensor, shape, name: str):
    """t as an fp32 tensor of `shape` whose last dim is contiguous (a
    strided view of the modulation tensor passes as it is), with its
    strides in elements: (t, batch stride, branch stride or 0)."""
    _check_on(t, like, shape, name)
    if t.dtype != torch.float32 or t.stride(-1) != 1:
        t = t.to(torch.float32).contiguous()
    return t, t.stride(0), t.stride(1) if t.dim() == 3 else 0


def rmsnorm_rope_args(x: torch.Tensor, gamma: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      num_heads: int) -> tuple:
    """The checked arguments of B3's kernel: (gamma, cos, sin) as the kernel
    reads them, and head_dim. Raises on what the kernel does not take."""
    name = "rmsnorm_rope"
    _check_x(x, name)
    d = x.shape[2]
    dh = d // num_heads
    if d % num_heads or dh % 8:
        raise ValueError(f"{name}: the kernel takes heads of a head_dim that "
                         f"is a multiple of 8; {d} features do not split so "
                         f"into {num_heads} heads")
    lr = cos.shape[0]
    return (_aligned(_on(gamma, x, x.dtype, (d,), name), name),
            _aligned(_on(cos, x, torch.float32, (lr, dh // 2), name), name),
            _aligned(_on(sin, x, torch.float32, (lr, dh // 2), name), name),
            dh)


def rmsnorm_rope(x: torch.Tensor, gamma: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, num_heads: int,
                 eps: float = 1e-6) -> torch.Tensor:
    """B3: fused `rms_norm(x, gamma)` + `apply_rope` over x [B, S, H*dh].
    cos/sin are the [L_rot, dh/2] half tables; returns [B, S, H, dh]."""
    if not x.is_cuda:
        return rmsnorm_rope_plain(x, gamma, cos, sin, num_heads, eps)
    build.refuse_autograd("rmsnorm_rope", x, gamma, cos, sin)
    g, c, sn, dh = rmsnorm_rope_args(x, gamma, cos, sin, num_heads)
    b, s, d = x.shape
    out = torch.empty_like(x)
    err = _entry("flexam_rmsnorm_rope", x)(
        x.data_ptr(), g.data_ptr(), c.data_ptr(), sn.data_ptr(),
        out.data_ptr(), b, s, d, dh, c.shape[0], float(eps),
        build.stream_handle(x))
    build.check(err, "rmsnorm_rope")
    launches["rmsnorm_rope"] += 1
    return out.view(b, s, num_heads, dh)


def ln_modulation_args(x: torch.Tensor, shift: torch.Tensor,
                       scale: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> tuple:
    """The checked arguments of B4's kernel: (shift, batch stride, branch
    stride, scale, batch stride, branch stride, mask). Raises on what the
    kernel does not take."""
    name = "ln_mod_binary" if mask is not None else "ln_mod_bcast"
    _check_x(x, name)
    b, s, d = x.shape
    terms = (b, 2, d) if mask is not None else (b, d)
    m = _on(mask, x, torch.float32, (b, s), name) if mask is not None \
        else None
    return (*_terms(shift, x, terms, name), *_terms(scale, x, terms, name),
            m)


def ln_modulation(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """B4: fused affine-free LayerNorm + `ln*(1+scale)+shift` over
    x [B, S, D]. Binary mode (mask [B, S] given): shift/scale [B, 2, D]
    pairs, row 0 where mask = 1, row 1 where mask = 0, the fp32 mix of the
    two elsewhere. Broadcast mode: shift/scale [B, D] (or [B, 1, D]). The
    terms may be strided views whose last dim is contiguous."""
    if mask is None and shift.dim() == 3:
        shift, scale = shift[:, 0], scale[:, 0]
    if not x.is_cuda:
        return ln_modulation_plain(x, shift, scale, mask, eps)
    name = "ln_mod_binary" if mask is not None else "ln_mod_bcast"
    build.refuse_autograd(name, x, shift, scale, mask)
    sh, sh_b, sh_r, sc, sc_b, sc_r, m = ln_modulation_args(x, shift, scale,
                                                           mask)
    b, s, d = x.shape
    out = torch.empty_like(x)
    err = _entry("flexam_ln_modulation", x)(
        x.data_ptr(), sh.data_ptr(), sc.data_ptr(),
        m.data_ptr() if m is not None else None, out.data_ptr(),
        b, s, d, sh_b, sh_r, sc_b, sc_r, float(eps), build.stream_handle(x))
    build.check(err, name)
    launches[name] += 1
    return out
