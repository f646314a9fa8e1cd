"""Element-wise closeness of a bf16 kernel output to its plain version.

Used by `chip_smoke.py` and `tests/test_torch_cuda.py` to hold each CUDA
kernel to its plain PyTorch version on the card. Each element is held to its
own size, not to the largest element of the tensor:

    |got - ref| <= ulps * ulp_bf16(mag) + floor * mean(|ref|)

`mag` is the size of the value the kernel rounds last (|ref| unless the
caller gives more, e.g. the terms of a sum that may cancel); `floor` covers
elements near zero whose error comes from a long sum, not from their own
rounding. The bound of each kernel, with its reason, is the check_* function
of that kernel below.
"""

from __future__ import annotations

from typing import Optional

import torch


def ulp_bf16(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t|, fp32 (2^-133 at and below the
    smallest normal)."""
    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       (e - 8).to(torch.int32))


def check_close(got: torch.Tensor, ref: torch.Tensor, name: str, *,
                ulps: float, floor: float = 0.0,
                mag: Optional[torch.Tensor] = None) -> dict:
    """Raise AssertionError unless every element of `got` is finite and
    within its bound (module docstring) of `ref`; return the error figures."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(r.shape)}")
    err = (g - r).abs()
    mean_ref = r.abs().mean().item()
    allowed = ulps * ulp_bf16(r.abs() if mag is None else mag) \
        + floor * mean_ref
    ratio = err / allowed
    worst = int(ratio.argmax().item())
    out = {"max_abs_err": err.max().item(),
           "max_err_over_bound": ratio.view(-1)[worst].item(),
           "bound": f"{ulps} bf16 ulps of {'|ref|' if mag is None else 'mag'}"
                    + (f" + {floor} x mean|ref|" if floor else ""),
           "mean_abs_ref": mean_ref, "max_abs_ref": r.abs().max().item()}
    out["max_rel_err"] = out["max_abs_err"] / (out["max_abs_ref"] or 1.0)
    if not bool(g.isfinite().all()) or out["max_err_over_bound"] > 1.0:
        raise AssertionError(
            f"{name}: error {err.view(-1)[worst].item()} at flat index "
            f"{worst} (ref {r.view(-1)[worst].item()}, got "
            f"{g.view(-1)[worst].item()}) exceeds its bound "
            f"{allowed.view(-1)[worst].item()} ({out['bound']}); "
            f"finite {bool(g.isfinite().all())}; {out}")
    return out


def pair_norm(t: torch.Tensor) -> torch.Tensor:
    """|(t[2j], t[2j+1])| on both elements of each interleaved pair of the
    last dim: the size a RoPE rotation keeps."""
    p = t.float().unflatten(-1, (-1, 2))
    return p.norm(dim=-1, keepdim=True).expand_as(p).flatten(-2)


def check_attention(got, ref, name: str) -> dict:
    """B1/B2 against `attention_plain`: 2 bf16 ulps of |ref| (each side
    rounds its fp32 output to bf16 once) plus 5e-2 of mean |ref|. The floor
    covers the sum over keys: both sides round each probability to bf16, at
    different points (the kernel before normalising, the plain version
    after), so each term of P.V carries an independent relative error of
    about 2^-9, whose sum is a few thousandths of the row's size."""
    return check_close(got, ref, name, ulps=2, floor=5e-2)


def check_sparse_attention(got, ref, name: str) -> dict:
    """B5 against `masked_dense_attention`: B1's bound and reason. Over the
    keys a query block sees, the kernel runs B1's online softmax and the
    plain version B1's plain softmax (masked keys get -1e30 and exp2 to 0
    in both), so they differ exactly where B1 and its plain version do."""
    return check_close(got, ref, name, ulps=2, floor=5e-2)


def check_int8_attention(got, ref, name: str) -> dict:
    """B6 against `int8_attention_plain`: B1's bound. Both take the same
    int8 values and scales from the wrapper and form the same exact int32
    products; the kernel dequantizes them in another fp32 order (the key
    factor ks * c first, the q scale in the exponent's FMA), so its logits
    agree with the plain version's to a few fp32 ulps, a relative 1e-7
    that is nothing beside bf16's 2^-9. Beyond that they differ where B1
    and its plain version do: each rounds its fp32 output to bf16 once (2
    ulps), and each casts the unnormalized probabilities to bf16 against
    another running maximum (the kernel per 128-key tile, the plain version
    per row), an independent 2^-9 relative error per term of P.V whose sum
    stays within 5e-2 of mean |ref|."""
    return check_close(got, ref, name, ulps=2, floor=5e-2)


def block_scaled(x: torch.Tensor, blk: int, phase: int = 0,
                 lo: float = 0.5, hi: float = 2.0) -> torch.Tensor:
    """x [B, L, H, D] with the rows of each run of `blk` rows scaled by hi
    and lo in turn (hi first when phase is 0). With `blk` B6's quantization
    block, neighbouring blocks take absmax scales hi / lo = 4 times apart, so
    a row or key dequantized by its neighbour block's scale has its logits
    off by that factor."""
    n = x.shape[1]
    odd = (torch.arange(n, device=x.device) // blk + phase) % 2
    f = torch.where(odd == 0, torch.tensor(hi, device=x.device),
                    torch.tensor(lo, device=x.device))
    return (x.float() * f[None, :, None, None]).to(x.dtype)


def check_rmsnorm_rope(got, ref, name: str) -> dict:
    """B3 against `rmsnorm_rope_plain`: 6 bf16 ulps of the pair's norm. The
    two sides differ only in the fp32 order of the sum of squares (and
    rsqrt), which can flip the bf16 rounding of x * inv by one ulp; the
    product with gamma in bf16 carries that to at most 3 ulps of y, the
    rotation to 3 * sqrt(2) ulps of the pair's norm (|cos|, |sin| <= 1,
    the norm bounds both elements), and the final cast adds one."""
    return check_close(got, ref, name, ulps=6, mag=pair_norm(ref))


def check_ln_modulation(got, ref, shift, mask, name: str) -> dict:
    """B4 against `ln_modulation_plain`: 4 bf16 ulps of |ref| + |shift|. The
    sides differ only in the fp32 order of the mean and variance sums, which
    can flip the bf16 rounding of ln by one ulp; ln * (1 + scale) in bf16
    carries that to at most 3 ulps of the product and the add of the shift
    to 4 ulps of the larger of product and output, both at most
    |ref| + |shift| (the shift as the kernel selects it, by token)."""
    sh = shift.float()
    if mask is None:
        sh = sh.reshape(sh.shape[0], 1, -1)
    else:
        m = mask.float()[:, :, None]
        sh = m * sh[:, 0:1] + (1.0 - m) * sh[:, 1:2]
    mag = ref.float().abs() + sh.to(ref.dtype).float().abs()
    return check_close(got, ref, name, ulps=4, mag=mag)
