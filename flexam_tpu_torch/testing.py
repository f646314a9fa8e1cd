"""Test helpers shared by the tests and `chip_smoke.py`: the closeness of a
kernel output to its plain version, and small ONNX graphs for DWPose (the
end of this module).

The closeness checks: `chip_smoke.py` and `tests/test_torch_cuda.py` hold
each CUDA kernel to its plain PyTorch version on the card. Each element is
held to its own size, not to the largest element of the tensor:

    |got - ref| <= ulps * ulp(mag) + floor * mean(|ref|)

with ulp the spacing of bf16 (the bf16 kernels), tf32 (the fp32 attention
kernels, which run TF32 wgmma) or fp32 (the fp32 row kernels) numbers.

`mag` is the size of the value the kernel rounds last (|ref| unless the
caller gives more, e.g. the terms of a sum that may cancel); `floor` covers
elements near zero whose error comes from a long sum, not from their own
rounding. The bound of each kernel, with its reason, is the check_* function
of that kernel below.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np
import torch


def _ulp(t: torch.Tensor, bits: int) -> torch.Tensor:
    """The spacing at |t| of numbers with `bits` significant bits and fp32's
    exponent range, as fp32 (fixed at and below the smallest normal)."""
    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32),
                       (e - bits).to(torch.int32))


def ulp_bf16(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t|, fp32 (2^-133 at and below the
    smallest normal)."""
    return _ulp(t, 8)


def ulp_tf32(t: torch.Tensor) -> torch.Tensor:
    """The spacing of tf32 numbers (10 mantissa bits) at |t|, fp32."""
    return _ulp(t, 11)


def ulp_f32(t: torch.Tensor) -> torch.Tensor:
    """The spacing of fp32 numbers at |t|."""
    return _ulp(t, 24)


_ULPS = {"bf16": ulp_bf16, "tf32": ulp_tf32, "fp32": ulp_f32}


def check_close(got: torch.Tensor, ref: torch.Tensor, name: str, *,
                ulps: float, floor: float = 0.0,
                mag: Optional[torch.Tensor] = None,
                unit: str = "bf16") -> dict:
    """Raise AssertionError unless every element of `got` is finite and
    within its bound (module docstring, ulps of `unit`) of `ref`; return the
    error figures."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                             f"{tuple(r.shape)}")
    err = (g - r).abs()
    mean_ref = r.abs().mean().item()
    allowed = ulps * _ULPS[unit](r.abs() if mag is None else mag) \
        + floor * mean_ref
    ratio = err / allowed
    worst = int(ratio.argmax().item())
    out = {"max_abs_err": err.max().item(),
           "max_err_over_bound": ratio.reshape(-1)[worst].item(),
           "bound": f"{ulps} {unit} ulps of "
                    f"{'|ref|' if mag is None else 'mag'}"
                    + (f" + {floor} x mean|ref|" if floor else ""),
           "mean_abs_ref": mean_ref, "max_abs_ref": r.abs().max().item()}
    out["max_rel_err"] = out["max_abs_err"] / (out["max_abs_ref"] or 1.0)
    if not bool(g.isfinite().all()) or out["max_err_over_bound"] > 1.0:
        raise AssertionError(
            f"{name}: error {err.reshape(-1)[worst].item()} at flat index "
            f"{worst} (ref {r.reshape(-1)[worst].item()}, got "
            f"{g.reshape(-1)[worst].item()}) exceeds its bound "
            f"{allowed.reshape(-1)[worst].item()} ({out['bound']}); "
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


def attention_split_plain(q, k, v, k_len=None, scale=None, *, tail: int,
                          parts: int, tile_keys: int,
                          rows: int = 128) -> torch.Tensor:
    """A plain model of B1's tail split (`ops/flash_attention.py
    tail_split`): the output of `attention_plain`, with each of the last
    `tail` work items (`rows` query rows of one (batch, head), q tiles
    fastest) recomputed as the kernel computes it in `parts` parts of its
    key tiles of `tile_keys` keys (on the card, those of
    `ops/flash_attention.b1_plan`; `split_units`' ranges over the tiles up
    to k_len, or over all Lk keys when k_len is 0) and merged. Each part
    keeps its fp32 row max m and sum l and its unnormalised O = P V, with
    P cast to q.dtype before P V as in B1; the merge is m = max m_p,
    O = sum 2^(m_p - m) O_p / sum 2^(m_p - m) l_p over the parts that have
    tiles."""
    from flexam_tpu_torch.ops.flash_attention import (MASK_VALUE,
                                                      attention_plain)
    out = attention_plain(q, k, v, k_len=k_len, scale=scale)
    if parts <= 1 or tail <= 0:
        return out
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    n_qt = -(-lq // rows)
    n_work = n_qt * h * b
    for item in range(n_work - tail, n_work):
        r0, hh, bb = (item % n_qt) * rows, (item // n_qt) % h, \
            item // (n_qt * h)
        r1 = min(r0 + rows, lq)
        valid = lk if k_len is None else max(0, min(int(k_len[bb]), lk))
        n = -(-(valid if valid > 0 else lk) // tile_keys)
        qf = q[bb, r0:r1, hh].float()
        ms, ls, os_ = [], [], []
        for p in range(parts):
            t0, t1 = p * n // parts, (p + 1) * n // parts
            if t0 == t1:
                continue
            k0, k1 = t0 * tile_keys, min(t1 * tile_keys, lk)
            logits = qf @ k[bb, k0:k1, hh].float().T * scale
            keys = torch.arange(k0, k1, device=q.device)
            logits = logits.masked_fill(keys[None, :] >= valid, MASK_VALUE)
            m = logits.amax(-1, keepdim=True)
            pr = torch.exp(logits - m)
            ms.append(m)
            ls.append(pr.sum(-1, keepdim=True))
            os_.append(pr.to(q.dtype).float() @ v[bb, k0:k1, hh].float())
        m = torch.stack(ms).amax(0)
        f = [torch.exp(mp - m) for mp in ms]
        num = sum(fp * op for fp, op in zip(f, os_))
        den = sum(fp * lp for fp, lp in zip(f, ls))
        out[bb, r0:r1, hh] = (num / den).to(q.dtype)
    return out


def check_attention_tf32(got, ref, name: str) -> dict:
    """B1/B2 in fp32 (TF32 wgmma) against `attention_plain` in exact fp32
    (TF32 off): 2 tf32 ulps of |ref| plus 1.25e-2 of mean |ref|. The kernel
    rounds four quantities of each term of P.V to tf32, to nearest: q and k
    (its pre-pass; they move the term's logit), its probability and its v,
    each a relative error of at most 2^-11, 2^-3 of a bf16 rounding; the
    plain version rounds none. `check_attention`'s floor, 5e-2 of mean
    |ref|, covers one bf16 rounding a term; four independent roundings of
    2^-3 that size add in quadrature to 2 x 2^-3 of it, 1.25e-2. The ulps
    cover a row whose weight sits on one key: its output is that key's v,
    rounded once, over a sum that saw its probability rounded once. (TF32
    keeps 3 more mantissa bits than bf16; the same arithmetic with bf16
    operands is 8x further off and fails this bound.)"""
    return check_close(got, ref, name, ulps=2, floor=1.25e-2, unit="tf32")


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


def check_sparse_attention_tf32(got, ref, name: str) -> dict:
    """B5 in fp32 (TF32 wgmma) against `masked_dense_attention` in exact
    fp32: B1's fp32 bound (`check_attention_tf32`) and reason. Over the
    keys a query block sees, the kernel runs B1-f32's arithmetic on the
    same pre-pass (q, k, its probability and v rounded to tf32 to nearest)
    and the plain version rounds none; masked keys weigh exactly 0 in
    both."""
    return check_close(got, ref, name, ulps=2, floor=1.25e-2, unit="tf32")


def check_int8_attention_tf32(got, ref, name: str) -> dict:
    """B6 in fp32 (int8 Q K^T, TF32 P.V) against `int8_attention_plain` in
    exact fp32: `check_attention_tf32`'s form, 2 tf32 ulps of |ref| plus
    1.25e-2 of mean |ref|, and 4 fp32 ulps of |ref| more. Both sides take
    the same int8 values and scales from the wrapper and form the same
    exact int32 products. The kernel rounds two quantities of each term of
    P.V to tf32 (its probability and its v; the plain version's fp32 P.V
    rounds none), half of B1-f32's four, whose floor covers them. Its
    dequantization in another fp32 order moves each logit by at most
    3 x 2^-23 of itself (`tests/test_torch_hopper_b5b6.py`), a few fp32
    ulps, which the last term adds. (The same arithmetic with P and v in
    bf16, 8x coarser, fails this bound.)"""
    return check_close(got, ref, name, ulps=2 + 4 * 2.0 ** -13,
                       floor=1.25e-2, unit="tf32")


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


# The fp32 row kernels: a CTA of 256 threads sums a row of up to 8192
# features as at most 8 vectors of 4 a thread (2 adds in a vector, 8 across
# them), a 32-lane butterfly (5) and the 8 warps in order (8): no path
# through its sum has more than 23 adds. PyTorch's reductions sum pairwise
# or in cascades, and take fewer than 64 on any path at these widths. A sum
# computed with at most c adds on any path is within c u sum|terms| of the
# exact sum (u = 2^-24), so the two sides' sums differ by at most
# (23 + 64) u = 87 u sum|terms|.


def check_rmsnorm_rope_f32(got, ref, name: str) -> dict:
    """B3 in fp32 against `rmsnorm_rope_plain` in fp32: 64 fp32 ulps of the
    pair's norm. The sides differ only in the order of the sum of squares
    (positive terms): their means differ relatively by at most 87 u (the
    comment above), inv = 1 / sqrt(mean + eps) by half that plus each
    side's square root and division (4 u), 48 u in all; y = x * inv * gamma
    adds two roundings a side (4 u) and the rotation's two products and sum
    three a side, each at most half an ulp of the pair's norm (|cos|, |sin|
    <= 1): 55 ulps. A bf16 rounding is 2^15 of them."""
    return check_close(got, ref, name, ulps=64, mag=pair_norm(ref),
                       unit="fp32")


def check_ln_modulation_f32(got, ref, x, shift, scale, mask,
                            name: str) -> dict:
    """B4 in fp32 against `ln_modulation_plain` in fp32: 96 fp32 ulps of
    mag = |ref| + |sh| + |1 + sc| rstd (|x - mean| + mean|x|), sh and sc the
    terms as the kernel selects them by token, mean and rstd the row's. The
    sides differ in the order of the mean's and the variance's sums: the
    means differ by at most 87 u mean|x| (the comment above), which ln =
    (x - mean) rstd carries times rstd; the variances (positive terms)
    relatively by 87 u, the rstd by half that plus a square root and a
    division a side (48 u), which ln carries times |x - mean| rstd; ln
    (1 + sc) and + sh round once a side, at most an ulp of |ref| + |sh|.
    Times |1 + sc|: under 92 ulps of mag. A bf16 rounding is 2^15 ulps."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).pow(2).mean(-1, keepdim=True) + 1e-6)
    sh, sc = shift.float(), scale.float()
    if mask is None:
        sh = sh.reshape(sh.shape[0], 1, -1)
        sc = sc.reshape(sc.shape[0], 1, -1)
    else:
        m = mask.float()[:, :, None]
        sh = m * sh[:, 0:1] + (1.0 - m) * sh[:, 1:2]
        sc = m * sc[:, 0:1] + (1.0 - m) * sc[:, 1:2]
    mag = (ref.float().abs() + sh.abs()
           + (1.0 + sc).abs() * rstd
           * ((xf - mean).abs() + xf.abs().mean(-1, keepdim=True)))
    return check_close(got, ref, name, ulps=96, mag=mag, unit="fp32")


# ---------------------------------------------------------------------------
# Small ONNX graphs for DWPose's tests and the card's smoke
# ---------------------------------------------------------------------------
#
# The inverse of `flexam_tpu_torch/io/onnx.py`: a protobuf wire-format
# encoder and seeded graphs shaped as DWPose's files, a YOLOX detector
# ([1, 3, 640, 640] -> [1, 8400, 85]) and an RTMPose estimator
# ([1, 3, 384, 288] -> [1, 133, 576], [1, 133, 768]).
#
# The tiny pair (`tiny_yolox_onnx`, `tiny_rtmpose_onnx`, a few channels)
# uses every op `perception/onnx_graph.py` runs, and the image decides
# what DWPose takes from it, away from rounding ties: the detector's boxes
# come from dyadic weights on a constant map (exact crops in any order of
# summation) while its objectness and class logits carry the head's
# features; each SimCC row's argmax is one of two seeded bins, chosen by
# the sign of a linear function of the row's tokens, and its maximum is a
# constant. `features=True` adds an intermediate feature map as an output.
#
# `yolox_onnx` and `rtmpose_onnx` are YOLOX-L and RTMPose-l at their
# published widths and depths (or cut by `width` / `depth`), with random
# weights: the work of the real path, with no decision worth comparing.

_INT_MAX = (1 << 63) - 1


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _field_int(num: int, v: int) -> bytes:
    return _key(num, 0) + _varint(int(v))


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _key(num, 2) + _varint(len(payload)) + payload


def _field_str(num: int, s: str) -> bytes:
    return _field_bytes(num, s.encode())


_NP_TO_ONNX = {np.dtype(np.float32): 1, np.dtype(np.uint8): 2,
               np.dtype(np.int8): 3, np.dtype(np.int32): 6,
               np.dtype(np.int64): 7, np.dtype(np.bool_): 9,
               np.dtype(np.float16): 10, np.dtype(np.float64): 11}


def onnx_tensor(name: str, arr: np.ndarray, raw: bool = True) -> bytes:
    """A TensorProto: dims, data type and the data as raw bytes, or (raw
    False, float32 / int64 only) as packed float_data / int64_data."""
    arr = np.asarray(arr)
    out = b"".join(_field_int(1, d) for d in arr.shape)
    out += _field_int(2, _NP_TO_ONNX[arr.dtype]) + _field_str(8, name)
    if raw:
        return out + _field_bytes(9, arr.astype(arr.dtype.newbyteorder("<"))
                                  .tobytes())
    if arr.dtype == np.float32:
        return out + _field_bytes(4, arr.astype("<f4").tobytes())
    if arr.dtype == np.int64:
        return out + _field_bytes(
            7, b"".join(_varint(int(v)) for v in arr.reshape(-1)))
    raise ValueError(f"onnx_tensor: no packed field for {arr.dtype}")


def _attribute(name: str, v) -> bytes:
    out = _field_str(1, name)
    if isinstance(v, float):
        return out + _field_int(20, 1) + _key(2, 5) + struct.pack("<f", v)
    if isinstance(v, (bool, int, np.integer)):
        return out + _field_int(20, 2) + _field_int(3, int(v))
    if isinstance(v, (str, bytes)):
        b = v.encode() if isinstance(v, str) else v
        return out + _field_int(20, 3) + _field_bytes(4, b)
    if isinstance(v, np.ndarray):
        return out + _field_int(20, 4) + _field_bytes(5, onnx_tensor("", v))
    if all(isinstance(x, float) for x in v):
        return out + _field_int(20, 6) + b"".join(
            _key(7, 5) + struct.pack("<f", x) for x in v)
    return out + _field_int(20, 7) + b"".join(_field_int(8, x) for x in v)


def _value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b"".join(_field_bytes(1, _field_int(1, d)) for d in shape)
    tensor = _field_int(1, elem_type) + _field_bytes(2, dims)
    return _field_str(1, name) + _field_bytes(2, _field_bytes(1, tensor))


class OnnxWriter:
    """Builds a graph node by node and encodes it as a ModelProto."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.RandomState(seed)
        self.nodes: list = []
        self.inits: dict = {}
        self._n = 0

    def _name(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def const(self, arr, stem: str = "w") -> str:
        """An initializer; returns its name."""
        name = self._name(stem)
        self.inits[name] = np.asarray(arr)
        return name

    def op(self, op_type: str, inputs, n_out: int = 1, **attrs):
        """A node; returns its output name (or names, n_out > 1)."""
        outs = [self._name(op_type.lower()) for _ in range(n_out)]
        self.nodes.append((op_type, list(inputs), outs, attrs))
        return outs[0] if n_out == 1 else outs

    def to_bytes(self, inputs, outputs, opset: int = 11,
                 raw: bool = True) -> bytes:
        """`inputs` / `outputs`: [(name, shape)]."""
        g = []
        for i, (op_type, ins, outs, attrs) in enumerate(self.nodes):
            n = b"".join(_field_str(1, x) for x in ins)
            n += b"".join(_field_str(2, x) for x in outs)
            n += _field_str(3, f"{op_type}_{i}") + _field_str(4, op_type)
            n += b"".join(_field_bytes(5, _attribute(k, v))
                          for k, v in attrs.items())
            g.append(_field_bytes(1, n))
        g.append(_field_str(2, "graph"))
        g += [_field_bytes(5, onnx_tensor(k, v, raw))
              for k, v in self.inits.items()]
        g += [_field_bytes(11, _value_info(n, s)) for n, s in inputs]
        g += [_field_bytes(12, _value_info(n, s)) for n, s in outputs]
        opset_id = _field_str(1, "") + _field_int(2, opset)
        return b"".join([_field_int(1, 7),
                         _field_str(2, "flexam_tpu_torch.testing"),
                         _field_bytes(7, b"".join(g)),
                         _field_bytes(8, opset_id)])

    # layers -------------------------------------------------------------

    def randn(self, *shape, std: float = 1.0) -> np.ndarray:
        return (self.rng.randn(*shape) * std).astype(np.float32)

    def conv(self, x: str, cin: int, cout: int, k: int, stride: int = 1,
             silu: bool = True, bias: bool = True, group: int = 1,
             scale: float = 1.0) -> str:
        """A convolution with its batch norm folded in (as the exports
        have it), He-scaled random weights times `scale`, then SiLU."""
        fan_in = cin // group * k * k
        ins = [x, self.const(self.randn(cout, cin // group, k, k,
                                        std=scale * (2.0 / fan_in) ** 0.5))]
        if bias:
            ins.append(self.const(self.randn(cout, std=0.1), "b"))
        y = self.op("Conv", ins, kernel_shape=[k, k],
                    strides=[stride, stride], pads=[k // 2] * 4,
                    **({"group": group} if group > 1 else {}))
        if silu:                      # SiLU as the exports write it
            y = self.op("Mul", [y, self.op("Sigmoid", [y])])
        return y

    def linear(self, x: str, din: int, dout: int, scale: float = 1.0,
               bias: bool = True) -> str:
        y = self.op("MatMul", [x, self.const(
            self.randn(din, dout, std=scale / din ** 0.5))])
        if not bias:
            return y
        return self.op("Add", [y, self.const(self.randn(dout, std=0.1 * scale),
                                             "b")])

    def scale_norm(self, x: str, dim: int) -> str:
        """mmpose's ScaleNorm: x / (||x|| dim^-1/2 + eps) * g."""
        n = self.op("ReduceL2", [x], axes=[-1], keepdims=1)
        n = self.op("Mul", [n, self.const(np.float32(dim ** -0.5), "s")])
        n = self.op("Add", [n, self.const(np.float32(1e-5), "eps")])
        return self.op("Mul", [self.op("Div", [x, n]),
                               self.const(np.float32(1.3), "g")])

    def focus(self, x: str) -> str:
        """YOLOX's Focus: the four 2x2 phases, concatenated on channels."""
        big = np.asarray([_INT_MAX, _INT_MAX], np.int64)
        axes = self.const(np.asarray([2, 3], np.int64), "axes")
        steps = self.const(np.asarray([2, 2], np.int64), "steps")
        ends = self.const(big, "ends")
        return self.op("Concat", [
            self.op("Slice", [x, self.const(np.asarray(s, np.int64), "st"),
                              ends, axes, steps])
            for s in ((0, 0), (1, 0), (0, 1), (1, 1))], axis=1)

    def upsample(self, x: str) -> str:
        """nn.Upsample(scale_factor=2, mode="nearest") at opset 11."""
        return self.op("Resize", [
            x, self.const(np.zeros(0, np.float32), "roi"),
            self.const(np.asarray([1, 1, 2, 2], np.float32), "scales")],
            mode="nearest", coordinate_transformation_mode="asymmetric",
            nearest_mode="floor")

    def flatten_head(self, o: str, channels: int = 85) -> str:
        """[1, C, h, w] -> [1, C, h * w] through the exports' Shape /
        Gather / Unsqueeze / Cast / Concat / Reshape."""
        shape = self.op("Shape", [o])
        batch = self.op("Gather", [shape, self.op(
            "Constant", [], value=np.asarray(0, np.int64))], axis=0)
        batch = self.op("Cast", [self.op("Unsqueeze", [batch], axes=[0])],
                        to=7)
        target = self.op("Concat", [batch, self.const(
            np.asarray([channels, -1], np.int64), "shape")], axis=0)
        return self.op("Reshape", [o, target])


YOLOX_OUTPUT = "dets"
RTMPOSE_OUTPUTS = ("simcc_x", "simcc_y")


def tiny_yolox_onnx(seed: int = 0, people: str = "people",
                    opset: int = 11, features: bool = False) -> bytes:
    """A YOLOX-shaped detector: Focus slicing, SiLU as Sigmoid * Mul, SPP
    max-pools, nearest upsampling, a decoupled head flattened through the
    exports' Shape / Gather / Unsqueeze / Concat / Reshape pattern to
    [1, 8400, 85]. `people`: "people" (three person anchors pass the score
    threshold and one of them overlaps another), "other" (only class 1
    passes) or "none" (nothing passes). Which anchors pass, and their
    boxes, come from a constant map; the objectness and class logits add
    the head's features. `features`: also output the stride-8 neck
    feature ("neck", [1, 8, 80, 80])."""
    wr = OnnxWriter(seed)
    c = wr.conv(wr.focus("images"), 12, 4, 3)               # 320
    c = wr.conv(c, 4, 8, 3, 2)                                # 160
    c8 = wr.conv(c, 8, 8, 3, 2)                               # 80
    c16 = wr.conv(c8, 8, 8, 3, 2)                             # 40
    c32 = wr.conv(c16, 8, 8, 3, 2)                            # 20
    pools = [wr.op("MaxPool", [c32], kernel_shape=[k, k], strides=[1, 1],
                   pads=[k // 2] * 4) for k in (5, 9, 13)]
    spp = wr.conv(wr.op("Concat", [c32] + pools, axis=1), 32, 8, 1)
    p16 = wr.op("Add", [c16, wr.upsample(spp)])
    p8 = wr.op("Add", [c8, wr.upsample(p16)])
    flat = []
    score = {"people": (3.0, 2.5, 2.0, 1.0), "other": (3.0, 2.0, 1.0, 1.0),
             "none": ()}[people]
    hot = {32: [(5, 5), (5, 6), (12, 10)], 16: [], 8: [(40, 40)]}
    k = 0
    for feat, stride in ((p8, 8), (p16, 16), (spp, 32)):
        n = 640 // stride
        pos = np.full((1, 1, n, n), -10.0, np.float32)
        for (gy, gx) in hot[stride]:
            if k < len(score):
                pos[0, 0, gy, gx] = score[k]
            k += 1
        h = wr.conv(feat, 8, 8, 3)
        h = wr.op("Concat", [h, wr.const(pos, "pos")], axis=1)   # 9 ch
        w = np.zeros((85, 9), np.float32)
        b = np.zeros(85, np.float32)
        b[:4] = (0.5, 0.5, 1.5, 2.0)          # cx, cy, log w, log h
        w[2:4, 8] = 0.125                     # sizes follow the map
        w[4, 8] = 1.0                         # objectness: the map
        w[4, :8] = wr.rng.randn(8) * 0.01     # + the image (std ~2)
        w[5:, :8] = wr.rng.randn(80, 8) * 0.05
        b[5:] = -8.0
        b[5 + (1 if people == "other" else 0)] = 4.0
        o = wr.op("Conv", [h, wr.const(w[:, :, None, None]),
                           wr.const(b, "b")],
                  kernel_shape=[1, 1])
        reg, obj, cls = wr.op("Split", [o], n_out=3, axis=1, split=[4, 1, 80])
        o = wr.op("Concat", [reg, wr.op("Sigmoid", [obj]),
                             wr.op("Sigmoid", [cls])], axis=1)
        flat.append(wr.flatten_head(o))
    out = wr.op("Transpose", [wr.op("Concat", flat, axis=2)], perm=[0, 2, 1])
    wr.nodes.append(("Identity", [out], [YOLOX_OUTPUT], {}))
    outputs = [(YOLOX_OUTPUT, (1, 8400, 85))]
    if features:
        wr.nodes.append(("Identity", [p8], ["neck"], {}))
        outputs.append(("neck", (1, 8, 80, 80)))
    return wr.to_bytes([("images", (1, 3, 640, 640))], outputs, opset)


def tiny_rtmpose_onnx(seed: int = 0, opset: int = 11,
                      features: bool = False) -> bytes:
    """An RTMPose-shaped wholebody estimator: a CSPNeXt-like stem with
    channel attention (GlobalAveragePool, 1x1 Conv, HardSigmoid) and a
    softmax channel gate, SPPF, then the RTMCC head: a 7x7 conv to 133
    maps, flattened, standardized (ReduceMean / Sub / Sqrt / Div),
    ScaleNorm + Linear, one GAU (Linear, SiLU, Split, per-row q / k
    offsets, ReLU^2 attention) and the two SimCC linears (a MatMul for x,
    a Gemm for y) to [1, 133, 576] and [1, 133, 768].

    The image decides each keypoint: every SimCC row is a tent over the
    bins, 0.1 a bin down from a seeded peak a, and at a second seeded bin
    b, 10-40 bins away, it rises to the tent's top + 0.5 where s, a linear
    function of the row's tokens (std ~7), exceeds 0.1 |a - b|,
    else to the top - 0.5. The row's argmax is then b or a, 0.1 or more
    ahead of the next bin, so a network computed wrongly moves keypoints;
    the maxima themselves are constants, exact in any runtime.
    `features`: also output the tokens the SimCC linears read ("tokens",
    [1, 133, 16])."""
    wr = OnnxWriter(seed + 1000)
    c = wr.conv("input", 3, 4, 3, 2)                 # 192 x 144
    for cin in (4, 8, 8, 8):
        c = wr.conv(c, cin, 8, 3, 2)                  # ... 12 x 9
    a = wr.op("GlobalAveragePool", [c])
    a = wr.conv(a, 8, 8, 1, silu=False)
    # the Identity keeps OpenCV 5.0.0's dnn (the tests' reference) from
    # fusing HardSigmoid into the broadcast Mul, which it does with the
    # gate's [1, 8, 1, 1] shape as the product's
    gate = wr.op("Identity", [wr.op("HardSigmoid", [a], alpha=1.0 / 6,
                                    beta=0.5)])
    c = wr.op("Mul", [c, gate])
    g = wr.op("Softmax", [wr.op("Flatten", [wr.op("GlobalAveragePool", [c])],
                                axis=1)], axis=1)
    g = wr.op("Reshape", [g, wr.const(np.asarray([1, 8, 1, 1], np.int64),
                                      "shape")])
    c = wr.op("Mul", [wr.op("Mul", [c, g]), wr.const(np.float32(8.0), "s")])
    pools = [c]
    for _ in range(3):
        pools.append(wr.op("MaxPool", [pools[-1]], kernel_shape=[5, 5],
                           strides=[1, 1], pads=[2, 2, 2, 2]))
    c = wr.conv(wr.op("Concat", pools, axis=1), 32, 8, 1)
    f = wr.conv(c, 8, 133, 7, silu=False)            # [1, 133, 12, 9]
    f = wr.op("Unsqueeze", [wr.op("Flatten", [f], axis=2)], axes=[0])
    mean = wr.op("ReduceMean", [f], axes=[-1], keepdims=1)
    d = wr.op("Sub", [f, mean])
    var = wr.op("ReduceMean", [wr.op("Mul", [d, d])], axes=[-1], keepdims=1)
    f = wr.op("Div", [d, wr.op("Sqrt", [wr.op("Add", [
        var, wr.const(np.float32(1e-5), "eps")])])])
    h = wr.linear(wr.scale_norm(f, 108), 108, 16)
    # the GAU (mmpose RTMCCBlock), expansion 8, attention width 8
    e, s = 8, 8
    uv = wr.linear(wr.scale_norm(h, 16), 16, 2 * e + s)
    uv = wr.op("Mul", [uv, wr.op("Sigmoid", [uv])])
    u, v, base = wr.op("Split", [uv], n_out=3, axis=2, split=[e, e, s])
    base = wr.op("Unsqueeze", [base], axes=[2])              # [1,133,1,s]
    base = wr.op("Add", [wr.op("Mul", [base, wr.const(
        (1 + 0.02 * wr.rng.randn(2, s)).astype(np.float32), "gamma")]),
        wr.const((0.02 * wr.rng.randn(2, s)).astype(np.float32), "beta")])
    q, k = wr.op("Split", [base], n_out=2, axis=2, split=[1, 1])
    q = wr.op("Squeeze", [q], axes=[2])
    k = wr.op("Squeeze", [k], axes=[2])
    qk = wr.op("MatMul", [q, wr.op("Transpose", [k], perm=[0, 2, 1])])
    kern = wr.op("Pow", [wr.op("Relu", [wr.op("Div", [
        qk, wr.const(np.float32(s ** 0.5), "s")])]),
        wr.const(np.float32(2.0), "p")])
    o = wr.op("Mul", [u, wr.op("MatMul", [kern, v])])
    h = wr.op("Add", [h, wr.linear(o, e, 16, scale=0.02)])
    # SimCC logits: the tent at a, the image's choice at b, and a small
    # share of the tokens in every bin (the SimCC linears' own weights)
    heads = []
    for n_bins in (576, 768):
        peak = wr.rng.randint(0, n_bins, 133)
        top = wr.rng.uniform(-0.3, 1.0, 133)
        tent = (top[:, None] - 0.1 * np.abs(
            np.arange(n_bins)[None] - peak[:, None])).astype(np.float32)
        off = wr.rng.randint(10, 41, 133)
        second = np.where(peak + off < n_bins, peak + off, peak - off)
        hot = np.zeros((133, n_bins), np.float32)
        hot[np.arange(133), second] = 1.0
        thr = (0.1 * off).astype(np.float32)[:, None]
        heads.append((n_bins, tent, hot, thr, wr.randn(16, 1, std=1.5)))
    (nx, *head_x), (ny, *head_y) = heads
    half = wr.const(np.float32(0.5), "half")
    gain = wr.const(np.float32(1e6), "gain")

    def logits(lin, tokens, tent, hot, thr, ws):
        """lin + tent + hot * (thr + clamp(1e6 (s - thr), -0.5, 0.5)),
        s = tokens @ ws: the clamp is exact outside |s - thr| < 5e-7,
        so b's logit is the tent's top +- 0.5 there."""
        thr = wr.const(thr, "thr")
        s = wr.op("MatMul", [tokens, wr.const(ws)])          # [.., 133, 1]
        x = wr.op("Mul", [wr.op("Sub", [s, thr]), gain])
        x = wr.op("Sub", [wr.op("Relu", [wr.op("Add", [x, half])]), half])
        x = wr.op("Sub", [half, wr.op("Relu", [wr.op("Sub", [half, x])])])
        return wr.op("Add", [wr.op("Add", [lin, wr.const(tent, "tent")]),
                             wr.op("Mul", [wr.op("Add", [x, thr]),
                                           wr.const(hot, "hot")])])

    wx = wr.randn(16, nx, std=5e-5)
    sx = logits(wr.op("MatMul", [h, wr.const(wx)]), h, *head_x)
    wy = wr.randn(ny, 16, std=5e-5)
    h2 = wr.op("Reshape", [h, wr.const(np.asarray([133, 16], np.int64),
                                       "shape")])
    sy = wr.op("Gemm", [h2, wr.const(wy), wr.const(
        np.zeros(ny, np.float32), "b")], transB=1, alpha=1.0, beta=1.0)
    sy = wr.op("Unsqueeze", [logits(sy, h2, *head_y)], axes=[0])
    wr.nodes.append(("Identity", [sx], [RTMPOSE_OUTPUTS[0]], {}))
    wr.nodes.append(("Identity", [sy], [RTMPOSE_OUTPUTS[1]], {}))
    outputs = [(RTMPOSE_OUTPUTS[0], (1, 133, 576)),
               (RTMPOSE_OUTPUTS[1], (1, 133, 768))]
    if features:
        wr.nodes.append(("Identity", [h], ["tokens"], {}))
        outputs.append(("tokens", (1, 133, 16)))
    return wr.to_bytes([("input", (1, 3, 384, 288))], outputs, opset)


def yolox_onnx(seed: int = 0, depth: float = 1.0, width: float = 1.0,
               persons=((8, 5), (8, 13)), opset: int = 11) -> bytes:
    """YOLOX at `depth` / `width` with random weights: at 1.0 / 1.0 it is
    YOLOX-L, DWPose's detector, at its published widths (CSPDarknet
    64..1024 channels with 3 / 9 / 9 / 3 bottlenecks, SPP 5 / 9 / 13, the
    PAFPN's four CSP layers of 3, the decoupled head at 256) and shapes
    ([1, 3, 640, 640] -> [1, 8400, 85]). Batch norms are folded into the
    convolutions, as the exports have them. Random weights find no person,
    so the objectness adds a constant map, +12 at the stride-32 anchors
    `persons` (grid row, column) and -12 elsewhere, and class 0 leads. The
    input is 0..255 pixels, so the first convolution's weights are scaled
    by 1/128 to keep the random activations near 1."""
    wr = OnnxWriter(seed + 2000)
    bc, bd = int(64 * width), max(round(3 * depth), 1)

    def csp(x, cin, cout, n, shortcut=True):
        hid = int(cout * 0.5)
        a, b = wr.conv(x, cin, hid, 1), wr.conv(x, cin, hid, 1)
        for _ in range(n):
            y = wr.conv(wr.conv(a, hid, hid, 1), hid, hid, 3,
                        scale=0.5 if shortcut else 1.0)
            a = wr.op("Add", [y, a]) if shortcut else y
        return wr.conv(wr.op("Concat", [a, b], axis=1), 2 * hid, cout, 1)

    x = wr.conv(wr.focus("images"), 12, bc, 3, scale=1 / 128)   # 0..255 in
    x = csp(wr.conv(x, bc, 2 * bc, 3, 2), 2 * bc, 2 * bc, bd)
    d3 = csp(wr.conv(x, 2 * bc, 4 * bc, 3, 2), 4 * bc, 4 * bc, 3 * bd)
    d4 = csp(wr.conv(d3, 4 * bc, 8 * bc, 3, 2), 8 * bc, 8 * bc, 3 * bd)
    x = wr.conv(d4, 8 * bc, 16 * bc, 3, 2)
    hid = 8 * bc                                       # SPP bottleneck
    x = wr.conv(x, 16 * bc, hid, 1)
    x = wr.conv(wr.op("Concat", [x] + [
        wr.op("MaxPool", [x], kernel_shape=[k, k], strides=[1, 1],
              pads=[k // 2] * 4) for k in (5, 9, 13)], axis=1),
        4 * hid, 16 * bc, 1)
    d5 = csp(x, 16 * bc, 16 * bc, bd, shortcut=False)
    c = [int(256 * width), int(512 * width), int(1024 * width)]
    n = round(3 * depth)
    fpn0 = wr.conv(d5, c[2], c[1], 1)                  # the PAFPN
    f0 = csp(wr.op("Concat", [wr.upsample(fpn0), d4], axis=1),
             2 * c[1], c[1], n, False)
    fpn1 = wr.conv(f0, c[1], c[0], 1)
    pan2 = csp(wr.op("Concat", [wr.upsample(fpn1), d3], axis=1),
               2 * c[0], c[0], n, False)
    pan1 = csp(wr.op("Concat", [wr.conv(pan2, c[0], c[0], 3, 2), fpn1],
                     axis=1), 2 * c[0], c[1], n, False)
    pan0 = csp(wr.op("Concat", [wr.conv(pan1, c[1], c[1], 3, 2), fpn0],
                     axis=1), 2 * c[1], c[2], n, False)
    hw = int(256 * width)
    flat = []
    for feat, cin, stride in ((pan2, c[0], 8), (pan1, c[1], 16),
                              (pan0, c[2], 32)):
        stem = wr.conv(feat, cin, hw, 1)
        cls = wr.conv(wr.conv(stem, hw, hw, 3), hw, hw, 3)
        reg = wr.conv(wr.conv(stem, hw, hw, 3), hw, hw, 3)
        cls_b = np.full(80, -6.0, np.float32)
        cls_b[0] = 6.0
        g = 640 // stride
        pos = np.full((1, 1, g, g), -12.0, np.float32)
        for gy, gx in (persons if stride == 32 else ()):
            pos[0, 0, gy, gx] = 12.0
        size = np.log(np.asarray([160.0, 360.0]) / stride)
        reg_b = np.asarray([0.5, 0.5, *size], np.float32)

        def pred(t, cout, b):
            return wr.op("Conv", [t, wr.const(wr.randn(
                cout, hw, 1, 1, std=0.02 / hw ** 0.5)), wr.const(b, "b")],
                kernel_shape=[1, 1])

        obj = wr.op("Add", [pred(reg, 1, np.zeros(1, np.float32)),
                            wr.const(pos, "pos")])
        o = wr.op("Concat", [pred(reg, 4, reg_b), wr.op("Sigmoid", [obj]),
                             wr.op("Sigmoid", [pred(cls, 80, cls_b)])],
                  axis=1)
        flat.append(wr.flatten_head(o))
    out = wr.op("Transpose", [wr.op("Concat", flat, axis=2)], perm=[0, 2, 1])
    wr.nodes.append(("Identity", [out], [YOLOX_OUTPUT], {}))
    return wr.to_bytes([("images", (1, 3, 640, 640))],
                       [(YOLOX_OUTPUT, (1, 8400, 85))], opset)


def rtmpose_onnx(seed: int = 0, depth: float = 1.0, width: float = 1.0,
                 opset: int = 11) -> bytes:
    """RTMPose at `depth` / `width` with random weights: at 1.0 / 1.0 it
    is RTMPose-l, DWPose's wholebody estimator at 384 x 288 ([1, 3, 384,
    288] -> [1, 133, 576], [1, 133, 768]), at its published widths: the
    CSPNeXt backbone (stem 32 / 32 / 64, stages of 128 / 256 / 512 / 1024
    channels with 3 / 6 / 6 / 3 blocks of a 3x3 conv and a depthwise 5x5 +
    pointwise pair, channel attention, SPPF in the last) and the RTMCC head
    (a 7x7 conv to 133 maps of 12 x 9, ScaleNorm + Linear to 256, a GAU of
    expansion 2 and attention width 128, the two SimCC linears). Batch
    norms are folded into the convolutions; ScaleNorm adds its eps."""
    wr = OnnxWriter(seed + 3000)
    stem = int(64 * width)
    x = wr.conv("input", 3, stem // 2, 3, 2)
    x = wr.conv(wr.conv(x, stem // 2, stem // 2, 3), stem // 2, stem, 3)
    cin = stem
    for i, (cout, n, add, spp) in enumerate(((128, 3, True, False),
                                              (256, 6, True, False),
                                              (512, 6, True, False),
                                              (1024, 3, False, True))):
        cout, n = int(cout * width), max(round(n * depth), 1)
        x = wr.conv(x, cin, cout, 3, 2)
        if spp:                                        # SPPF
            mid = cout // 2
            pools = [wr.conv(x, cout, mid, 1)]
            for _ in range(3):
                pools.append(wr.op("MaxPool", [pools[-1]],
                                   kernel_shape=[5, 5], strides=[1, 1],
                                   pads=[2, 2, 2, 2]))
            x = wr.conv(wr.op("Concat", pools, axis=1), 4 * mid, cout, 1)
        mid = cout // 2                                # the CSP layer
        main, short = wr.conv(x, cout, mid, 1), wr.conv(x, cout, mid, 1)
        for _ in range(n):
            y = wr.conv(main, mid, mid, 3)
            y = wr.conv(y, mid, mid, 5, group=mid)
            y = wr.conv(y, mid, mid, 1, scale=0.5 if add else 1.0)
            main = wr.op("Add", [y, main]) if add else y
        x = wr.op("Concat", [main, short], axis=1)
        a = wr.conv(wr.op("GlobalAveragePool", [x]), 2 * mid, 2 * mid, 1,
                    silu=False)
        # (the Identity as in tiny_rtmpose_onnx, for OpenCV's dnn)
        x = wr.op("Mul", [x, wr.op("Identity", [wr.op(
            "HardSigmoid", [a], alpha=1.0 / 6, beta=0.5)])])
        x = wr.conv(x, 2 * mid, cout, 1)
        cin = cout
    f = wr.conv(x, cin, 133, 7, silu=False)            # [1, 133, 12, 9]
    f = wr.op("Unsqueeze", [wr.op("Flatten", [f], axis=2)], axes=[0])
    h = wr.linear(wr.scale_norm(f, 108), 108, 256, bias=False)
    e, s = 512, 128                                    # the GAU
    uv = wr.linear(wr.scale_norm(h, 256), 256, 2 * e + s, bias=False)
    uv = wr.op("Mul", [uv, wr.op("Sigmoid", [uv])])
    u, v, base = wr.op("Split", [uv], n_out=3, axis=2, split=[e, e, s])
    base = wr.op("Add", [wr.op("Mul", [
        wr.op("Unsqueeze", [base], axes=[2]),
        wr.const(1 + wr.randn(2, s, std=0.02), "gamma")]),
        wr.const(wr.randn(2, s, std=0.02), "beta")])
    q, k = (wr.op("Squeeze", [t], axes=[2]) for t in wr.op(
        "Split", [base], n_out=2, axis=2, split=[1, 1]))
    qk = wr.op("MatMul", [q, wr.op("Transpose", [k], perm=[0, 2, 1])])
    kern = wr.op("Pow", [wr.op("Relu", [wr.op("Div", [
        qk, wr.const(np.float32(s ** 0.5), "s")])]),
        wr.const(np.float32(2.0), "p")])
    o = wr.linear(wr.op("Mul", [u, wr.op("MatMul", [kern, v])]), e, 256,
                  scale=0.02, bias=False)
    h = wr.op("Add", [wr.op("Mul", [h, wr.const(
        1 + wr.randn(256, std=0.02), "res_scale")]), o])
    sx = wr.linear(h, 256, 576, bias=False)
    sy = wr.linear(h, 256, 768, bias=False)
    wr.nodes.append(("Identity", [sx], [RTMPOSE_OUTPUTS[0]], {}))
    wr.nodes.append(("Identity", [sy], [RTMPOSE_OUTPUTS[1]], {}))
    return wr.to_bytes([("input", (1, 3, 384, 288))],
                       [(RTMPOSE_OUTPUTS[0], (1, 133, 576)),
                        (RTMPOSE_OUTPUTS[1], (1, 133, 768))], opset)


def write_dwpose(directory: str, seed: int = 0, depth: float = 1.0,
                 width: float = 1.0):
    """Write `yolox_onnx` and `rtmpose_onnx` (YOLOX-L and RTMPose-l at
    1.0 / 1.0) into `directory`; returns (det path, pose path)."""
    det = os.path.join(directory, f"yolox_{depth}_{width}_{seed}.onnx")
    pose = os.path.join(directory, f"rtmpose_{depth}_{width}_{seed}.onnx")
    with open(det, "wb") as f:
        f.write(yolox_onnx(seed, depth, width))
    with open(pose, "wb") as f:
        f.write(rtmpose_onnx(seed, depth, width))
    return det, pose


def write_tiny_dwpose(directory: str, seed: int = 0,
                      people: str = "people"):
    """Write the two graphs into `directory`; returns (det path, pose
    path), the values of FLEXAM_DWPOSE_DET / FLEXAM_DWPOSE_POSE."""
    det = os.path.join(directory, f"tiny_yolox_{people}_{seed}.onnx")
    pose = os.path.join(directory, f"tiny_rtmpose_{seed}.onnx")
    with open(det, "wb") as f:
        f.write(tiny_yolox_onnx(seed, people))
    with open(pose, "wb") as f:
        f.write(tiny_rtmpose_onnx(seed))
    return det, pose


def tiny_depth_onnx(seed: int = 0, size: int = 384) -> bytes:
    """A MiDaS-shaped depth export for the registry's `onnx` hook: "image"
    [1, 3, size, size] -> a stride-2 SiLU conv, a SiLU conv, nearest
    upsampling, a 1-channel conv -> "depth" [1, 1, size, size]."""
    wr = OnnxWriter(seed)
    c = wr.conv(wr.conv("image", 3, 8, 3, 2), 8, 8, 3)
    d = wr.conv(wr.upsample(c), 8, 1, 3, silu=False, scale=0.5)
    wr.nodes.append(("Identity", [d], ["depth"], {}))
    return wr.to_bytes([("image", (1, 3, size, size))],
                       [("depth", (1, 1, size, size))])


# ---------------------------------------------------------------------------
# Checkpoint files in the published names (random weights)
# ---------------------------------------------------------------------------

def write_flux_files(directory: str, repainter) -> dict:
    """A `repaint_flux.FluxDepthRepainter`'s transformer and VAE written as
    `flux1-depth-dev.safetensors` (BFL names) and `ae.safetensors`:
    {"ckpt", "ae"} -> path, the values of FLEXAM_FLUX_CKPT /
    FLEXAM_FLUX_AE."""
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    from flexam_tpu_torch.models.flux import flux_state_dict
    from flexam_tpu_torch.models.flux_vae import flux_vae_state_dict
    paths = {"ckpt": os.path.join(directory, "flux1-depth-dev.safetensors"),
             "ae": os.path.join(directory, "ae.safetensors")}
    save_safetensors(paths["ckpt"], flux_state_dict(repainter.params,
                                                    repainter.cfg))
    save_safetensors(paths["ae"], flux_vae_state_dict(repainter.vae_params,
                                                      repainter.vae_cfg))
    return paths


def write_depthcrafter_files(directory: str, unet: dict, vae: dict,
                             clip: Optional[dict] = None,
                             clip_heads: int = 16,
                             clip_act: str = "gelu") -> dict:
    """DepthCrafter's files: the SVD UNet (`unet.safetensors`, the published
    names), the video VAE (`vae.safetensors`: a {"encoder", "decoder",
    "quant_conv"} tree in JAX's CompVis naming with the temporal decoder,
    or a FLUX-VAE tree at SD geometry), and the CLIP vision tower
    (`image_encoder/model.safetensors`, HF names, with the config.json that
    gives its heads and activation). {"unet", "vae"[, "clip"]} -> path,
    the values of FLEXAM_DEPTHCRAFTER_CKPT / FLEXAM_SVD_VAE /
    FLEXAM_SVD_CLIP."""
    import json

    from flexam_tpu_torch.io.checkpoints import save_safetensors
    from flexam_tpu_torch.models.clip import clip_vision_state_dict
    from flexam_tpu_torch.models.svd_unet import svd_unet_state_dict
    from flexam_tpu_torch.models.svd_vae import svd_vae_state_dict
    paths = {"unet": os.path.join(directory, "unet.safetensors"),
             "vae": os.path.join(directory, "vae.safetensors")}
    save_safetensors(paths["unet"], svd_unet_state_dict(unet))
    if "conv_in" in vae.get("decoder", {}) and "time_conv_out" in vae[
            "decoder"]:
        save_safetensors(paths["vae"], svd_vae_state_dict(vae))
    else:
        from flexam_tpu_torch.models.flux_vae import flux_vae_state_dict
        from flexam_tpu_torch.models.svd_vae import _encoder_cfg
        save_safetensors(paths["vae"], flux_vae_state_dict(
            vae, _encoder_cfg(vae["encoder"])))
    if clip is not None:
        d = os.path.join(directory, "image_encoder")
        os.makedirs(d, exist_ok=True)
        paths["clip"] = os.path.join(d, "model.safetensors")
        save_safetensors(paths["clip"], clip_vision_state_dict(clip))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({"num_attention_heads": clip_heads,
                       "hidden_act": clip_act}, f)
    return paths
