"""The quantized weight modes on the card: int8 linears and float8 storage.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quant_cuda.py

What the CPU tests cannot show:
  * `torch._int_mm` (cuBLASLt's int8 GEMM) gives the CPU's exact int32
    accumulators for the same int8 operands, at the flagship ffn width and
    with fewer than 17 rows (padded);
  * no operand is copied around the GEMM (`weight_q.t()` is the layout it
    takes): the call allocates its int32 result and nothing of the 44 M
    weight's size;
  * weight quantization on the card equals numpy's (`_quantize_weight_host`)
    byte for byte, also on values built to sit on rounding ties, and so does
    the float8 conversion (from float32 and from bf16);
  * `qlinear` on the card equals `qlinear` on the CPU for the same input
    (no activation flips: both divide tensor by tensor);
  * an fp8-stored forward equals the bf16 forward of the e4m3-rounded
    weights bit for bit, and a width `_int_mm` cannot take raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io import checkpoints as ck
from flexam_tpu_torch.models.dit import dit_forward, init_dit_params
from flexam_tpu_torch.ops import qlinear as Q
from flexam_tpu_torch.utils.fp8 import (FP8, cast_weights,
                                        convert_weights_to_fp8)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i8(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", [(4096, 3072, 14336), (1024, 3072, 3072),
                                   (17, 256, 64), (5, 256, 64), (1, 64, 8)])
def test_int_mm_accumulators_equal_cpu(dev, m, k, n):
    a, w = _i8((m, k), 0), _i8((n, k), 1)
    got = Q.int_mm(a.to(dev), w.to(dev))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), torch._int_mm(a, w.t()))


def test_int_mm_copies_no_operand(dev):
    a, w = _i8((23296, 3072), 2).to(dev), _i8((14336, 3072), 3).to(dev)
    Q.int_mm(a, w)                                   # warm-up (workspace)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = Q.int_mm(a, w)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise <= out.nbytes + (64 << 20), (rise, out.nbytes)


def _tie_heavy(rows, cols, seed):
    """Weights whose quotients by their row scale sit on .5 ties: integers
    plus a half, times amax / 127, with the row's amax present."""
    rs = np.random.RandomState(seed)
    amax = rs.uniform(0.01, 0.3, (rows, 1)).astype(np.float32)
    k = rs.randint(-126, 126, (rows, cols)).astype(np.float32) + 0.5
    w = (k * (amax / np.float32(127.0))).astype(np.float32)
    w[:, 0] = amax[:, 0]
    return w


@pytest.mark.parametrize("kind", ["normal_fp32", "normal_bf16", "ties"])
def test_weight_quantization_equals_numpy(dev, kind):
    rs = np.random.RandomState(4)
    if kind == "ties":
        w = torch.from_numpy(_tie_heavy(3072, 3072, 5))
    else:
        w = torch.from_numpy(rs.randn(3072, 3072).astype(np.float32) * 0.02)
        if kind == "normal_bf16":
            w = w.bfloat16()
    q_dev, s_dev = Q._quantize_weight(w.to(dev))
    q_host, s_host = Q._quantize_weight_host(w.float().numpy())
    assert np.array_equal(q_dev.cpu().numpy(), q_host)
    assert np.array_equal(s_dev.cpu().numpy().view(np.uint32),
                          s_host.view(np.uint32))
    via = Q.quantize_linear_params({"weight": w.to(dev)})
    assert via["weight_q"].is_cuda and via["w_scale"].dtype == torch.float32


@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_fp8_conversion_equals_cpu(dev, src):
    w = (torch.randn(1024, 3072, generator=torch.Generator().manual_seed(6))
         * 0.05).to(src)
    got = w.to(dev).to(FP8).cpu().view(torch.uint8)
    assert torch.equal(got, w.to(FP8).view(torch.uint8))


def test_qlinear_on_card_equals_cpu(dev):
    """The same bf16 input and int8 weights through qlinear on the card and
    on the CPU: the int8 activations agree (flips counted, 0 expected: both
    divide tensor by tensor) and so do the outputs."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 1000, 3072).astype(np.float32)).bfloat16()
    p = Q.quantize_linear_params({
        "weight": torch.from_numpy(rs.randn(3072, 3072).astype(np.float32)
                                   * 0.02),
        "bias": torch.from_numpy(rs.randn(3072).astype(np.float32))})
    pd = {k: v.to(dev) for k, v in p.items()}
    y_dev = Q.qlinear(x.to(dev), pd).cpu()
    y_cpu = Q.qlinear(x, p)

    def act(t):
        xf = t.reshape(-1, 3072).float()
        s = Q._div(torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-8),
                   127.0)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    flips = int((act(x.to(dev)).cpu() != act(x)).sum())
    assert flips == 0
    assert torch.equal(y_dev, y_cpu)


def test_qlinear_raises_on_unaligned_width(dev):
    p = Q.quantize_linear_params({"weight": torch.randn(24, 36, device=dev)})
    with pytest.raises(ValueError, match="multiples of 8"):
        Q.qlinear(torch.randn(40, 36, device=dev), p)


def _hd128_cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg.dit, dim=256, ffn_dim=512, num_heads=2)


def _inputs(cfg, dev):
    g = torch.Generator(device=dev).manual_seed(8)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).bfloat16()
    return dict(x=r(2, 8, 2, 4, 4), t=torch.full((2,), 500.0, device=dev),
                context=r(2, 16, cfg.text_dim), y=r(2, 20, 2, 4, 4),
                additional_control=r(2, 40, 2, 4, 4), full_ref=r(2, 8, 4, 4))


def test_fp8_forward_equals_bf16_of_rounded_weights(dev):
    cfg = _hd128_cfg()
    p = init_dit_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    p8 = convert_weights_to_fp8(p)
    assert p8["blocks"][0]["ffn"]["fc1"]["weight"].dtype == FP8
    inp = _inputs(cfg, dev)
    a = dit_forward(p8, cfg, inp.pop("x"), inp.pop("t"), inp.pop("context"),
                    **inp)
    inp = _inputs(cfg, dev)
    b = dit_forward(cast_weights(p8, torch.bfloat16), cfg, inp.pop("x"),
                    inp.pop("t"), inp.pop("context"), **inp)
    assert torch.equal(a, b)


def test_int8_forward_on_card_close_to_bf16(dev):
    """The HD128 DiT with int8 linears on the card, within JAX's relative
    0.02 of its bf16 forward (bf16 rounding adds to int8's error here)."""
    cfg = _hd128_cfg()
    p = init_dit_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    inp = _inputs(cfg, dev)
    ref = dit_forward(p, cfg, inp.pop("x"), inp.pop("t"), inp.pop("context"),
                      **inp).float()
    q = Q.convert_dit_to_int8(p)
    inp = _inputs(cfg, dev)
    got = dit_forward(q, cfg, inp.pop("x"), inp.pop("t"), inp.pop("context"),
                      **inp).float()
    rel = float((got - ref).norm() / ref.norm())
    assert rel < 0.02, rel


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_checkpoint_quantized_on_card_equals_cpu(dev, tmp_path, mode):
    """The loader quantizing while it loads gives the same tree on the card
    as on the CPU (the CPU path is held to JAX's in the CPU tests)."""
    cfg = _hd128_cfg()
    path = str(tmp_path / "model.safetensors")
    ck.save_safetensors(path, ck.dit_state_dict(init_dit_params(
        cfg, seed=1, dtype=torch.float32, device="cpu")))
    kw = dict(dtype=torch.float32, matrix_dtype=torch.bfloat16, quant=mode)
    on_card = ck.load_dit_checkpoint(path, cfg, device=dev, **kw)
    on_cpu = ck.load_dit_checkpoint(path, cfg, device="cpu", **kw)

    def leaves(t, pre=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{pre}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{pre}/{i}")
        else:
            yield pre, t
    a, b = dict(leaves(on_card)), dict(leaves(on_cpu))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].is_cuda and a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].cpu().view(torch.uint8)
                           if a[k].element_size() == 1 else a[k].cpu(),
                           b[k].view(torch.uint8)
                           if b[k].element_size() == 1 else b[k]), k
