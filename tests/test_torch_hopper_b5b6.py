"""B6's Hopper kernel on the CPU: the arithmetic its design rests on.

The kernel itself runs only on the card (`tests/test_torch_cuda.py` holds it
to its plain version at the edge cases). Here:
  * the int -> float conversion B6 uses in place of I2F is exact over the
    range of its int8 products;
  * B6's order of the dequantization, s * (ks * c) with the row scale qs
    applied in the softmax's FMA, gives the plain version's logits
    s * ((qs * ks) * c) to fp32 rounding, with quantization blocks that
    straddle the kernel's 128-row and 128-key tiles.
"""

import numpy as np
import pytest
import torch

from flexam_tpu_torch.ops import int8_attention as i8
from flexam_tpu_torch.testing import block_scaled


def test_magic_int_to_float_is_exact():
    """s + 0x4B400000, read as fp32, minus 1.5 * 2^23 is s for every s in
    the range of B6's products, |s| <= 127^2 * 128."""
    lim = 127 * 127 * 128
    s = np.arange(-lim, lim + 1, dtype=np.int32)
    f = (s + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
    assert lim < 2 ** 22
    np.testing.assert_array_equal(f, s.astype(np.float32))


def _rand(seed, *shape):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("b,lq,lk,phase", [
    (2, 200, 300, 0),
    (1, 130, 70, 1),
    (2, 64, 256, 0),
    (1, 1456, 1584, 1),
])
def test_b6_logit_order_within_fp32_rounding(b, lq, lk, phase):
    """Each side rounds three times (kernel: ks * c, s * that, and times qs
    on the edge tile or in the FFMA elsewhere; plain: qs * ks, times c,
    times s) and s is exact, so the two logits differ by at most
    (1 + 2^-24)^6 - 1 < 3 * 2^-23 of the plain one."""
    q = block_scaled(_rand(1, b, lq, 2, 128), i8.quant_block(lq), phase)
    k = block_scaled(_rand(2, b, lk, 2, 128), i8.quant_block(lk), 1 - phase)
    q8, qs, k8, ks = i8.quantize_qk(q, k)
    c = torch.tensor(i8._dequant_factor(None, 128), dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q8.double(), k8.double()).float()
    plain = s * ((qs[..., None] * ks[:, :, None, :]) * c)
    y = s * (ks * c)[:, :, None, :]
    in_ffma = y.double() * qs[..., None].double()          # one rounding
    edge = y * qs[..., None]                                # rounded first
    for kernel in (in_ffma, edge.double()):
        err = (kernel - plain.double()).abs()
        assert torch.all(err <= 3 * 2.0 ** -23 * plain.double().abs())
