"""The B3/B4 wrappers' argument checks, on the CPU.

`ops/fused.py` checks what the row kernels take (`rmsnorm_rope_args`,
`ln_modulation_args`) before a launch: a CUDA tensor that fails a check
raises, with no launch and no fallback. The checks look only at shapes,
dtypes, strides and addresses, so they run here on CPU tensors; the
kernels themselves are held to their plain versions on the card
(`tests/test_torch_cuda.py`).
"""

import re

import pytest
import torch

from flexam_tpu_torch.ops import build, fused


def _x(d=384, s=4, dtype=torch.bfloat16):
    return torch.zeros((2, s, d), dtype=dtype)


def _off(shape, dtype, elements=1):
    """A contiguous tensor of `shape` whose data starts `elements` past an
    allocation's (16-byte aligned) start."""
    n = 1
    for k in shape:
        n *= k
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


def test_max_features_matches_the_kernels():
    """MAX_FEATURES is the widest row the kernels are instantiated for:
    kMaxRowVectors 16-byte vectors a lane, 32 lanes, 8 bf16 a vector."""
    src = (build.CSRC / "common.cuh").read_text()
    most = int(re.search(r"kMaxRowVectors = (\d+)", src).group(1))
    listed = re.search(r"#define FLEXAM_ROW_VECTORS\(X\) (.*)", src).group(1)
    assert max(int(n) for n in re.findall(r"X\((\d+)\)", listed)) == most
    assert most * 32 * 8 == fused.MAX_FEATURES


def test_max_features_f32_matches_the_kernels():
    """The fp32 instances take the same widest row: their largest vector
    count a thread, kRowThreads threads, 4 fp32 a vector."""
    src = (build.CSRC / "common.cuh").read_text()
    threads = int(re.search(r"kRowThreads = (\d+)", src).group(1))
    listed = re.search(r"#define FLEXAM_ROW_VECTORS_F32\(X\) (.*)",
                       src).group(1)
    most = max(int(n) for n in re.findall(r"X\((\d+)\)", listed))
    assert most * threads * 4 == fused.MAX_FEATURES


def test_ln_modulation_args_pass_strided_views():
    """The main path's scale, a view of the [B, 2, 6, D] modulation tensor,
    reaches the kernel as it is: no copy, its own strides."""
    mod = torch.randn((2, 2, 6, 384))
    got = fused.ln_modulation_args(_x(), mod[:, :, 0], mod[:, :, 1],
                                   torch.ones((2, 4)))
    sh, sh_b, sh_r, sc, sc_b, sc_r, m = got
    assert sc.data_ptr() == mod[:, :, 1].data_ptr()
    assert (sh_b, sh_r, sc_b, sc_r) == (2 * 6 * 384, 6 * 384) * 2
    assert m.dtype == torch.float32 and m.is_contiguous()


def test_ln_modulation_args_broadcast_mode():
    mod = torch.randn((2, 1, 6, 384))
    sh, sh_b, sh_r, sc, sc_b, sc_r, m = fused.ln_modulation_args(
        _x(), mod[:, 0, 0], mod[:, 0, 1], None)
    assert (sh_b, sh_r, sc_b, sc_r) == (6 * 384, 0, 6 * 384, 0)
    assert m is None and sh.data_ptr() == mod[:, 0, 0].data_ptr()


@pytest.mark.parametrize("layout", ["bf16", "columns strided"])
def test_ln_modulation_args_copy_other_layouts(layout):
    """Terms the kernel cannot read as they are (another dtype, a last dim
    that is not contiguous) become contiguous fp32 copies."""
    t = torch.randn((2, 2, 384))
    t = t.bfloat16() if layout == "bf16" else \
        torch.randn((2, 2, 768))[:, :, ::2]
    sh, sh_b, sh_r, *_ = fused.ln_modulation_args(_x(), t, t,
                                                  torch.ones((2, 4)))
    assert sh.dtype == torch.float32 and sh.is_contiguous()
    assert (sh_b, sh_r) == (2 * 384, 384)
    assert torch.equal(sh, t.float())


@pytest.mark.parametrize("case,error", [
    ("x float16", TypeError),
    ("x not contiguous", ValueError),
    ("width 100", ValueError),
    ("width 8200", ValueError),
    ("x off 16 bytes", ValueError),
    ("terms [B, D] in binary mode", ValueError),
    ("mask [B, S + 1]", ValueError),
])
def test_ln_modulation_args_refuse(case, error):
    d = {"width 100": 100, "width 8200": 8200}.get(case, 384)
    x = {"x float16": _x(d, dtype=torch.float16),
         "x not contiguous": _x(2 * d)[:, :, ::2],
         "x off 16 bytes": _off((2, 4, d), torch.bfloat16)}.get(case, _x(d))
    terms = torch.zeros((2, d) if "terms" in case else (2, 2, d))
    mask = torch.ones((2, 5) if "mask" in case else (2, 4))
    with pytest.raises(error):
        fused.ln_modulation_args(x, terms, terms, mask)


@pytest.mark.parametrize("case", ["head_dim 12", "gamma [D + 1]",
                                  "table [L, dh]", "table off 16 bytes",
                                  "gamma off 16 bytes", "x off 16 bytes",
                                  "width 8320"])
def test_rmsnorm_rope_args_refuse(case):
    d = 8320 if case == "width 8320" else 384
    heads = 32 if case == "head_dim 12" else d // 128
    dh = d // heads
    x = _off((2, 4, d), torch.bfloat16) if case == "x off 16 bytes" \
        else _x(d)
    gamma = {"gamma [D + 1]": torch.ones(d + 1),
             "gamma off 16 bytes": _off((d,), torch.bfloat16)}.get(
        case, torch.ones(d))
    table = {"table [L, dh]": torch.zeros((4, dh)),
             "table off 16 bytes": _off((4, dh // 2), torch.float32)}.get(
        case, torch.zeros((4, dh // 2)))
    with pytest.raises(ValueError):
        fused.rmsnorm_rope_args(x, gamma, table, table, heads)


@pytest.mark.parametrize("kernel", ["rmsnorm_rope", "ln_modulation"])
def test_row_kernel_args_take_fp32(kernel):
    """fp32 x passes both wrappers' checks (the fp32 instances): B3's
    gamma takes x's dtype, B4's terms stay fp32 views."""
    x = _x(3072, dtype=torch.float32)
    if kernel == "rmsnorm_rope":
        g, c, _, dh = fused.rmsnorm_rope_args(
            x, torch.ones(3072, dtype=torch.bfloat16), torch.zeros((7, 64)),
            torch.zeros((7, 64)), 24)
        assert dh == 128 and g.dtype == torch.float32
        assert c.dtype == torch.float32
    else:
        mod = torch.randn((2, 2, 6, 3072))
        sh, _, _, sc, _, _, m = fused.ln_modulation_args(
            x, mod[:, :, 0], mod[:, :, 1], torch.ones((2, 4)))
        assert sc.data_ptr() == mod[:, :, 1].data_ptr()
        assert sh.dtype == torch.float32 and m.dtype == torch.float32


def test_rmsnorm_rope_args_take_the_flagship_layout():
    g, c, s, dh = fused.rmsnorm_rope_args(
        _x(3072), torch.ones(3072), torch.zeros((7, 64)),
        torch.zeros((7, 64)), 24)
    assert dh == 128 and g.dtype == torch.bfloat16
    assert c.shape == (7, 64) and c.dtype == torch.float32
