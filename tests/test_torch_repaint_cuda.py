"""The FLUX repaint and DepthCrafter slice on the card: B1 at FLUX's
joint-attention shapes against its plain version, the tiny repainter and
the tiny DepthCrafter denoiser against the same models on the CPU (fp32,
TF32 off), and the exact branch chunked by bytes against one chunk.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_repaint_cuda.py

The bounds are `chip_smoke.py`'s (its docstring gives the reasons): B1
per element as `testing.check_attention`; the tiny FLUX velocity within
1e-4 of its largest value and the repainted image within one uint8 level;
the tiny denoiser within 1e-4 of its [0, 1] output; the chunked exact
branch within 1e-5 of its largest value.
"""

import importlib

import numpy as np
import pytest
import torch

from flexam_tpu_torch import repaint_flux as rf
from flexam_tpu_torch.perception import depthcrafter_model as tm
from flexam_tpu_torch.testing import check_attention

pytestmark = pytest.mark.cuda
fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("tokens", [2304, 2072, 577])
def test_b1_at_flux_shapes(dev, tokens):
    """512x896 (1,792 + 512 tokens), 480x832 (ragged) and a short one."""
    g = torch.Generator(device=dev).manual_seed(tokens)
    q, k, v = (torch.randn((1, tokens, 24, 128), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = fa.launches["flash_attention"]
    got = fa.flash_attention(q, k, v)
    assert fa.launches["flash_attention"] == before + 1
    check_attention(got, fa.attention_plain(q, k, v), f"B1 {tokens}")


def test_tiny_repainter_card_vs_cpu(dev):
    cpu = rf.make_tiny_repainter(seed=3, device="cpu")
    card = rf.FluxDepthRepainter(_to(cpu.params, dev),
                                 _to(cpu.vae_params, dev), cfg=cpu.cfg,
                                 vae_cfg=cpu.vae_cfg, dtype=torch.float32,
                                 device=dev)
    yy, xx = np.mgrid[:40, :56].astype(np.float32)
    depth = np.sin(xx / 5.0) + yy / 40.0
    lat = torch.randn((1, 4, 16, 24),
                      generator=torch.Generator().manual_seed(4)).numpy()
    a = cpu("a red house", depth, 32, 48, 4, latents=lat)
    b = card("a red house", depth, 32, 48, 4, latents=lat)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_tiny_denoiser_card_vs_cpu(dev):
    cpu = tm.make_tiny_denoiser(seed=5, device="cpu")
    card = tm.DepthCrafterDenoiser(_to(cpu.params, dev),
                                   _to(cpu.vae_params, dev), cfg=cpu.cfg,
                                   vae_cfg=cpu.vae_cfg, dtype=torch.float32,
                                   device=dev)
    g = torch.Generator().manual_seed(6)
    f = torch.rand((3, 32, 48, 3), generator=g).numpy()
    lat = torch.randn((1, 3, 4, 16, 24), generator=g)
    aug = torch.randn((3, 3, 32, 48), generator=g)
    a = cpu(f, num_inference_steps=2, latents=lat, aug_noise=aug)
    b = card(f, num_inference_steps=2, latents=lat, aug_noise=aug)
    assert np.abs(a - b).max() <= 1e-4


def test_exact_branch_chunked_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((6, 1024, 5, 64), generator=g, device=dev)
               for _ in range(3))
    whole = fa.attention_plain(q, k, v, budget=1 << 40)
    row = 4 * 5 * 1024
    for budget in (10 * 6 * row, 2 * row):
        got = fa.attention_plain(q, k, v, budget=budget)
        assert (got - whole).abs().max() <= 1e-5 * whole.abs().max()
