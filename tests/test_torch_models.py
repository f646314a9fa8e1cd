"""The port's model modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed; every weight comes from the JAX
init through `flexam_tpu_torch.io.convert.from_jax_params`. fp32 is held at
the suite's rtol 2e-4 / atol 1e-5 unless a test states another bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import config as jcfg
from flexam_tpu.core import layers as jl
from flexam_tpu.core import rope as jrope
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import t5 as jt5
from flexam_tpu.models import vae as jvae
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch.core import layers as tl
from flexam_tpu_torch.core import rope as trope
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit
from flexam_tpu_torch.models import t5 as tt5
from flexam_tpu_torch.models import vae as tvae

F32 = dict(rtol=2e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(params):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")


def test_layers():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 32).astype(np.float32)
    w = rs.randn(32).astype(np.float32)
    bias = rs.randn(32).astype(np.float32)
    lw = rs.randn(8, 32).astype(np.float32)
    pairs = [
        (jl.rms_norm(x, w), tl.rms_norm(_t(x), _t(w))),
        (jl.layer_norm(x), tl.layer_norm(_t(x))),
        (jl.layer_norm(x, w, bias), tl.layer_norm(_t(x), _t(w), _t(bias))),
        (jl.gelu_tanh(jnp.asarray(x)), tl.gelu_tanh(_t(x))),
        (jl.silu(jnp.asarray(x)), tl.silu(_t(x))),
        (jl.linear(x, {"weight": lw, "bias": bias[:8]}),
         tl.linear(_t(x), {"weight": _t(lw), "bias": _t(bias[:8])})),
    ]
    pos = np.asarray([0.0, 1.0, 37.0, 999.0], np.float32)
    pairs.append((jl.sinusoidal_embedding_1d(64, jnp.asarray(pos)),
                  tl.sinusoidal_embedding_1d(64, _t(pos))))
    # group norm: the JAX op is channels-last, the port's channels-first
    g = rs.randn(2, 4, 3, 5, 16).astype(np.float32)
    gw, gb = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    pairs.append((jl.group_norm(g, gw, gb, 4),
                  tl.group_norm(_t(g).permute(0, 4, 1, 2, 3), _t(gw), _t(gb), 4)
                  .permute(0, 2, 3, 4, 1)))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    # bf16 gelu keeps the JAX cast points (constants rounded to bf16)
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_allclose(
        tl.gelu_tanh(_t(x).to(torch.bfloat16)).float().numpy(),
        np.asarray(jl.gelu_tanh(xb), np.float32), rtol=8e-3, atol=8e-3)


def test_rope_tables_and_apply():
    np.testing.assert_array_equal(trope.make_rope_tables(128, 64),
                                  jrope.make_rope_tables(128, 64))
    tab = jrope.make_rope_tables(24, 16)
    jc, js = jrope.build_video_rope(jnp.asarray(tab), (2, 3, 4), 24)
    tc, ts = trope.build_video_rope(_t(tab), (2, 3, 4), 24)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    x = np.random.RandomState(1).randn(2, 30, 3, 24).astype(np.float32)
    ref = jrope.apply_rope(jnp.asarray(x), jc, js)    # 24 rotated, 6 not
    got = trope.apply_rope(_t(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_t5_encode():
    cfg = jcfg.tiny_test_config().t5
    params = jt5.init_t5_params(jax.random.PRNGKey(0), cfg)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    ref = jt5.t5_encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask))
    got = tt5.t5_encode(_port(params), tcfg.tiny_test_config().t5, _t(ids),
                        _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    np.testing.assert_array_equal(
        tt5.relative_position_buckets(40, 40, 32),
        jt5.relative_position_buckets(40, 40, 32))


@pytest.fixture(scope="module")
def vae_params():
    cfg = jcfg.tiny_test_config().vae
    return jvae.init_vae_params(jax.random.PRNGKey(1), cfg)


def test_vae_encode(vae_params):
    cfg = jcfg.tiny_test_config().vae
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, 9, 32, 32)) \
        .astype(np.float32)
    mu_j, lv_j = jvae.vae_encode(vae_params, cfg, jnp.asarray(x))
    mu_t, lv_t = tvae.vae_encode(_port(vae_params),
                                 tcfg.tiny_test_config().vae, _t(x))
    assert mu_t.shape == (2, 8, 3, 2, 2)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **F32)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), **F32)


def test_vae_decode(vae_params):
    cfg = jcfg.tiny_test_config().vae
    # the JAX init zeroes the attention projection; give it weights so the
    # attention block is exercised
    params = jax.tree_util.tree_map(lambda a: a, vae_params)
    rs = np.random.RandomState(4)
    proj = params["decoder"]["middle"][1]["proj"]
    proj["weight"] = jnp.asarray(
        rs.randn(*proj["weight"].shape).astype(np.float32) * 0.05)
    z = rs.randn(1, 8, 3, 2, 3).astype(np.float32)
    ref = jvae.vae_decode(params, cfg, jnp.asarray(z))
    got = tvae.vae_decode(_port(params), tcfg.tiny_test_config().vae, _t(z))
    assert got.shape == (1, 3, 9, 32, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def _dit_inputs(cfg, seed, b=2, f=3, h=8, w=8, extras=True):
    rs = np.random.RandomState(seed)
    c = cfg.out_dim
    x = rs.randn(b, c if extras else cfg.in_dim, f, h, w).astype(np.float32)
    kw = dict(t=np.asarray([500.0, 300.0][:b], np.float32),
              context=rs.randn(b, cfg.text_len, cfg.text_dim).astype(np.float32),
              density=np.asarray([0.1, 0.2][:b], np.float32))
    if extras:
        kw["y"] = rs.randn(b, cfg.in_dim - c, f, h, w).astype(np.float32)
        kw["additional_control"] = rs.randn(
            b, cfg.in_dim_cnn_block - c, f, h, w).astype(np.float32)
        kw["full_ref"] = rs.randn(b, c, h, w).astype(np.float32)
    mask = (rs.rand(b, f * (h // 2) * (w // 2)) > 0.5).astype(np.float32)
    return x, kw, mask


def _dit_pair(jcfg_dit, tcfg_dit, params, x, kw, mask):
    ref = jdit.dit_forward(params, jcfg_dit, jnp.asarray(x),
                           **{k: jnp.asarray(v) for k, v in kw.items()},
                           binary_t_mask=None if mask is None
                           else jnp.asarray(mask))
    got = tdit.dit_forward(_port(params), tcfg_dit, _t(x),
                           **{k: _t(v) for k, v in kw.items()},
                           binary_t_mask=None if mask is None else _t(mask))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("binary", [False, True])
def test_dit_forward_tiny(binary):
    """tiny_test_config (head_dim 24): the unfused path, with the CNN
    control fusion, the ref-token prepend and the density embeds."""
    jc, tc = jcfg.tiny_test_config().dit, tcfg.tiny_test_config().dit
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    x, kw, mask = _dit_inputs(jc, 5)
    ref, got = _dit_pair(jc, tc, params, x, kw, mask if binary else None)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("binary", [False, True])
def test_dit_forward_kernel_path(binary, monkeypatch):
    """head_dim 128: the kernel path (B3 for q/k, B4 for the prologues),
    with the JAX side running its Pallas kernels in interpret mode."""
    monkeypatch.setenv("FLEXAM_FUSED", "interpret")
    kw = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2, in_dim=8,
              out_dim=4, text_dim=32, text_len=6, freq_dim=32,
              add_ref_conv=False, add_cnn_block=False)
    jc, tc = jcfg.DiTConfig(**kw), tcfg.DiTConfig(**kw)
    assert tdit.use_kernels(tc.head_dim)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    x, inputs, mask = _dit_inputs(jc, 6, b=1, f=2, h=4, w=4, extras=False)
    ref, got = _dit_pair(jc, tc, params, x, inputs, mask if binary else None)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
