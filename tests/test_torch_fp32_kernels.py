"""fp32 through B1-B6 (the port's kernels take fp32 as JAX's Pallas kernels
do), on the CPU.

On the card B1, B2 and B5 run fp32 on TF32 wgmma, B6 its P.V on TF32 wgmma
beside its int8 Q K^T, and B3/B4 fp32 instances of their row kernels; here
each wrapper takes its plain version, which a CPU tensor takes. What a CPU
run can hold:

  * the dtype rule, as pure functions: which kernel instance each (head
    dim, dtype) runs and what is refused (fp16, mixed dtypes);
  * the fp32 bounds `chip_smoke.py` and the card tests hold the kernels to
    (`flexam_tpu_torch/testing.py`): the TF32 arithmetic the kernels do,
    emulated here, passes them, and the same arithmetic in bf16 fails;
    fp32 row results whose sums run in another order pass, bf16-rounded
    ones fail;
  * the slice as a whole: a tiny `generate(compute_dtype=torch.float32)`
    with a DiT of two 128-wide heads (the kernel path) and a forward of the
    same DiT, against the JAX package with all of its Pallas B1-B4 in
    interpret mode (FLEXAM_FUSED=interpret, FLEXAM_ATTENTION=pallas).
    `tests/test_torch_models.py::test_dit_forward_kernel_path` holds the
    same forward with JAX's attention on its `xla` branch.

Inputs are made from numpy seeds; fp32 is held at rtol 2e-4 / atol 2e-5,
the generate at `test_generate_matches_jax`'s 1e-4 and one uint8 step.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.core.attention as JA
from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.models import dit as jdit
from flexam_tpu.models.t5 import init_t5_params
from flexam_tpu.models.vae import init_vae_params
import flexam_tpu_torch.core.attention as TA
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import dit as tdit
from flexam_tpu_torch.ops import fused as TU
from flexam_tpu_torch.ops import int8_attention as T8
from flexam_tpu_torch.ops import launch_counts
from flexam_tpu_torch.ops import sparse_attention as TS
from flexam_tpu_torch.testing import (block_scaled, check_attention_tf32,
                                      check_int8_attention_tf32,
                                      check_ln_modulation_f32,
                                      check_rmsnorm_rope_f32,
                                      check_sparse_attention_tf32)

JF = importlib.import_module("flexam_tpu.ops.flash_attention")
TF = importlib.import_module("flexam_tpu_torch.ops.flash_attention")

F32 = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops beside the other test workers: one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The dtype rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,dtype,want", [
    (128, torch.bfloat16, "d128"), (256, torch.bfloat16, "d256"),
    (384, torch.bfloat16, "wide"), (128, torch.float32, "f32_d128"),
    (256, torch.float32, "f32_wide"), (384, torch.float32, "f32_wide")])
def test_attention_instance(d, dtype, want):
    """Each (head dim, dtype) the kernels take names its instance; bf16
    keeps `head_dim_instance`'s names."""
    assert TF.attention_instance(d, dtype) == want
    if dtype == torch.bfloat16:
        assert TF.head_dim_instance(d) == want


@pytest.mark.parametrize("d,dtype,error", [
    (128, torch.float16, TypeError), (128, torch.float64, TypeError),
    (64, torch.float32, ValueError), (200, torch.bfloat16, ValueError)])
def test_attention_instance_refuses(d, dtype, error):
    """fp16 and float64 are no dtype of the kernels (no path of the JAX
    package makes fp16 activations); head dims that are not a multiple of
    128 go to the exact branch before any kernel."""
    with pytest.raises(error):
        TF.attention_instance(d, dtype)


@pytest.mark.parametrize("module,name,dtype,ok", [
    (TF, "flash_attention", torch.float32, True),
    (TF, "flash_attention", torch.bfloat16, True),
    (TF, "flash_attention", torch.float16, False),
    (T8, "int8_attention", torch.float32, True),
    (TS, "sparse_attention", torch.float32, True),
    (T8, "int8_attention", torch.bfloat16, True),
    (T8, "int8_attention", torch.float16, False),
    (TS, "sparse_attention", torch.float16, False)])
def test_kernel_dtype_rule(module, name, dtype, ok):
    """The dtypes each wrapper passes to `check_inputs`: B1, B2, B5 and B6
    take bf16 and fp32, and refuse fp16; mixed dtypes are refused too."""
    t = torch.zeros(1, 2, 1, 128, dtype=dtype)
    if ok:
        TF.check_dtype(module.DTYPES, name, t, t, t)
        with pytest.raises(TypeError):
            TF.check_dtype(module.DTYPES, name, t, t.double(), t)
    else:
        with pytest.raises(TypeError, match="takes bfloat16 or float32"):
            TF.check_dtype(module.DTYPES, name, t, t, t)


# ---------------------------------------------------------------------------
# The fp32 bounds discriminate
# ---------------------------------------------------------------------------

def _tf32(t):
    """t rounded to tf32, to nearest with ties away from zero (the
    kernels' cvt.rna), as fp32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulated_attention(q, k, v, k_len, rnd, keep=None):
    """B1's arithmetic on the card with operands rounded by `rnd`: q, k and
    v rounded (the pre-pass), exact products summed (fp64 here), the
    unnormalized probabilities rounded before P.V and summed unrounded.
    `keep` [Lq, Lk], if given, masks keys as B5's block lists do."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", rnd(q).double(),
                     rnd(k).double()) * scale
    if k_len is not None:
        keep_k = torch.arange(k.shape[1])[None, :] < k_len[:, None]
        s = s.masked_fill(~keep_k[:, None, None, :], -1e30)
    if keep is not None:
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", rnd(p.float()).double(),
                     rnd(v).double())
    return (o / p.sum(-1).permute(0, 2, 1)[..., None]).float()


@pytest.mark.parametrize("arith", ["tf32", "bf16"])
@pytest.mark.parametrize("lk,k_len", [(700, None), (300, [300, 77])])
def test_attention_tf32_bound(arith, lk, k_len):
    """The TF32 arithmetic passes `check_attention_tf32` against the exact
    fp32 plain version at 700 keys and at a ragged k_len; the same
    arithmetic with bf16 operands fails it."""
    rs = np.random.RandomState(lk)
    q, k, v = (torch.from_numpy(rs.randn(2, n, 2, 128).astype(np.float32))
               for n in (300, lk, lk))
    kl = None if k_len is None else torch.tensor(k_len)
    ref = TF.attention_plain(q, k, v, k_len=kl)
    got = _emulated_attention(q, k, v, kl, _tf32 if arith == "tf32"
                              else _bf16)
    if arith == "tf32":
        check_attention_tf32(got, ref, "emulated TF32")
    else:
        with pytest.raises(AssertionError):
            check_attention_tf32(got, ref, "bf16 operands")


@pytest.mark.parametrize("arith", ["tf32", "bf16"])
@pytest.mark.parametrize("frames,window,spatial", [(6, 1, 40), (3, 1, 8),
                                                   (5, 2, 72)])
def test_sparse_attention_tf32_bound(arith, frames, window, spatial):
    """B5's TF32 arithmetic over each query block's key blocks (blocks of
    40, 8 and 72 tokens, ragged nnz, the ref block's full row) passes
    `check_sparse_attention_tf32` against the exact fp32
    `masked_dense_attention`; with bf16 operands it fails."""
    pol = TS.video_sparse_policy(frames, spatial, ref_tokens=spatial,
                                 window=window)
    rows, blk, n = pol["rows"], pol["blk"], pol["video_len"]
    rs = np.random.RandomState(frames * 100 + spatial)
    q, k, v = (torch.from_numpy(rs.randn(2, n, 2, 128).astype(np.float32))
               for _ in range(3))
    ref = TS.masked_dense_attention(q, k, v, rows, blk)
    tok = torch.arange(n) // blk
    keep = torch.from_numpy(TS.rows_to_block_mask(rows))[tok][:, tok]
    got = _emulated_attention(q, k, v, None,
                              _tf32 if arith == "tf32" else _bf16, keep)
    if arith == "tf32":
        check_sparse_attention_tf32(got, ref, "emulated B5 TF32")
    else:
        with pytest.raises(AssertionError):
            check_sparse_attention_tf32(got, ref, "B5 bf16 operands")


def _emulated_int8(q, k, v, k_len, rnd):
    """B6-f32's arithmetic on the card: the wrapper's int8 q, k and scales,
    exact int32 products, each logit dequantized in the kernel's order
    (s * (ks * c), then times the row's scale, in fp32), the unnormalized
    probabilities and v rounded by `rnd` before P.V (fp64 sums here)."""
    q8, qs, k8, ks = T8.quantize_qk(q, k)
    c = torch.tensor(T8._dequant_factor(None, q.shape[-1]),
                     dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q8.double(), k8.double()).float()
    s = (s * (ks * c)[:, :, None, :]) * qs[..., None]
    if k_len is not None:
        keep = torch.arange(k.shape[1])[None, :] < k_len[:, None]
        s = s.masked_fill(~keep[:, None, None, :], -1e30)
    s = s.double()
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", rnd(p.float()).double(),
                     rnd(v).double())
    return (o / p.sum(-1).permute(0, 2, 1)[..., None]).float()


@pytest.mark.parametrize("arith", ["tf32", "bf16"])
@pytest.mark.parametrize("lq,lk,k_len", [(300, 1584, None),
                                         (700, 2000, [2000, 777])])
def test_int8_attention_tf32_bound(arith, lq, lk, k_len):
    """B6's fp32 arithmetic (int8 Q K^T, its dequantization order, TF32
    P.V) on block-scaled q and k (`testing.block_scaled`: sizes 4x apart
    from one quantization block to the next) passes
    `check_int8_attention_tf32` against the exact fp32
    `int8_attention_plain`, with and without k_len; with P and v in bf16
    it fails."""
    rs = np.random.RandomState(lq + lk)
    q, k, v = (torch.from_numpy(rs.randn(2, n, 2, 128).astype(np.float32))
               for n in (lq, lk, lk))
    q = block_scaled(q, T8.quant_block(lq))
    k = block_scaled(k, T8.quant_block(lk), phase=1)
    kl = None if k_len is None else torch.tensor(k_len)
    ref = T8.int8_attention_plain(q, k, v, k_len=kl)
    got = _emulated_int8(q, k, v, kl, _tf32 if arith == "tf32" else _bf16)
    if arith == "tf32":
        check_int8_attention_tf32(got, ref, "emulated B6 TF32")
    else:
        with pytest.raises(AssertionError):
            check_int8_attention_tf32(got, ref, "B6 bf16 P and v")


def _rows(seed, b=2, s=40, d=3072):
    """x [b, s, d] fp32 whose rows have their own offset and scale, as DiT
    hidden states have."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy((rs.randn(b, s, d) * np.exp(0.5 * rs.randn(
        b, s, 1)) + 4.0 * rs.randn(b, s, 1)).astype(np.float32))


def _sum_reordered(t):
    """The last dim's fp32 sum in another order than torch's: 96 strided
    partial sums, then those in sequence."""
    parts = t.unflatten(-1, (-1, 96)).sum(-2)
    acc = torch.zeros(t.shape[:-1])
    for i in range(parts.shape[-1]):
        acc = acc + parts[..., i]
    return acc[..., None]


@pytest.mark.parametrize("arith", ["reordered", "bf16"])
@pytest.mark.parametrize("kernel", ["rmsnorm_rope", "ln_modulation"])
def test_row_kernel_f32_bounds(kernel, arith):
    """B3 and B4 in fp32 with the row sums in another order pass their fp32
    bounds; the plain output rounded to bf16 fails them."""
    x = _rows(3)
    d = x.shape[-1]
    rs = np.random.RandomState(4)
    if kernel == "rmsnorm_rope":
        gamma = torch.from_numpy(1.0 + 0.1 * rs.randn(d).astype(np.float32))
        ang = torch.from_numpy(rs.rand(40, 64).astype(np.float32) * 6.0)
        cos, sin = ang.cos(), ang.sin()
        ref = TU.rmsnorm_rope_plain(x, gamma, cos, sin, d // 128)
        inv = torch.rsqrt(_sum_reordered(x * x) / d + 1e-6)
        y = ((x * inv) * gamma).reshape(*x.shape[:2], d // 128, 128)
        from flexam_tpu_torch.core.rope import apply_rope
        got = apply_rope(y, cos, sin)

        def check(g):
            return check_rmsnorm_rope_f32(g, ref, "B3 f32")
    else:
        sh = torch.from_numpy(rs.randn(2, 2, d).astype(np.float32))
        sc = torch.from_numpy(rs.randn(2, 2, d).astype(np.float32))
        mask = torch.from_numpy((rs.rand(2, 40) > 0.5).astype(np.float32))
        ref = TU.ln_modulation_plain(x, sh, sc, mask=mask)
        mean = _sum_reordered(x) / d
        var = _sum_reordered((x - mean) ** 2) / d
        ln = (x - mean) * torch.rsqrt(var + 1e-6)
        m = mask[:, :, None]
        got = (ln * (1.0 + (m * sc[:, 0:1] + (1.0 - m) * sc[:, 1:2]))
               + (m * sh[:, 0:1] + (1.0 - m) * sh[:, 1:2]))

        def check(g):
            return check_ln_modulation_f32(g, ref, x, sh, sc, mask,
                                           "B4 f32")
    assert not torch.equal(got, ref)       # the order did change a sum
    if arith == "reordered":
        check(got)
    else:
        with pytest.raises(AssertionError):
            check(_bf16(ref))


# ---------------------------------------------------------------------------
# The slice as a whole, against JAX's Pallas B1-B4 in interpret mode
# ---------------------------------------------------------------------------

# a DiT of two heads of 128, so the kernel path runs (B1, B2, B3, B4)
DIT_128 = dict(dim=256, ffn_dim=256, num_heads=2, num_layers=1)


@pytest.fixture
def jax_pallas(monkeypatch):
    """JAX's Pallas B1-B4 in interpret mode, the port's dispatch at the
    same backend; both dispatchers' cached choices cleared around it."""
    monkeypatch.setenv("FLEXAM_FUSED", "interpret")
    monkeypatch.setenv("FLEXAM_ATTENTION", "pallas")
    monkeypatch.setattr(JF, "flash_attention", functools.partial(
        JF.flash_attention, interpret=True))
    JA._backend_choice.cache_clear()
    TA._default_backend.cache_clear()
    yield
    monkeypatch.undo()
    JA._backend_choice.cache_clear()
    TA._default_backend.cache_clear()


def _configs():
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    return (dataclasses.replace(jc, dit=dataclasses.replace(jc.dit,
                                                            **DIT_128)),
            dataclasses.replace(tc, dit=dataclasses.replace(tc.dit,
                                                            **DIT_128)))


def _port(params):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")


def test_generate_f32_matches_jax_pallas(jax_pallas):
    """`generate(compute_dtype=torch.float32)` with the kernel-path DiT (2
    CFG steps, a mask with frame 0 known) against JAX's generate with its
    Pallas B1-B4 in interpret mode: latents at 1e-4, the uint8 video to
    one step. The port takes the kernels (their plain versions here),
    never the exact branch."""
    jc, tc = _configs()
    assert tdit.use_kernels(tc.dit.head_dim) and tc.dit.head_dim == 128
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    params = (jdit.init_dit_params(k1, jc.dit, dtype=jnp.float32),
              init_vae_params(k2, jc.vae), init_t5_params(k3, jc.t5))
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jc, dit_params=params[0],
                           vae_params=params[1], t5_params=params[2]),
        compute_dtype=jnp.float32)
    conv = [_port(p) for p in params]
    pipe = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tc, dit_params=conv[0], vae_params=conv[1],
                           t5_params=conv[2]),
        device="cpu", compute_dtype=torch.float32)
    rng = np.random.RandomState(11)
    t, h, w = 5, 32, 32
    video = rng.rand(1, 3, t, h, w).astype(np.float32)
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    ctrl = rng.rand(1, 3, t, h, w).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                         (1, 8, 2, 2, 2), jnp.float32))
    kw = dict(mask_video=mask, control_video=ctrl, num_inference_steps=2,
              guidance_scale=6.0, density=0.3)
    jax_lat = jp.generate(video, "a cat", seed=5, output_type="latent", **kw)
    calls = TA.exact_calls["exact_attention"]
    before = launch_counts()
    lat = pipe.generate(video, "a cat", output_type="latent", latents=noise,
                        **kw)
    assert lat.dtype == np.float32
    np.testing.assert_allclose(lat, jax_lat, rtol=1e-4, atol=1e-4)
    jax_video = np.asarray(jp._decode_u8_host(jnp.asarray(jax_lat))
                           ).transpose(0, 4, 1, 2, 3).astype(np.float32) / 255.0
    video_out = pipe.generate(video, "a cat", latents=noise, **kw)
    assert TA.exact_calls["exact_attention"] == calls
    assert launch_counts() == before       # CPU tensors launch nothing
    assert video_out.shape == (1, 3, t, h, w)
    assert np.isfinite(video_out).all()
    np.testing.assert_allclose(video_out, jax_video, rtol=0, atol=1.01 / 255)


@pytest.mark.parametrize("binary", [False, True])
def test_dit_forward_f32_matches_jax_pallas(binary, jax_pallas):
    """The kernel-path DiT forward in fp32 (B1 self-attention, B2 over the
    text keys, B3, and B4 in its binary or broadcast mode) against JAX's
    `dit_forward` with every Pallas kernel in interpret mode."""
    kw = dict(DIT_128, in_dim=8, out_dim=4, text_dim=32, text_len=6,
              freq_dim=32, add_ref_conv=False, add_cnn_block=False,
              num_layers=2)
    jc, tc = jcfg.DiTConfig(**kw), tcfg.DiTConfig(**kw)
    params = jdit.init_dit_params(jax.random.PRNGKey(0), jc, dtype=jnp.float32)
    rs = np.random.RandomState(6)
    x = rs.randn(1, 4, 2, 4, 4).astype(np.float32)
    inputs = dict(t=np.asarray([500.0], np.float32),
                  context=rs.randn(1, 6, 32).astype(np.float32),
                  y=rs.randn(1, 4, 2, 4, 4).astype(np.float32),
                  density=np.asarray([0.1], np.float32))
    mask = (rs.rand(1, 2 * 2 * 2) > 0.5).astype(np.float32) if binary \
        else None
    ref = jdit.dit_forward(params, jc, jnp.asarray(x),
                           **{k: jnp.asarray(a) for k, a in inputs.items()},
                           binary_t_mask=None if mask is None
                           else jnp.asarray(mask))
    calls = TA.exact_calls["exact_attention"]
    got = tdit.dit_forward(
        _port(params), tc, torch.from_numpy(x),
        **{k: torch.from_numpy(a) for k, a in inputs.items()},
        binary_t_mask=None if mask is None else torch.from_numpy(mask))
    assert TA.exact_calls["exact_attention"] == calls
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
