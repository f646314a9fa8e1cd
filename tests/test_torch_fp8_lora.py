"""The port's float8 weight storage (`flexam_tpu_torch/utils/fp8.py`) and
LoRA (`flexam_tpu_torch/utils/lora.py`) against the JAX package's, on the
CPU: the fp8 and LoRA parts of `tests/test_dit.py:150` and
`tests/test_train.py:107`.

Tolerances:
  * e4m3 bytes equal JAX's exactly, converted from the same source dtype
    (float32 host trees, as JAX's checkpoint path; bf16 trees, as JAX's
    device trees);
  * the fp8-stored forward computes on the e4m3 values cast back, so the
    port holds JAX's at the suite's float32 tolerance (rtol 2e-4,
    atol 2e-5), and equals its own forward of `cast_weights`' tree;
  * LoRA merge and unmerge add a delta computed in numpy float32 on the
    host by both packages and added in float32: the merged weights equal
    JAX's to float32 rounding (rtol 1e-6, atol 1e-7), and unmerge restores
    the base to JAX's test tolerance (rtol 1e-5, atol 1e-6); `apply_lora`
    equals `merge_lora(lora_to_state_dict(...))` in both layouts at that
    tolerance, and JAX's `apply_lora` on the same factors at float32
    rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.models.dit import dit_forward as jdit_forward
from flexam_tpu.models.dit import init_dit_params as jinit_dit
from flexam_tpu.utils import fp8 as jfp8
from flexam_tpu.utils import lora as jlora
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models.dit import dit_forward as tdit_forward
from flexam_tpu_torch.ops.qlinear import convert_dit_to_int8
from flexam_tpu_torch.utils import fp8 as tfp8
from flexam_tpu_torch.utils import lora as tlora

LINEARS = [(g, n) for g, ns in (("self_attn", "qkvo"), ("cross_attn", "qkvo"),
                                ("ffn", ("fc1", "fc2"))) for n in ns]
F32 = dict(rtol=2e-4, atol=2e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: a, tree)


def _jax_dit(dtype=jnp.float32, seed=0):
    return _np_tree(jinit_dit(jax.random.PRNGKey(seed), jax_tiny().dit,
                              dtype=dtype))


def _same_bytes(port, jax_tree, layer=None):
    """Every leaf of a port tree against JAX's stacked tree: the same dtype
    and the same bytes."""
    if isinstance(port, dict):
        assert set(port) == set(jax_tree)
        for k, v in port.items():
            _same_bytes(v, jax_tree[k], layer)
        return
    if isinstance(port, list):
        for i, v in enumerate(port):
            _same_bytes(v, jax_tree, i)
        return
    j = np.asarray(jax_tree if layer is None else jax_tree[layer])
    assert str(port.dtype).replace("torch.", "") == str(j.dtype)
    a = port.contiguous().view(torch.uint8) if port.element_size() == 1 \
        else port
    b = j.view(np.uint8) if j.dtype.itemsize == 1 else j
    if port.dtype == torch.bfloat16:
        a, b = port.float().numpy(), j.astype(np.float32)
    np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_bytes_equal_jax(dtype):
    """convert_weights_to_fp8 on the port tree gives JAX's e4m3 bytes leaf
    for leaf, from float32 (JAX's host trees) and from bf16 (its device
    trees); the exclusions (modulation, norms, biases) stay as they were."""
    jp = _jax_dit(getattr(jnp, dtype))
    src = jp if dtype == "float32" else jax.tree_util.tree_map(
        jnp.asarray, jp)                  # JAX converts bf16 on the device
    j8 = _np_tree(jfp8.convert_weights_to_fp8(_copy(src)))
    t8 = tfp8.convert_weights_to_fp8(from_jax_params(jp, "cpu"))
    _same_bytes(t8, j8)
    b0 = t8["blocks"][0]
    assert b0["ffn"]["fc1"]["weight"].dtype == tfp8.FP8
    assert t8["patch_embedding"]["weight"].dtype == tfp8.FP8
    assert b0["modulation"].dtype == torch.float32
    assert b0["self_attn"]["norm_q"].dtype == getattr(torch, dtype)
    assert b0["ffn"]["fc1"]["bias"].dtype == getattr(torch, dtype)


def _inputs(cfg, b=2):
    rs = np.random.RandomState(3)
    return dict(x=rs.randn(b, 8, 2, 4, 4).astype(np.float32),
                t=np.full((b,), 500.0, np.float32),
                context=rs.randn(b, 4, cfg.text_dim).astype(np.float32),
                y=rs.randn(b, 20, 2, 4, 4).astype(np.float32),
                additional_control=rs.randn(b, 40, 2, 4, 4).astype(
                    np.float32),
                full_ref=rs.randn(b, 8, 4, 4).astype(np.float32))


def test_fp8_forward_matches_jax():
    """The fp8-stored DiT forward (float32 compute) against JAX's forward of
    `cast_weights(p8, float32)`; the port runs the stored tree directly and
    through its own `cast_weights`, with the same result."""
    jcfg = jax_tiny().dit
    jp = _jax_dit()
    j8 = jfp8.convert_weights_to_fp8(_copy(jp))
    t8 = tfp8.convert_weights_to_fp8(from_jax_params(jp, "cpu"))
    inp = _inputs(jcfg)
    kw = ("y", "additional_control", "full_ref")
    ref = np.asarray(jdit_forward(
        jfp8.cast_weights(j8, jnp.float32), jcfg, inp["x"], inp["t"],
        inp["context"], **{k: jnp.asarray(inp[k]) for k in kw}))
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    cfg = tiny_test_config().dit
    got = tdit_forward(t8, cfg, tin["x"], tin["t"], tin["context"],
                       **{k: tin[k] for k in kw}).numpy()
    cast = tfp8.cast_weights(t8, torch.float32)
    assert cast["blocks"][0]["ffn"]["fc1"]["weight"].dtype == torch.float32
    assert t8["blocks"][0]["ffn"]["fc1"]["weight"].dtype == tfp8.FP8
    got_cast = tdit_forward(cast, cfg, tin["x"], tin["t"], tin["context"],
                            **{k: tin[k] for k in kw}).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **F32)
    np.testing.assert_array_equal(got, got_cast)
    full = tdit_forward(from_jax_params(jp, "cpu"), cfg, tin["x"], tin["t"],
                        tin["context"], **{k: tin[k] for k in kw}).numpy()
    assert np.abs(got - full).max() > 1e-4        # e4m3 really was used


def _lora_sd(rng):
    return {
        "lora_unet_blocks_1_self_attn_q.lora_down.weight":
            rng.randn(2, 96).astype(np.float32),
        "lora_unet_blocks_1_self_attn_q.lora_up.weight":
            rng.randn(96, 2).astype(np.float32),
        "lora_unet_blocks_1_self_attn_q.alpha": np.float32(2.0),
        "lora_unet_blocks_0_cross_attn_v.lora_down.weight":
            rng.randn(4, 96).astype(np.float32),
        "lora_unet_blocks_0_cross_attn_v.lora_up.weight":
            rng.randn(96, 4).astype(np.float32),
        "blocks.0.ffn.0.lora_A.weight": rng.randn(2, 96).astype(np.float32),
        "blocks.0.ffn.0.lora_B.weight": rng.randn(256, 2).astype(np.float32),
        "blocks.1.ffn.2.lora_A.weight": rng.randn(3, 256).astype(np.float32),
        "blocks.1.ffn.2.lora_B.weight": rng.randn(96, 3).astype(np.float32),
        "blocks.1.ffn.2.alpha": np.float32(1.5),
        "unrelated.lora_A.weight": rng.randn(2, 4).astype(np.float32),
        "unrelated.lora_B.weight": rng.randn(4, 2).astype(np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_merge_unmerge_matches_jax(dtype):
    """Kohya and diffusers keys with and without alpha, merged at 0.7 and
    unmerged, against JAX's merge of the same state dict; the input tree is
    not changed, and untouched blocks are the same objects."""
    jp = _jax_dit(getattr(jnp, dtype))
    sd = _lora_sd(np.random.RandomState(0))
    jm = _np_tree(jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, jp),
                                   sd, multiplier=0.7))
    tp = from_jax_params(jp, "cpu")
    before = tp["blocks"][1]["self_attn"]["q"]["weight"].clone()
    tm = tlora.merge_lora(tp, sd, multiplier=0.7)
    tol = (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
           else dict(rtol=0, atol=0))
    for l, bp in enumerate(tm["blocks"]):
        for g, n in LINEARS:
            np.testing.assert_allclose(
                bp[g][n]["weight"].float().numpy(),
                np.asarray(jm["blocks"][g][n]["weight"][l], np.float32),
                **tol, err_msg=f"{l} {g}.{n}")
    assert torch.equal(tp["blocks"][1]["self_attn"]["q"]["weight"], before)
    assert not torch.equal(tm["blocks"][1]["self_attn"]["q"]["weight"],
                           before)
    assert tm["blocks"][0]["self_attn"] is tp["blocks"][0]["self_attn"]
    restored = tlora.unmerge_lora(tm, sd, multiplier=0.7)
    if dtype == "float32":
        for g, n in (("self_attn", "q"), ("ffn", "fc1")):
            for l in range(2):
                np.testing.assert_allclose(
                    restored["blocks"][l][g][n]["weight"].numpy(),
                    tp["blocks"][l][g][n]["weight"].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_lora_into_int8_raises_and_fp8_merges():
    """A LoRA merged into an int8 tree raises (merge first, then
    quantize); into an fp8-stored tree it merges as JAX's does (cast up,
    add in float32, cast back to e4m3), byte for byte."""
    jp = _jax_dit()
    sd = _lora_sd(np.random.RandomState(1))
    q = convert_dit_to_int8(from_jax_params(jp, "cpu"))
    with pytest.raises(ValueError, match="merge the LoRA into the float"):
        tlora.merge_lora(q, sd)
    j8 = jfp8.convert_weights_to_fp8(_copy(jp))
    jm = _np_tree(jlora.merge_lora(jax.tree_util.tree_map(jnp.asarray, j8),
                                   sd))
    tm = tlora.merge_lora(tfp8.convert_weights_to_fp8(
        from_jax_params(jp, "cpu")), sd)
    _same_bytes(tm["blocks"], jm["blocks"])


def _jax_lora_factors(jp):
    lora = jlora.init_lora_params(jax.random.PRNGKey(7), jp, rank=2)
    # non-zero B so that the delta is not trivial
    lora["blocks"] = jax.tree_util.tree_map(lambda a: a + 0.1,
                                            lora["blocks"])
    return lora


def _port_factors(jlora_tree):
    """JAX's stacked factors as the port's per-block list."""
    blocks = from_jax_params({"blocks": _np_tree(jlora_tree["blocks"])},
                             "cpu")["blocks"]
    return {"blocks": blocks, "rank": jlora_tree["rank"],
            "alpha": jlora_tree["alpha"]}


@pytest.mark.parametrize("layout", ["kohya", "diffusers"])
def test_lora_export_merge_equivalence(layout):
    """apply_lora(base, lora) == merge_lora(base, lora_to_state_dict(lora))
    in the port, in both layouts; the export equals JAX's key for key, and
    the port's apply_lora equals JAX's on the same factors."""
    jp = _jax_dit()
    jl = _jax_lora_factors(jp)
    tl = _port_factors(jl)
    tp = from_jax_params(jp, "cpu")
    direct = tlora.apply_lora(tp, tl)
    sd = tlora.lora_to_state_dict(tl, layout=layout)
    jsd = jlora.lora_to_state_dict(jl, layout=layout)
    assert set(sd) == set(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    merged = tlora.merge_lora(tp, sd)
    jdirect = _np_tree(jlora.apply_lora(jp, jl))
    for l in range(len(tp["blocks"])):
        for g, n in LINEARS:
            w = direct["blocks"][l][g][n]["weight"].numpy()
            np.testing.assert_allclose(
                w, merged["blocks"][l][g][n]["weight"].numpy(),
                rtol=1e-5, atol=1e-6, err_msg=f"{layout} {g}.{n}")
            np.testing.assert_allclose(
                w, jdirect["blocks"][g][n]["weight"][l], rtol=1e-6,
                atol=1e-7)


def test_init_lora_params_and_train_grads():
    """init_lora_params: A normal / rank, B zero, so apply_lora starts at
    the base exactly; the delta is differentiable through the factors."""
    tp = from_jax_params(_jax_dit(), "cpu")
    gen = torch.Generator().manual_seed(0)
    lora = tlora.init_lora_params(gen, tp, rank=2)
    assert lora["rank"] == 2 and lora["alpha"] == 2.0
    ab = lora["blocks"][1]["ffn"]["fc2"]
    assert tuple(ab["a"].shape) == (2, 256) and tuple(ab["b"].shape) == (96, 2)
    assert float(ab["b"].abs().sum()) == 0.0 and float(ab["a"].std()) > 0
    eff = tlora.apply_lora(tp, lora)
    assert torch.equal(eff["blocks"][0]["self_attn"]["q"]["weight"],
                       tp["blocks"][0]["self_attn"]["q"]["weight"])
    b = lora["blocks"][0]["self_attn"]["q"]["b"].requires_grad_(True)
    eff = tlora.apply_lora(tp, lora, multiplier=0.5)
    eff["blocks"][0]["self_attn"]["q"]["weight"].sum().backward()
    assert b.grad is not None and float(b.grad.abs().sum()) > 0
