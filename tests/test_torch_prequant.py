"""Prequantized checkpoints (`flexam_tpu_torch/tools/prequant_ckpt.py` and
`io.checkpoints.restore_pytree_nested`) against the JAX package's, on the
CPU: the five cases of `tests/test_prequant.py`, then files crossing both
ways (JAX writes and the port reads; the port writes and JAX reads) and a
checkpoint quantized while it loads against JAX's quantize-then-cast of its
float32 tree.

Every comparison is exact: the files hold int8 weights, float32 scales and
bf16 / e4m3 leaves, which both packages must produce and read bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.io import checkpoints as jck
from flexam_tpu.models.dit import init_dit_params as jinit_dit
from flexam_tpu.tools import prequant_ckpt as jpre
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io import checkpoints as tck
from flexam_tpu_torch.io.convert import (from_jax_params, stack_blocks,
                                         tree_leaves)
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.ops.qlinear import convert_dit_to_int8, is_quantized
from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels
from flexam_tpu_torch.tools import prequant_ckpt as tpre
from flexam_tpu_torch.utils.fp8 import FP8


def _port_tiny_dit(seed=0):
    return init_dit_params(tiny_test_config().dit, seed=seed,
                           dtype=torch.float32, device="cpu")


def _jax_tiny_dit():
    return jax.tree_util.tree_map(
        np.asarray, jinit_dit(jax.random.PRNGKey(0), jax_tiny().dit,
                              jnp.float32))


def _leaves(tree):
    return tree_leaves(tree)


def _bytes(t):
    if torch.is_tensor(t):
        return t.contiguous().view(torch.uint8).numpy().tobytes() \
            if t.dtype in (FP8, torch.bfloat16) else t.numpy().tobytes()
    return np.ascontiguousarray(t).view(np.uint8).tobytes()


def _same_flat(a: dict, b: dict):
    """Two flat '/'-path dicts (the port's tensors, JAX's numpy arrays):
    the same keys, dtypes, shapes and bytes."""
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        ta, nb = a[k], np.asarray(b[k])
        assert str(ta.dtype).replace("torch.", "") == str(nb.dtype), k
        assert tuple(ta.shape) == nb.shape, k
        assert _bytes(ta) == _bytes(nb), k


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_prequant_roundtrip(tmp_path, mode):
    """prequantize + the bf16 cast, saved and restored without a like-tree:
    every leaf comes back with its dtype and bytes, in the port's layout."""
    q = tpre._cast_wide_to_bf16(tpre.prequantize(_port_tiny_dit(), mode))
    path = str(tmp_path / f"dit_{mode}.npz")
    tck.save_pytree(path, stack_blocks(q))
    back = from_jax_params(tck.restore_pytree_nested(path), "cpu")
    assert is_quantized(back) == (mode == "int8")
    lq, lb = _leaves(q), _leaves(back)
    assert len(lq) == len(lb)
    for a, b in zip(lq, lb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bytes(a) == _bytes(b)
    if mode == "fp8":
        assert back["blocks"][0]["ffn"]["fc1"]["weight"].dtype == FP8
    assert back["blocks"][1]["modulation"].dtype == torch.bfloat16
    assert back["patch_embedding"]["bias"].dtype == torch.float32


def test_prequant_cli_and_pipeline_serve(tmp_path):
    """The CLI writes the npz; the pipeline serves it with the conversion
    skipped, and the tree equals quantize-at-load bit for bit."""
    path = str(tmp_path / "tiny_int8.npz")
    assert tpre.main(["--checkpoint", "random:tiny", "--mode", "int8",
                      "--out", path]) == 0
    dit = from_jax_params(tck.restore_pytree_nested(path), "cpu")
    assert is_quantized(dit)
    cfg = tiny_test_config()
    models = FlexAMModels(cfg=cfg, dit_params=dit, vae_params=init_vae_params(
        cfg.vae, seed=1, dtype=torch.float32, device="cpu"))
    pipe = FlexAMGenerationPipeline(models, device="cpu", quant="int8",
                                    compute_dtype=torch.float32)
    blk = pipe.models.dit_params["blocks"][0]["self_attn"]["q"]
    assert blk["weight_q"].dtype == torch.int8
    ref = convert_dit_to_int8(_port_tiny_dit())
    for l, bp in enumerate(ref["blocks"]):
        for g in ("self_attn", "cross_attn"):
            for n in "qkvo":
                assert torch.equal(
                    pipe.models.dit_params["blocks"][l][g][n]["weight_q"],
                    bp[g][n]["weight_q"])


def test_demo_prequant_flag(tmp_path):
    """`--prequant` swaps the DiT for the prequantized tree and infers the
    quant mode (int8 and fp8); an unquantized npz refuses."""
    from flexam_tpu_torch.demo import _build_models, build_argparser

    base = ["--prompt", "x", "--random_init", "tiny", "--platform", "cpu"]
    for mode in ("int8", "fp8"):
        path = str(tmp_path / f"tiny_{mode}.npz")
        tpre.main(["--checkpoint", "random:tiny", "--mode", mode,
                   "--out", path])
        pipe = _build_models(build_argparser().parse_args(
            base + ["--prequant", path]))
        assert pipe.quant == mode
        assert pipe.compute_dtype == torch.float32
        w = pipe.models.dit_params["blocks"][1]["ffn"]["fc2"]
        assert (w["weight_q"].dtype == torch.int8 if mode == "int8"
                else w["weight"].dtype == FP8)
    bad = str(tmp_path / "plain.npz")
    tck.save_pytree(bad, stack_blocks(_port_tiny_dit()))
    with pytest.raises(ValueError, match="quantized"):
        _build_models(build_argparser().parse_args(base + ["--prequant",
                                                           bad]))


def test_demo_prequant_serve_bundle(tmp_path):
    """A serve bundle (vae/ + dit/) through --prequant: the DiT arrives
    quantized and the pipeline's VAE is the bundle's (stored bf16, float32
    on the device), not a random one."""
    from flexam_tpu_torch.demo import _build_models, build_argparser

    vae = init_vae_params(tiny_test_config().vae, seed=7,
                          dtype=torch.bfloat16, device="cpu")
    path = str(tmp_path / "bundle.npz")
    tck.save_pytree(path, {"vae": vae, "dit": stack_blocks(
        convert_dit_to_int8(_port_tiny_dit()))})
    pipe = _build_models(build_argparser().parse_args(
        ["--prompt", "x", "--random_init", "tiny", "--platform", "cpu",
         "--prequant", path]))
    assert is_quantized(pipe.models.dit_params)
    got, ref = _leaves(pipe.models.vae_params), _leaves(vae)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.float())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_jax_file_reads_in_port(tmp_path, mode):
    """A file JAX's prequant_ckpt writes restores in the port with JAX's
    dtypes and bytes, leaf for leaf, and serves through the port's
    pipeline."""
    path = str(tmp_path / f"jax_{mode}.npz")
    assert jpre.main(["--checkpoint", "random:tiny", "--mode", mode,
                      "--out", path]) == 0
    port = tck.load_pytree_state_dict(path)
    _same_flat(port, jck.load_pytree_state_dict(path))
    dit = from_jax_params(tck.restore_pytree_nested(path), "cpu")
    jtree = jck.restore_pytree_nested(path)
    for l, bp in enumerate(dit["blocks"]):
        w = bp["ffn"]["fc1"]["weight_q" if mode == "int8" else "weight"]
        assert _bytes(w) == _bytes(
            jtree["blocks"]["ffn"]["fc1"]["weight_q" if mode == "int8"
                                          else "weight"][l])
    cfg = tiny_test_config()
    pipe = FlexAMGenerationPipeline(
        FlexAMModels(cfg=cfg, dit_params=dit, vae_params=init_vae_params(
            cfg.vae, seed=1, dtype=torch.float32, device="cpu")),
        device="cpu", quant=mode, compute_dtype=torch.float32)
    assert pipe.models.dit_params["blocks"][0]["ffn"]["fc1"]["bias"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_port_file_reads_in_jax(tmp_path, mode):
    """The port's prequantize of JAX's float32 tree, written by the port,
    restores in JAX equal byte for byte to JAX's own prequantize of the
    same tree."""
    jtree = _jax_tiny_dit()
    ref = jpre._cast_wide_to_bf16(jpre.prequantize(
        jax.tree_util.tree_map(lambda a: a, jtree), mode))
    got = tpre._cast_wide_to_bf16(tpre.prequantize(
        from_jax_params(jtree, "cpu"), mode))
    path = str(tmp_path / f"port_{mode}.npz")
    tck.save_pytree(path, stack_blocks(got))
    flat_back, flat_ref = _flat(jck.restore_pytree_nested(path)), _flat(ref)
    assert set(flat_back) == set(flat_ref)
    for k, v in flat_ref.items():
        assert str(flat_back[k].dtype) == str(np.asarray(v).dtype), k
        assert _bytes(flat_back[k]) == _bytes(v), k


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, f"{prefix}/{k}" if prefix else k).items()}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_checkpoint_quantized_while_loading(tmp_path, monkeypatch, mode):
    """`prequant_ckpt --checkpoint FILE` quantizes each weight from its
    float32 values as it loads and casts the rest as it loads; the file
    equals JAX's prequant_ckpt of the same checkpoint (which quantizes its
    whole float32 tree, then casts) byte for byte."""
    import flexam_tpu.config as jcfg_mod

    ckpt = str(tmp_path / "model.safetensors")
    tck.save_safetensors(ckpt, tck.dit_state_dict(
        from_jax_params(_jax_tiny_dit(), "cpu")))
    monkeypatch.setattr(tcfg, "WAN22_5B_FLEXAM", tiny_test_config())
    monkeypatch.setattr(jcfg_mod, "WAN22_5B_FLEXAM", jax_tiny())
    out_t, out_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert tpre.main(["--checkpoint", ckpt, "--mode", mode,
                      "--out", out_t]) == 0
    assert jpre.main(["--checkpoint", ckpt, "--mode", mode,
                      "--out", out_j]) == 0
    _same_flat(tck.load_pytree_state_dict(out_t),
               jck.load_pytree_state_dict(out_j))
