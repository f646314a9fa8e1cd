"""The port's checkpoint loaders against the JAX package's, on the CPU.

State dicts are made from random JAX trees (the repo holds no weights): the
JAX tree goes through `from_jax_params` and the port's inverse maps
(`dit_state_dict`, `vae_state_dict`, `t5_state_dict`) to reference-named
tensors, which both packages then map. The port's tree must equal
`from_jax_params` of JAX's, leaf for leaf, in value and dtype. Files are
written here with torch, `safetensors` and JAX's `save_pytree`, and read by
the port's own readers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexam_tpu import config as jcfg
from flexam_tpu.io import checkpoints as jck
from flexam_tpu.io import verify_load as jvl
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import t5 as jt5
from flexam_tpu.models import vae as jvae
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch.io import checkpoints as tck
from flexam_tpu_torch.io import verify_load as tvl
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import t5 as tt5

CFG = jcfg.tiny_test_config()
TCFG = tcfg.tiny_test_config()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return from_jax_params(_np(tree), device="cpu")


def _sd_numpy(sd):
    """Reference-named torch tensors -> numpy (bf16 as ml_dtypes)."""
    out = {}
    for k, v in sd.items():
        if v.dtype == torch.bfloat16:
            out[k] = v.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            out[k] = v.numpy().copy()
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert torch.equal(g[k], w[k]), k


def _demo_cast(tree):
    """The JAX demo's cast of a float32-loaded DiT (`demo.py:175-186`)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(ml_dtypes.bfloat16)
        if a.dtype == np.float32 and a.ndim >= 2 else a, _np(tree))


@pytest.fixture(scope="module")
def trees():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    return {"dit": jdit.init_dit_params(k1, CFG.dit, dtype=jnp.float32),
            "vae": jvae.init_vae_params(k2, CFG.vae),
            "t5": jt5.init_t5_params(k3, CFG.t5)}


# ---------------------------------------------------------------------------
# Mappings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cast", [False, True], ids=["float32", "demo_cast"])
def test_dit_mapping_matches_jax(trees, cast):
    sd = _sd_numpy(tck.dit_state_dict(_port(trees["dit"])))
    jtree = jck.dit_params_from_state_dict(sd, CFG.dit)
    _assert_same_tree(_port(jtree), _port(trees["dit"]))   # inverse is exact
    got = tck.dit_params_from_state_dict(
        sd, TCFG.dit, device="cpu",
        matrix_dtype=torch.bfloat16 if cast else None)
    want = from_jax_params(_demo_cast(jtree) if cast else _np(jtree),
                           device="cpu")
    _assert_same_tree(got, want)
    if cast:   # the rule of the JAX demo's cast on the stacked tree
        assert got["blocks"][0]["self_attn"]["q"]["bias"].dtype == torch.bfloat16
        assert got["blocks"][0]["modulation"].dtype == torch.bfloat16
        assert got["patch_embedding"]["bias"].dtype == torch.float32


def test_dit_channel_pad_and_optional_heads(trees):
    """A checkpoint with fewer input channels is zero-padded; `ref_conv` and
    `cnn` are mapped only when the checkpoint has them."""
    sd = _sd_numpy(tck.dit_state_dict(_port(trees["dit"])))
    sd["patch_embedding.weight"] = sd["patch_embedding.weight"][:, :20]
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("ref_conv", "cnn_conv"))}
    jtree = jck.dit_params_from_state_dict(sd, CFG.dit)
    got = tck.dit_params_from_state_dict(sd, TCFG.dit, device="cpu")
    _assert_same_tree(got, _port(jtree))
    assert got["patch_embedding"]["weight"].shape[1] == CFG.dit.in_dim
    assert not got["patch_embedding"]["weight"][:, 20:].any()
    assert "ref_conv" not in got and "cnn" not in got


@pytest.mark.parametrize("prefix", ["", "model."])
def test_vae_checkpoint_matches_jax(trees, tmp_path, prefix):
    """A `.pth` VAE (raw keys, or `model.`-prefixed as the reference saves
    them), loaded by both packages."""
    sd = tck.vae_state_dict(_port(trees["vae"]), TCFG.vae)
    path = str(tmp_path / "vae.pth")
    torch.save({prefix + k: v.to(torch.bfloat16) for k, v in sd.items()},
               path)
    jtree = jck.load_vae_checkpoint(path, CFG.vae)
    got = tck.load_vae_checkpoint(path, TCFG.vae, device="cpu")
    _assert_same_tree(got, _port(jtree))
    assert got["encoder"]["conv1"]["weight"].dtype == torch.float32
    # and the in-memory mapping of a numpy dict keeps the dtypes it is given
    sd16 = {k: v.numpy().astype(np.float16) for k, v in sd.items()}
    _assert_same_tree(tck.vae_params_from_state_dict(sd16, TCFG.vae, "cpu"),
                      _port(jck.vae_params_from_state_dict(sd16, CFG.vae)))


def _hf_t5_state_dict(params, shared_pos):
    sd = {"shared.weight": params["token_embedding"],
          "encoder.final_layer_norm.weight": params["norm"]}
    for i, bp in enumerate(params["blocks"]):
        p = f"encoder.block.{i}.layer"
        sd[f"{p}.0.layer_norm.weight"] = bp["norm1"]
        for n in ("q", "k", "v", "o"):
            sd[f"{p}.0.SelfAttention.{n}.weight"] = bp["attn"][n]
        sd[f"{p}.1.layer_norm.weight"] = bp["norm2"]
        sd[f"{p}.1.DenseReluDense.wi_0.weight"] = bp["ffn"]["gate"]
        sd[f"{p}.1.DenseReluDense.wi_1.weight"] = bp["ffn"]["fc1"]
        sd[f"{p}.1.DenseReluDense.wo.weight"] = bp["ffn"]["fc2"]
    if shared_pos:
        sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
           "weight"] = params["blocks"][0]["pos_embedding"]
    return sd


def test_t5_checkpoint_matches_jax(trees, tmp_path):
    sd = tck.t5_state_dict(_port(trees["t5"]))
    path = str(tmp_path / "t5.pth")
    torch.save({"state_dict": {k: v.to(torch.bfloat16) for k, v in sd.items()}},
               path)
    jtree = jck.load_t5_checkpoint(path, CFG.t5)
    got = tck.load_t5_checkpoint(path, TCFG.t5, device="cpu")
    _assert_same_tree(got, _port(jtree))
    sdn = {k: v.numpy() for k, v in sd.items()}
    _assert_same_tree(tt5.t5_params_from_state_dict(sdn, TCFG.t5,
                                                    torch.bfloat16, "cpu"),
                      _port(jt5.t5_params_from_state_dict(
                          sdn, CFG.t5, ml_dtypes.bfloat16)))


@pytest.mark.parametrize("shared_pos", [False, True])
def test_t5_hf_layout_matches_jax(trees, shared_pos):
    sd = {k: v.numpy() for k, v in
          _hf_t5_state_dict(_port(trees["t5"]), shared_pos).items()}
    jc = dataclasses.replace(CFG.t5, shared_pos=shared_pos)
    tc = dataclasses.replace(TCFG.t5, shared_pos=shared_pos)
    got = tt5.t5_params_from_hf_state_dict(sd, tc, device="cpu")
    _assert_same_tree(got, _port(jt5.t5_params_from_hf_state_dict(sd, jc)))
    assert ("shared_pos_embedding" in got) == shared_pos


# ---------------------------------------------------------------------------
# File formats
# ---------------------------------------------------------------------------

def _mixed_tensors(seed, bf16, f8=False):
    g = torch.Generator().manual_seed(seed)
    ts = {"a.weight": torch.randn(5, 7, generator=g),
          "a.bias": torch.randn(7, generator=g).to(torch.float16),
          "b.idx": torch.arange(6, dtype=torch.int64).reshape(2, 3),
          "c.mask": torch.tensor([True, False, True]),
          "d.scalar": torch.tensor(2.5),
          "e.empty": torch.zeros(0, 4)}
    if bf16:
        ts["f.bf16"] = torch.randn(3, 9, generator=g).to(torch.bfloat16)
    if f8:
        ts["g.f8"] = torch.randn(4, generator=g).to(torch.float8_e4m3fn)
    return ts


@pytest.mark.parametrize("bf16,f8", [(False, False), (True, False),
                                     (True, True)],
                         ids=["native", "with_bf16", "with_f8"])
def test_safetensors_reader_matches_library(tmp_path, bf16, f8):
    """The port's reader against `safetensors` on a file the library wrote,
    and the library on a file the port wrote; `_load_one` gives JAX's
    values and dtypes (bf16 kept, every tensor float32 once the file holds
    float8, which numpy cannot hold)."""
    from safetensors.torch import load_file, save_file
    ts = _mixed_tensors(1, bf16, f8)
    lib_path, port_path = str(tmp_path / "lib.safetensors"), str(
        tmp_path / "port.safetensors")
    save_file(ts, lib_path, metadata={"format": "pt"})
    tck.save_safetensors(port_path, ts, metadata={"format": "pt"})
    for path in (lib_path, port_path):
        sd = tck.read_safetensors(path)
        assert sorted(sd) == sorted(ts)
        for k, v in ts.items():
            assert sd.native(k).dtype == v.dtype
            assert torch.equal(sd.native(k), v), k
        for k, v in load_file(path).items():
            assert torch.equal(sd.native(k), v), k
        jsd, tsd = jck._load_one(path), tck._load_one(path)
        for k in ts:
            want, got = np.asarray(jsd[k]), tsd[k]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), k
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32), err_msg=k)


def test_safetensors_multi_shard_dit(trees, tmp_path):
    """A DiT in two bf16 shards, read as a directory by both packages and
    mapped with the demo's cast."""
    sd = {k: v.to(torch.bfloat16)
          for k, v in tck.dit_state_dict(_port(trees["dit"])).items()}
    keys = sorted(sd)
    half = len(keys) // 2
    for i, part in enumerate((keys[:half], keys[half:])):
        tck.save_safetensors(str(tmp_path / f"model-{i:05d}.safetensors"),
                             {k: sd[k] for k in part})
    (tmp_path / "config.json").write_text("{}")
    merged = tck.load_safetensors_dir(str(tmp_path))
    assert sorted(merged) == keys
    jtree = jck.load_dit_checkpoint(str(tmp_path), CFG.dit)
    got = tck.load_dit_checkpoint(str(tmp_path), TCFG.dit, device="cpu",
                                  matrix_dtype=torch.bfloat16)
    _assert_same_tree(got, from_jax_params(_demo_cast(jtree), device="cpu"))
    with pytest.raises(FileNotFoundError):
        tck.load_safetensors_dir(str(tmp_path / "missing_dir_is_a_file"))


@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_with_and_without_state_dict(tmp_path, wrapped):
    ts = _mixed_tensors(2, True)
    path = str(tmp_path / "w.pth")
    torch.save({"state_dict": ts} if wrapped else ts, path)
    jsd, tsd = jck._load_one(path), tck._load_one(path)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        assert tsd[k].dtype == torch.float32
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k], err_msg=k)


def test_save_pytree_files_from_jax(tmp_path):
    """JAX's save_pytree (bf16 and fp8 leaves, list nodes) read by the port,
    and the port's file read by JAX."""
    rng = np.random.RandomState(3)
    tree = {"w": rng.randn(4, 3).astype(np.float32),
            "bf": jnp.asarray(rng.randn(5), jnp.bfloat16),
            "f8": jnp.asarray(rng.randn(2, 2), jnp.float8_e4m3fn),
            "q": rng.randint(-128, 127, (3, 3)).astype(np.int8),
            "layers": [{"a": rng.randn(2).astype(np.float32)},
                       {"a": rng.randn(2).astype(np.float32)}]}
    path = str(tmp_path / "tree.npz")
    jck.save_pytree(path, tree)
    flat = tck.load_pytree_state_dict(path)
    jflat = jck.load_pytree_state_dict(path)
    assert sorted(flat) == sorted(jflat)
    assert flat["bf"].dtype == torch.bfloat16
    assert flat["f8"].dtype == torch.float8_e4m3fn
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    nested = tck.restore_pytree_nested(path)
    assert isinstance(nested["layers"], list) and len(nested["layers"]) == 2
    like = tck.restore_pytree(path, nested)
    _assert_same_tree(like, nested)

    back = str(tmp_path / "port.npz")
    tck.save_pytree(back, nested)
    jback = jck.restore_pytree_nested(back)
    for (k, a), (k2, b) in zip(_leaves(nested), _leaves(jback)):
        assert k == k2
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), err_msg=k)
    assert str(jback["bf"].dtype) == "bfloat16"


# ---------------------------------------------------------------------------
# verify_load: the cases of tests/test_ckpt_verify.py, on both packages
# ---------------------------------------------------------------------------

def _report(loaded, missed, unused=()):
    return {"loaded": list(loaded), "missed": list(missed),
            "unused": list(unused)}


REPORTS = {
    "groups_by_module": (_report(
        loaded=["['enc']['conv1']['weight']", "['enc']['conv1']['bias']",
                "['dec']['conv']['weight']"],
        missed=["['dec']['conv']['bias']", "['head']['w']"],
        unused=["spare.tensor"]), 1),
    "scan_stacked_index": (_report(
        loaded=["['blocks'][0]['q']", "['blocks'][1]['q']"],
        missed=["['blocks'][0]['k']"]), 2),
    "empty_module": (_report(loaded=["['a']['w']"] * 9,
                             missed=["['b']['w']"]), 2),
    "strict": (_report(loaded=["['a']['w']"], missed=["['a']['b']"] * 9), 2),
    "partial_module": (_report(loaded=["['enc']['w']"],
                               missed=["['enc']['b']"]), 2),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_verify_load_matches_jax(case, capsys):
    rep, depth = REPORTS[case]
    got, want = (tvl.summarize_mapping(rep, depth=depth),
                 jvl.summarize_mapping(rep, depth=depth))
    assert got == want
    assert (tvl.format_mapping_report("x", got)
            == jvl.format_mapping_report("x", want))
    assert tvl.mapping_coverage(rep) == jvl.mapping_coverage(rep)
    ok = tvl.check_mapping(rep, threshold=0.9, quiet=False, depth=depth)
    out = capsys.readouterr().out
    assert ok == jvl.check_mapping(rep, threshold=0.9, quiet=False,
                                   depth=depth)
    assert out == capsys.readouterr().out
    if case == "empty_module":
        assert not ok and "NO loaded tensors" in out
    if case == "strict":
        with pytest.raises(ValueError, match="coverage"):
            tvl.check_mapping(rep, strict=True, quiet=True)
    if case == "partial_module":
        txt = tvl.format_mapping_report("x", got)
        assert "50.0%" in txt and "!" in txt
    if case == "groups_by_module":
        assert got["n_loaded"] == 3 and got["n_total"] == 5
        assert abs(got["overall"] - 0.6) < 1e-9
    if case == "scan_stacked_index":
        assert set(got["modules"]) == {"blocks/q", "blocks/k"}
