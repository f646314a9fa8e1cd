"""The port's Wan2.1 VAE (`flexam_tpu_torch/models/vae21.py`) and
XLM-RoBERTa (`models/clip.py`) against the JAX package's, on the CPU in
fp32 at small widths. The random trees come from the port's inits, which
hold JAX's shapes (checked against `jax.eval_shape` of JAX's `init_*`:
JAX's own init compiles for seconds), with every leaf moved off the
init's zeros and ones, as numpy trees that JAX takes as they are and the
port through `from_jax_params`. Held at rtol 2e-4 / atol 1e-5 of the
output's largest value; JAX's forwards are jitted once. JAX's own tests
of these (`tests/test_{vae21,clip}.py`) read the reference checkout.

The state-dict mapper reads a state dict in the reference's names, written
from the tree (`vae21_state_dict`), back to the same tree, leaf for leaf,
and to the same tree as JAX's `vae21_params_from_state_dict`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.models import clip as JC
from flexam_tpu.models import vae21 as JV
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import clip as TC
from flexam_tpu_torch.models import vae21 as TV

VCFG = dict(dim=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
            temporal_downsample=(False, True, True))
XCFG = dict(vocab_size=50, max_seq_len=24, pad_id=1, dim=32, num_heads=2,
            num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, seed):
    """Every float leaf moved by N(0, 0.05) (the init's zero projection
    and unit norms would hide a misplaced term)."""
    rs = np.random.RandomState(seed)

    def move(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return a
        return (a + 0.05 * rs.randn(*a.shape)).astype(a.dtype)
    return jax.tree_util.tree_map(move, tree)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4,
                               atol=1e-5 * float(np.abs(want).max()))


def _np(port_tree):
    return jax.tree_util.tree_map(lambda t: t.numpy(), port_tree,
                                  is_leaf=torch.is_tensor)


@pytest.fixture(scope="module")
def vae_trees():
    cfg = JV.VAE21Config(**VCFG)
    jtree = _randomize(_np(TV.init_vae21_params(
        TV.VAE21Config(**VCFG), seed=0, dtype=torch.float32,
        device="cpu")), 1)
    return cfg, jtree, from_jax_params(jtree, "cpu")


def test_vae21_encode_decode_match_jax(vae_trees):
    jcfg, jtree, port = vae_trees
    cfg = TV.VAE21Config(**VCFG)
    x = np.random.RandomState(2).uniform(-1, 1, (1, 3, 5, 32, 48)
                                         ).astype(np.float32)
    mu, lv = TV.vae21_encode(port, cfg, torch.from_numpy(x))
    jmu, jlv = jax.jit(JV.vae21_encode, static_argnums=1)(
        jtree, jcfg, jnp.asarray(x))
    assert mu.shape == (1, 16, 2, 4, 6)
    _close(mu, jmu)
    _close(lv, jlv)
    z = np.random.RandomState(3).randn(1, 16, 2, 4, 6).astype(np.float32)
    out = TV.vae21_decode(port, cfg, torch.from_numpy(z))
    assert out.shape == (1, 3, 5, 32, 48)
    _close(out, jax.jit(JV.vae21_decode, static_argnums=1)(
        jtree, jcfg, jnp.asarray(z)))


def test_vae21_state_dict_round_trip_matches_jax(vae_trees):
    jcfg, jtree, port = vae_trees
    cfg = TV.VAE21Config(**VCFG)
    sd = TV.vae21_state_dict(port, cfg)
    back = TV.vae21_params_from_state_dict(sd, cfg, device="cpu")
    jback = JV.vae21_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), back, is_leaf=torch.is_tensor))
    # the stats are constants of the config, not state-dict entries
    mean, inv_std = JV.wan21_latent_stats(16)
    jtree = {**jtree, "latents_mean": mean, "latents_inv_std": inv_std}
    for tree in (jtree, jback):
        want = jax.tree_util.tree_leaves(tree)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_init_vae21_params_has_jax_shapes():
    cfg = TV.VAE21Config(**VCFG)
    port = TV.init_vae21_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
    init = functools.partial(JV.init_vae21_params,
                             cfg=JV.VAE21Config(**VCFG))
    shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                    jax.eval_shape(init,
                                                   jax.random.PRNGKey(0)))
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), port,
                                 is_leaf=torch.is_tensor)
    assert got == jax.tree_util.tree_map(tuple, shapes,
                                         is_leaf=lambda s: isinstance(
                                             s, tuple))


@pytest.mark.parametrize("post_norm", [True, False])
def test_xlm_roberta_matches_jax(post_norm):
    jcfg = JC.XLMRobertaConfig(post_norm=post_norm, **XCFG)
    cfg = TC.XLMRobertaConfig(post_norm=post_norm, **XCFG)
    port_init = TC.init_xlm_roberta_params(cfg, seed=0, device="cpu")
    jtree = _randomize(_np(port_init), 4)
    jtree["blocks"] = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *jtree["blocks"])      # JAX stacks them
    port = from_jax_params(jtree, "cpu")
    rs = np.random.RandomState(5)
    ids = rs.randint(2, XCFG["vocab_size"], (3, 12))
    ids[1, 7:] = XCFG["pad_id"]             # padded rows: keys masked
    ids[2, 1:] = XCFG["pad_id"]
    got = TC.xlm_roberta_forward(port, cfg, torch.from_numpy(ids))
    want = jax.jit(JC.xlm_roberta_forward, static_argnums=1)(
        jtree, jcfg, jnp.asarray(ids))
    assert got.shape == (3, 12, 32)
    _close(got, want)


def test_init_xlm_roberta_params_has_jax_shapes():
    cfg = TC.XLMRobertaConfig(**XCFG)
    port = TC.init_xlm_roberta_params(cfg, seed=0, device="cpu")
    jshapes = jax.eval_shape(functools.partial(
        JC.init_xlm_roberta_params, cfg=JC.XLMRobertaConfig(**XCFG)),
        jax.random.PRNGKey(0))
    assert len(port["blocks"]) == XCFG["num_layers"]
    for key, leaf in jshapes.items():
        if key == "blocks":
            for name, sub in leaf.items():
                got = port["blocks"][0][name]
                if isinstance(sub, dict):
                    for n2, s2 in sub.items():
                        assert tuple(got[n2].shape) == s2.shape[1:]
                else:
                    assert tuple(got.shape) == sub.shape[1:]
        else:
            assert tuple(port[key].shape) == leaf.shape, key
