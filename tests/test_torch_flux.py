"""The port's FLUX transformer, FLUX VAE and CLIP-L text tower
(`flexam_tpu_torch/models/{flux,flux_vae,clip_text}.py`) against the JAX
package's, on the CPU at JAX's tiny configs, with the weights crossed
through `io.convert.from_jax_params`, plus T5 v1.1 and CLIP-L text against
transformers' randomly initialised models (as
`tests/test_flux_text_oracle.py` holds JAX's).

Each forward is held at rtol 2e-4 / atol 1e-5 in fp32 (the suite's
tolerance); the loaders map the published files (BFL `flux1-*`, `ae`,
`CLIPTextModel`) as JAX's do, with equal coverage reports. The JAX trees
are made from the port's inits (`to_jax` below: blocks stacked, kernels
transposed to HWIO), randomised so that no zero bias or unit scale hides
a misplaced term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.models import clip_text as JC
from flexam_tpu.models import flux as JF
from flexam_tpu.models import flux_vae as JV
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models import clip_text as TC
from flexam_tpu_torch.models import flux as TF
from flexam_tpu_torch.models import flux_vae as TV

TOL = dict(rtol=2e-4, atol=1e-5)
STACKED = ("blocks", "double_blocks", "single_blocks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    workers (see tests/test_torch_moge.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(tree, seed, scale=0.05):
    """Every leaf plus scale * N(0, 1) (a fresh tree)."""
    g = torch.Generator().manual_seed(seed)

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        if isinstance(t, list):
            return [visit(v) for v in t]
        return t + scale * torch.randn(t.shape, generator=g)
    return visit(tree)


def to_jax(tree, conv=False, key=""):
    """A port tree as JAX's: block lists stacked on a leading axis, and
    (`conv`) OIHW / OIDHW kernels as HWIO / DHWIO."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in STACKED and isinstance(v, list):
                out[k] = jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs), *[to_jax(b) for b in v])
            else:
                out[k] = to_jax(v, conv, k)
        return out
    if isinstance(tree, list):
        return [to_jax(v, conv, key) for v in tree]
    a = tree.detach().float().numpy()
    if conv and key in ("w", "weight"):
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 5:
            a = a.transpose(2, 3, 4, 1, 0)
    return jnp.asarray(a)


def crossed(jtree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def same_report(a, b) -> bool:
    """Two coverage reports with the same entries (in any order)."""
    return {k: sorted(v) for k, v in a.items()} == {
        k: sorted(v) for k, v in b.items()}


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


CFG_T = TF.FluxConfig.tiny()
CFG_J = JF.FluxConfig.tiny()
VCFG_T = TV.FluxVAEConfig.tiny()
VCFG_J = JV.FluxVAEConfig.tiny()


@pytest.fixture(scope="module")
def flux_trees():
    port = randomize(TF.init_flux_params(CFG_T, seed=0, dtype=torch.float32,
                                         device="cpu"), 1)
    jp = to_jax(port)
    return jp, crossed(jp)


@pytest.fixture(scope="module")
def vae_trees():
    port = randomize(TV.init_flux_vae_params(VCFG_T, seed=0, device="cpu"),
                     2, scale=0.02)
    jp = to_jax(port, conv=True)
    return jp, crossed(jp)


def flux_inputs(cfg=CFG_J, b=2, h=8, w=12, seed=0):
    rng = np.random.default_rng(seed)
    l_img = (h // cfg.patch) * (w // cfg.patch)
    return dict(
        img=rng.standard_normal((b, l_img, cfg.in_channels)).astype(
            np.float32),
        img_ids=JF.make_img_ids(h, w, cfg.patch),
        txt=rng.standard_normal((b, 6, cfg.context_dim)).astype(np.float32),
        txt_ids=np.zeros((6, 3), np.int32),
        t=np.asarray([0.7, 0.25][:b], np.float32),
        y=rng.standard_normal((b, cfg.vec_dim)).astype(np.float32),
        guidance=np.asarray([4.0, 7.5][:b], np.float32))


@pytest.mark.parametrize("embedding", ["jax", "port"])
def test_flux_forward_matches_jax(flux_trees, embedding, monkeypatch):
    """The forward at TOL with JAX's timestep embedding handed in; with the
    port's own, within 5e-5 of max |out|: FLUX scales t by 1000, so the
    one-ulp differences of exp between XLA and torch (14 of the 128
    frequencies) move the embedding by up to 1.4e-5, and the blocks carry
    that to 1.0e-4 of outputs of size 5 (3.1e-6 with JAX's embedding)."""
    jp, tp = flux_trees
    x = flux_inputs()
    want = JF.flux_forward(jp, CFG_J, **{k: jnp.asarray(v)
                                         for k, v in x.items()})
    tol = dict(TOL)
    if embedding == "jax":
        monkeypatch.setattr(TF, "timestep_embedding", lambda t, d: (
            torch.from_numpy(np.asarray(JF.timestep_embedding(
                jnp.asarray(t.numpy()), d)))))
    else:
        tol["atol"] = 5e-5 * float(np.abs(want).max())
    got = TF.flux_forward(tp, CFG_T, **{k: torch.from_numpy(v)
                                        for k, v in x.items()})
    assert got.shape == (2, x["img"].shape[1], CFG_T.out_channels)
    close(got, want, **tol)


def test_flux_embeddings_rope_packing_schedule_match_jax():
    # arguments up to 1000 rad: a one-ulp frequency (6e-8 relative) moves
    # one by up to 6e-5 (test_flux_forward_matches_jax)
    t = np.asarray([0.0, 0.3, 1.0], np.float32)
    close(TF.timestep_embedding(torch.from_numpy(t), 256),
          JF.timestep_embedding(jnp.asarray(t), 256), rtol=0, atol=6e-5)
    ids = np.concatenate([np.zeros((3, 3), np.int32),
                          JF.make_img_ids(6, 10)])
    c_t, s_t = TF.rope_tables(torch.from_numpy(ids), (16, 56, 56), 10000)
    c_j, s_j = JF.rope_tables(jnp.asarray(ids), (16, 56, 56), 10000)
    close(c_t, c_j, atol=1e-6)
    close(s_t, s_j, atol=1e-6)
    x = np.random.default_rng(3).standard_normal(
        (2, ids.shape[0], 3, 128)).astype(np.float32)
    close(TF.apply_rope(torch.from_numpy(x), c_t, s_t),
          JF.apply_rope(jnp.asarray(x), c_j, s_j), atol=1e-5)
    np.testing.assert_array_equal(TF.make_img_ids(6, 10),
                                  JF.make_img_ids(6, 10))
    z = np.random.default_rng(4).standard_normal(
        (2, 16, 6, 10)).astype(np.float32)
    packed = TF.pack_latents(torch.from_numpy(z))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JF.pack_latents(jnp.asarray(z))))
    np.testing.assert_array_equal(TF.unpack_latents(packed, 6, 10).numpy(), z)
    for n, seq in ((30, 1792), (4, 256), (7, 4096)):
        np.testing.assert_array_equal(TF.flux_schedule(n, seq),
                                      JF.flux_schedule(n, seq))


def test_flux_loader_matches_jax(flux_trees):
    """The BFL names both ways: the port's writer -> both loaders (equal
    trees and reports); a missing and a mis-shaped tensor count as missed
    in both."""
    jp, tp = flux_trees
    sd = {k: v.numpy() for k, v in TF.flux_state_dict(tp, CFG_T).items()}
    assert sd.keys() == JF.flux_params_to_state_dict(jp, CFG_J).keys()
    jl, jrep = JF.flux_params_from_state_dict(sd, CFG_J)
    tl, trep = TF.flux_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG_T,
        device="cpu")
    assert same_report(trep, jrep) and not trep["missed"] and not trep["unused"]
    assert_trees_equal(tl, crossed(jl))
    del sd["double_blocks.1.txt_mlp.2.bias"]
    sd["img_in.weight"] = sd["img_in.weight"][:, :16]
    sd["junk"] = np.zeros(3, np.float32)
    _, jrep = JF.flux_params_from_state_dict(sd, CFG_J)
    _, trep = TF.flux_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, CFG_T,
        device="cpu")
    assert same_report(trep, jrep)
    assert set(trep["missed"]) == {"double_blocks/1/txt_mlp2_b", "img_in_w"}


def test_flux_full_geometry():
    """FLUX.1-Depth-dev at its published widths: about 11.9 B parameters,
    the BFL key count of JAX's map (shapes only, on the meta device)."""
    from flexam_tpu_torch.core.layers import ParamDraw
    from flexam_tpu_torch.io.convert import tree_leaves
    tree = TF._flux_tree(TF.FluxConfig(), ParamDraw(0, device="meta"))
    n = sum(t.numel() for t in tree_leaves(tree))
    assert 11.8e9 < n < 12.0e9, n
    assert len(TF._bfl_names(TF.FluxConfig())) == len(
        JF._bfl_names(JF.FluxConfig()))


def test_flux_vae_matches_jax(vae_trees):
    """Encode (posterior mean, scale/shift), decode, and the VAE's pieces
    (the padded stride-2 downsample, the mid attention) against JAX."""
    jp, tp = vae_trees
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 24, 3)).astype(
        np.float32)
    zj = JV.flux_vae_encode(jp, VCFG_J, jnp.asarray(x))
    zt = TV.flux_vae_encode(tp, VCFG_T,
                            torch.from_numpy(x).permute(0, 3, 1, 2))
    close(zt.permute(0, 2, 3, 1), zj)
    z = np.asarray(zj)
    yj = JV.flux_vae_decode(jp, VCFG_J, jnp.asarray(z))
    yt = TV.flux_vae_decode(tp, VCFG_T,
                            torch.from_numpy(z).permute(0, 3, 1, 2))
    assert yt.shape == (2, 3, 16, 24)
    close(yt.permute(0, 2, 3, 1), yj)
    # the posterior sample differs from the mean and keeps the shape
    s = TV.flux_vae_encode(tp, VCFG_T, torch.from_numpy(x).permute(
        0, 3, 1, 2), generator=torch.Generator().manual_seed(0))
    assert s.shape == zt.shape and (s - zt).abs().max() > 1e-6


def test_flux_vae_loader_matches_jax(vae_trees):
    jp, tp = vae_trees
    sd = {k: v.numpy() for k, v in TV.flux_vae_state_dict(tp, VCFG_T).items()}
    assert sd.keys() == JV.flux_vae_params_to_state_dict(jp, VCFG_J).keys()
    jl, jrep = JV.flux_vae_params_from_state_dict(sd, VCFG_J)
    tl, trep = TV.flux_vae_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, VCFG_T,
        device="cpu")
    assert same_report(trep, jrep) and not trep["missed"] and not trep["unused"]
    assert_trees_equal(tl, crossed(jl))
    for k in [k for k in sd if k.startswith("decoder.up.1.")]:
        del sd[k]
    _, jrep = JV.flux_vae_params_from_state_dict(sd, VCFG_J)
    _, trep = TV.flux_vae_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, VCFG_T,
        device="cpu")
    assert same_report(trep, jrep) and trep["missed"]


def test_flux_vae_full_geometry():
    """The FLUX ae has ~83.8 M parameters (JAX's test's bounds)."""
    from flexam_tpu_torch.core.layers import ParamDraw
    from flexam_tpu_torch.io.convert import tree_leaves
    tree = TV._vae_tree(TV.FluxVAEConfig(), ParamDraw(0, device="meta"))
    n = sum(t.numel() for t in tree_leaves(tree))
    assert 80e6 < n < 90e6, n


def test_clip_text_matches_jax_and_transformers():
    """CLIP-L text at a tiny geometry: transformers' random CLIPTextModel
    -> both loaders; hidden states and the EOS-pooled output against JAX's
    and transformers' (EOS mid-sequence, at the end, and absent)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2,
        max_position_embeddings=10, eos_token_id=63, bos_token_id=62,
        pad_token_id=0, hidden_act="quick_gelu", attention_dropout=0.0)
    torch.manual_seed(1)
    model = transformers.CLIPTextModel(hf_cfg).eval()
    sd = model.state_dict()
    tp = TC.clip_text_params_from_state_dict(sd, TC.CLIPTextConfig.tiny(),
                                             device="cpu")
    jp = JC.clip_text_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, JC.CLIPTextConfig.tiny())
    ids = np.random.default_rng(1).integers(1, 62, (3, 10)).astype(np.int32)
    ids[0, 6] = 63
    ids[1, 9] = 63
    hid_t, pool_t = TC.clip_text_forward(tp, TC.CLIPTextConfig.tiny(),
                                         torch.from_numpy(ids))
    hid_j, pool_j = JC.clip_text_forward(jp, JC.CLIPTextConfig.tiny(),
                                         jnp.asarray(ids))
    close(hid_t, hid_j)
    close(pool_t, pool_j)
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids[:2].astype(np.int64)))
    close(hid_t[:2], ref.last_hidden_state, atol=2e-4)
    close(pool_t[:2], ref.pooler_output, atol=2e-4)
    # the writer's names load back as they were
    back = TC.clip_text_params_from_state_dict(
        TC.clip_text_state_dict(tp, TC.CLIPTextConfig.tiny()),
        TC.CLIPTextConfig.tiny(), device="cpu")
    assert_trees_equal(back, tp)
    with pytest.raises(KeyError):
        TC.clip_text_params_from_state_dict({}, TC.CLIPTextConfig.tiny(),
                                            device="cpu")


def test_clip_text_init_matches_jax_structure():
    """The port's random init has JAX's tree, shapes and dtypes (JAX's
    stacked blocks, one dict each here)."""
    cfg = TC.CLIPTextConfig.tiny()
    tp = TC.init_clip_text_params(cfg, seed=0, device="cpu")
    jp = JC.init_clip_text_params(jax.random.PRNGKey(0),
                                  JC.CLIPTextConfig.tiny())
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, jp)
    shapes_t = jax.tree_util.tree_map(lambda a: a.shape, to_jax(tp))
    assert shapes_t == shapes_j


def test_t5_v11_shared_pos_matches_transformers():
    """T5 v1.1 (shared relative-position bias, gated GELU) through the
    port's `t5_params_from_hf_state_dict` / `t5_encode` against
    transformers' random T5EncoderModel, on the valid tokens."""
    transformers = pytest.importorskip("transformers")
    from flexam_tpu_torch.config import T5Config
    from flexam_tpu_torch.models.t5 import (t5_encode,
                                            t5_params_from_hf_state_dict)
    hf_cfg = transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=3,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False,
        use_cache=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.T5EncoderModel(hf_cfg).eval()
    cfg = T5Config(vocab=96, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                   num_layers=3, num_buckets=8, max_distance=16,
                   shared_pos=True)
    params = t5_params_from_hf_state_dict(model.state_dict(), cfg,
                                          device="cpu")
    ids = np.random.default_rng(0).integers(0, 96, (2, 11)).astype(np.int64)
    mask = np.ones((2, 11), np.int64)
    mask[1, 7:] = 0
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask)
                    ).last_hidden_state.numpy()
    out = t5_encode(params, cfg, torch.from_numpy(ids),
                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out[1, :7], ref[1, :7], rtol=2e-4, atol=2e-4)
