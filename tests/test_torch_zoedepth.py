"""The port's ZoeDepth (`flexam_tpu_torch/perception/zoedepth.py`) against
the JAX package's, on the CPU at `tiny_zoe_config()`, with the weights
crossed through `io.convert.from_jax_params`.

Each part is held at rtol 2e-4 / atol 1e-5 (fp32): one BEiT block with its
relative-position bias resized to a non-square window, the ConvTranspose
resize (`_conv_t`), a fusion block, the metric-bins head's outputs, the
whole `zoedepth_forward`, `ZoeDepth.infer` with and without the reflect
pad and the flip, and `zoe_depth_video`. The loader maps a state dict in
ZoeD_M12_N's names as JAX's does; `_midas_size` rounds half to even.
The JAX tree is made from the port's init (JAX's eager init compiles op
by op), crossed to numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import zoedepth as J
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import zoedepth as T

TOL = dict(rtol=2e-4, atol=1e-5)
TINY_J = J.tiny_zoe_config()
TINY = T.tiny_zoe_config()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    workers (see tests/test_torch_moge.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(tree):
    """A port tree (torch layout throughout, as JAX's ZoeDepth keeps it)
    as JAX arrays."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def crossed(jparams):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")


def _randomize(tree, seed):
    """Random values in every leaf (the init's zero biases and cls token
    would hide a misplaced term)."""
    g = torch.Generator().manual_seed(seed)

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        if isinstance(t, list):
            return [visit(v) for v in t]
        return t + 0.05 * torch.randn(t.shape, generator=g)
    return visit(tree)


@pytest.fixture(scope="module")
def trees():
    gen = torch.Generator().manual_seed(0)
    port = _randomize(T.zoedepth_init(gen, TINY, "cpu"), 1)
    jparams = to_jax(port)
    return jparams, crossed(jparams)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def test_from_jax_params_keeps_the_layout(trees):
    jparams, port = trees
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        lambda t: t.numpy(), port))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_beit_block_with_bias_on_a_nonsquare_window(trees):
    jparams, port = trees
    bp = port["blocks"][1]
    jb = jparams["blocks"][1]
    window = (3, 5)                          # the table is trained at 4x4
    bias_t = T._rel_pos_bias(bp["rel_pos_table"], TINY, window)
    bias_j = J._rel_pos_bias(jb["rel_pos_table"], TINY_J, window)
    assert bias_t.shape == (2, 16, 16)
    close(bias_t, bias_j)
    x = np.random.RandomState(2).randn(2, 16, 32).astype(np.float32)
    got = T._beit_block(bp, torch.from_numpy(x), bias_t, TINY.num_heads)
    want = J._beit_block(jb, jnp.asarray(x), bias_j, TINY_J.num_heads)
    close(got, want)
    np.testing.assert_array_equal(
        T._gen_relative_position_index(3, 5),
        J._gen_relative_position_index(3, 5))


def test_rel_pos_index_is_built_once_per_window(trees, monkeypatch):
    """The index is cached on the device by (wh, ww): the bias equals the
    one built from a fresh index, and a second window builds once more."""
    _, port = trees
    table = port["blocks"][0]["rel_pos_table"]
    builds = []
    gen = T._gen_relative_position_index
    T._rel_pos_index.cache_clear()
    monkeypatch.setattr(T, "_gen_relative_position_index",
                        lambda *a: builds.append(a) or gen(*a))
    first = T._rel_pos_bias(table, TINY, (3, 5))
    for _ in range(3):
        np.testing.assert_array_equal(
            T._rel_pos_bias(table, TINY, (3, 5)).numpy(), first.numpy())
    assert builds == [(3, 5)]
    T._rel_pos_bias(table, TINY, (4, 4))
    assert builds == [(3, 5), (4, 4)]
    T._rel_pos_index.cache_clear()
    n = 3 * 5 + 1
    idx = torch.from_numpy(gen(3, 5)).reshape(-1)
    owh, oww = TINY.train_window
    sub = table[: (2 * owh - 1) * (2 * oww - 1)].reshape(
        2 * oww - 1, 2 * owh - 1, -1)
    sub = T.resize(sub.float(), (5, 9, sub.shape[-1]), "bilinear")
    full = torch.cat([sub.reshape(45, -1).to(table.dtype),
                      table[(2 * owh - 1) * (2 * oww - 1):]], 0)
    np.testing.assert_array_equal(
        first.numpy(), full[idx].reshape(n, n, -1).permute(2, 0, 1).numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_matches_jax(k):
    rs = np.random.RandomState(k)
    x = rs.randn(2, 3, 5, 6).astype(np.float32)
    p = {"weight": rs.randn(6, 4, k, k).astype(np.float32),
         "bias": rs.randn(4).astype(np.float32)}
    got = T._conv_t(torch.from_numpy(x), crossed(p), k)
    want = J._conv_t(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p),
                     k)
    assert got.shape == (2, 3 * k, 5 * k, 4)
    close(got, want)


def test_same_padding_stride_two_matches_xla():
    rs = np.random.RandomState(3)
    p = {"weight": rs.randn(5, 4, 3, 3).astype(np.float32),
         "bias": rs.randn(5).astype(np.float32)}
    for hw in ((6, 8), (5, 7)):
        x = rs.randn(1, *hw, 4).astype(np.float32)
        got = T._conv(torch.from_numpy(x), crossed(p), stride=2)
        want = J._conv(jnp.asarray(x),
                       jax.tree_util.tree_map(jnp.asarray, p), stride=2)
        close(got, want)


def test_fusion_block_matches_jax(trees):
    jparams, port = trees
    rs = np.random.RandomState(4)
    x = rs.randn(1, 3, 4, 16).astype(np.float32)
    skip = rs.randn(1, 3, 4, 16).astype(np.float32)
    got = T._fusion(port["refinenet"][1], torch.from_numpy(x),
                    torch.from_numpy(skip), size=(5, 7))
    want = J._fusion(jparams["refinenet"][1], jnp.asarray(x),
                     jnp.asarray(skip), size=(5, 7))
    close(got, want)
    close(T.resize_ac(torch.from_numpy(x), (7, 9)),
          J.resize_ac(jnp.asarray(x), (7, 9)))


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's forward jitted once for the module (eagerly, JAX compiles it
    op by op, about half a minute here); the models of `_models` share
    it."""
    return jax.jit(lambda p, x: J.zoedepth_forward(p, TINY_J, x))


@pytest.fixture(scope="module")
def forwards(trees, jax_forward):
    jparams, port = trees
    x = np.random.RandomState(5).rand(2, 64, 96, 3).astype(np.float32)
    got = T.zoedepth_forward(port, TINY, torch.from_numpy(x))
    want = jax_forward(jparams, jnp.asarray(x))
    return got, want


def test_bins_head_matches_jax(forwards):
    got, want = forwards
    for k in ("bin_centers", "probs"):
        close(got[k], want[k], err_msg=k)
    kk = np.arange(8, dtype=np.float32)
    close(T._log_binom(torch.tensor(7.0), torch.from_numpy(kk)),
          J._log_binom(jnp.asarray(7.0), jnp.asarray(kk)))


def test_forward_matches_jax(forwards):
    got, want = forwards
    assert got["metric_depth"].shape == (2, 64, 96, 1)
    for k in ("metric_depth", "rel_depth"):
        close(got[k], want[k], err_msg=k)


def _models(trees, jax_forward):
    jparams, port = trees
    jm = J.ZoeDepth.__new__(J.ZoeDepth)
    jm.cfg, jm.params = TINY_J, jparams
    jm._jit = jax_forward
    return jm, T.ZoeDepth(TINY, params=port, device="cpu")


@pytest.mark.parametrize("pad,flip", [(False, False), (True, True)])
def test_infer_matches_jax(trees, jax_forward, pad, flip):
    jm, tm = _models(trees, jax_forward)
    x = np.random.RandomState(6).rand(1, 3, 40, 56).astype(np.float32)
    got = tm.infer(x, pad_input=pad, with_flip_aug=flip)
    want = jm.infer(x, pad_input=pad, with_flip_aug=flip)
    assert got.shape == (1, 1, 40, 56)
    close(got, want)


def test_zoe_depth_video_matches_jax(trees, jax_forward):
    jm, tm = _models(trees, jax_forward)
    video = np.random.RandomState(7).rand(3, 48, 64, 3).astype(np.float32)
    got = T.zoe_depth_video(video, model=tm, batch=2)
    close(got, J.zoe_depth_video(video, model=jm, batch=2))
    assert got.shape == (3, 48, 64)


def reference_state_dict(jparams):
    """The tree under ZoeD_M12_N's names (the inverse of JAX's map)."""
    sd = {}

    def put(prefix, p):
        for k, v in p.items():
            sd[f"{prefix}.{k}"] = torch.from_numpy(np.array(v))

    mp = "core.core.pretrained.model."
    sd[mp + "cls_token"] = torch.from_numpy(np.array(jparams["cls_token"]))
    put(mp + "patch_embed.proj", jparams["patch_embed"])
    for i, bp in enumerate(jparams["blocks"]):
        pre = f"{mp}blocks.{i}."
        for name, key in (("norm1", "norm1"), ("attn.qkv", "qkv"),
                          ("attn.proj", "proj"), ("norm2", "norm2"),
                          ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            put(pre + name, bp[key])
        for name, key in (("attn.q_bias", "q_bias"),
                          ("attn.v_bias", "v_bias"),
                          ("attn.relative_position_bias_table",
                           "rel_pos_table"),
                          ("gamma_1", "gamma_1"), ("gamma_2", "gamma_2")):
            sd[pre + name] = torch.from_numpy(np.array(bp[key]))
    pp = "core.core.pretrained."
    for j, e in enumerate(jparams["act_postprocess"]):
        put(f"{pp}act_postprocess{j + 1}.0.project.0", e["readout"])
        put(f"{pp}act_postprocess{j + 1}.3", e["project"])
        if "resize" in e:
            put(f"{pp}act_postprocess{j + 1}.4", e["resize"])
    sp = "core.core.scratch."
    for j in range(4):
        put(f"{sp}layer{j + 1}_rn", jparams["layer_rn"][j])
        r = jparams["refinenet"][j]
        put(f"{sp}refinenet{j + 1}.out_conv", r["out_conv"])
        for u in (1, 2):
            for c in ("conv1", "conv2"):
                put(f"{sp}refinenet{j + 1}.resConfUnit{u}.{c}",
                    r[f"rcu{u}"][c])
    for n, key in (("0", "conv1"), ("2", "conv2"), ("4", "conv3")):
        put(f"{sp}output_conv.{n}", jparams["output_conv"][key])
    put("conv2", jparams["conv2"])

    def mlp(prefix, p):
        put(prefix + ".0", p["conv1"])
        put(prefix + ".2", p["conv2"])

    mlp("seed_bin_regressor._net", jparams["seed_bin_regressor"])
    mlp("seed_projector._net", jparams["seed_projector"])
    for i in range(4):
        mlp(f"projectors.{i}._net", jparams["projectors"][i])
        mlp(f"attractors.{i}._net", jparams["attractors"][i])
    mlp("conditional_log_binomial.mlp", jparams["clb"])
    return sd


def test_loader_maps_reference_names_as_jax(trees, tmp_path):
    jparams, _ = trees
    sd = reference_state_dict(jparams)
    path = tmp_path / "ZoeD_M12_N.pt"
    torch.save({"model": sd, "epoch": torch.tensor(3)}, str(path))
    want = J.zoedepth_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, TINY_J)
    model = T.load_zoedepth(str(path), T.ZoeDepth(TINY, device="cpu"))
    assert model.load_ok
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), model.params))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        jax.tree_util.keystr(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(p))
    # the port's writer gives the same file contents
    mine = T.zoedepth_state_dict(model.params)
    assert sorted(mine) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(mine[k], v), k
    del sd["core.core.scratch.layer2_rn.weight"]
    torch.save({"model": sd}, str(path))
    with pytest.raises(KeyError):
        T.load_zoedepth(str(path), device="cpu")


def test_midas_size_rounds_half_to_even():
    # 80 x 512 at (384, 512): the width's scale 1 wins, 80 / 32 = 2.5
    assert T._midas_size(80, 512, T.ZoeDepthConfig()) == (64, 512)
    for cfg_t, cfg_j in ((T.ZoeDepthConfig(), J.ZoeDepthConfig()),
                         (TINY, TINY_J)):
        for h, w in ((80, 512), (512, 896), (480, 832), (33, 70),
                     (720, 1280), (100, 48)):
            assert T._midas_size(h, w, cfg_t) == J._midas_size(h, w, cfg_j)


def test_registry_runs_zoe_as_jax(trees, tmp_path, monkeypatch):
    """`estimate_depth` picks "zoe" with FLEXAM_ZOE_CKPT alone, in both
    packages (their default configs swapped for the tiny one)."""
    from flexam_tpu.perception import depth as jdepth
    from flexam_tpu_torch.perception import depth as tdepth
    jparams, _ = trees
    path = tmp_path / "zoe.pt"
    torch.save({"model": reference_state_dict(jparams)}, str(path))
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_DAV2_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FLEXAM_ZOE_CKPT", str(path))
    monkeypatch.setattr(T, "ZoeDepthConfig", lambda: TINY)
    monkeypatch.setattr(J, "ZoeDepthConfig", lambda: TINY_J)
    monkeypatch.setattr(J, "zoedepth_init", lambda key, cfg: jparams)
    video = np.random.RandomState(8).rand(2, 40, 48, 3).astype(np.float32)
    got = tdepth.estimate_depth(video, device="cpu")
    want = jdepth.estimate_depth(video)
    assert got.shape == (2, 40, 48)
    close(got, want)
