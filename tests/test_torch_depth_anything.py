"""The port's Depth-Anything-V2 (`flexam_tpu_torch/perception/
depth_anything.py`) against the JAX package's, on the CPU at
`tiny_dav2_config()`, with the weights crossed through
`io.convert.from_jax_params` (the DINOv2 encoder's patch embedding HWIO in
JAX's tree, the DPT head torch layout in both).

`dav2_forward` on a non-square frame (a 4x3 patch grid, so the position
embedding is resized to a grid that is not square) and `dav2_infer_video`
(OpenCV's INTER_CUBIC and INTER_LINEAR in JAX, their numpy rebuilds here)
at rtol 2e-4 / atol 1e-5; `_lower_bound_size`; `load_dav2` on a file in
the original release's names; the registry's dav2 / zoe / unidepth choice
by env var through `estimate_depth`. `verify_ckpt --model zoe|dav2` on a
junk file, False in both tools, is in `tests/test_torch_tools.py`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import depth_anything as J
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import depth_anything as T
from tests.test_depth_anything import _torch_sd_from

TOL = dict(rtol=2e-4, atol=1e-5)
TINY_J = J.tiny_dav2_config()
TINY = T.tiny_dav2_config()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(tree, key="", hwio=True):
    """A port tree as JAX's: the encoder's 4-dim conv kernels HWIO, the
    DPT head as it is."""
    if isinstance(tree, dict):
        return {k: to_jax(v, k, hwio and k != "head") for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [to_jax(v, key, hwio) for v in tree]
    a = tree.numpy()
    if hwio and a.ndim == 4 and key == "weight":
        a = a.transpose(2, 3, 1, 0)
    return jnp.asarray(a)


def crossed(jparams):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                           "cpu")


@pytest.fixture(scope="module")
def trees():
    g = torch.Generator().manual_seed(0)
    port = T.dav2_init(g, TINY, "cpu")
    gn = torch.Generator().manual_seed(1)

    def jitter(t):
        if isinstance(t, dict):
            return {k: jitter(v) for k, v in t.items()}
        if isinstance(t, list):
            return [jitter(v) for v in t]
        return t + 0.05 * torch.randn(t.shape, generator=gn)

    jparams = to_jax(jitter(port))
    return jparams, crossed(jparams)


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def test_from_jax_params_turns_only_the_encoder(trees):
    jparams, port = trees
    np.testing.assert_array_equal(
        port["encoder"]["patch_embed"]["proj"]["weight"].numpy(),
        np.asarray(jparams["encoder"]["patch_embed"]["proj"]["weight"])
        .transpose(3, 2, 0, 1))
    for key in ("resize0", "resize3"):
        np.testing.assert_array_equal(port["head"][key]["weight"].numpy(),
                                      np.asarray(jparams["head"][key]
                                                 ["weight"]))


def test_forward_matches_jax_on_a_nonsquare_grid(trees):
    jparams, port = trees
    x = np.random.RandomState(2).randn(2, 56, 42, 3).astype(np.float32)
    got = T.dav2_forward(port, torch.from_numpy(x), TINY)
    want = J.dav2_forward(jparams, jnp.asarray(x), TINY_J)
    assert got.shape == (2, 56, 42)
    close(got, want)


def test_infer_video_matches_jax(trees):
    jparams, port = trees
    video = np.random.RandomState(3).rand(3, 64, 56, 3).astype(np.float32)
    assert T._lower_bound_size(64, 56, 42, 14) == (56, 42)
    got = T.dav2_infer_video(port, video, TINY, batch=2)
    want = J.dav2_infer_video(jparams, video, TINY_J, batch=2)
    assert got.shape == (3, 64, 56)
    close(got, want)


def test_lower_bound_size_matches_jax():
    assert T._lower_bound_size(512, 896, 518, 14) == (518, 910)
    for h, w in ((512, 896), (480, 832), (720, 1280), (64, 56), (37, 99)):
        assert T._lower_bound_size(h, w, 518, 14) == \
            J._lower_bound_size(h, w, 518, 14)


def test_loader_maps_the_release_names_as_jax(trees, tmp_path, monkeypatch):
    jparams, _ = trees
    monkeypatch.setattr(J, "dav2_init", lambda key, cfg:
                        jax.tree_util.tree_map(lambda x: x, jparams))
    sd = _torch_sd_from(jparams)
    path = str(tmp_path / "depth_anything_v2_tiny.pth")
    torch.save(sd, path)
    want, _ = J.load_dav2(path, TINY_J, verbose=False)
    got, cfg = T.load_dav2(path, TINY, verbose=False, device="cpu")
    assert cfg == TINY
    jl = jax.tree_util.tree_leaves_with_path(crossed(want))
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        jax.tree_util.keystr(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        if jax.tree_util.keystr(p) == "['encoder']['register_tokens']":
            continue           # no file entry: left at each init, unused
        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                      err_msg=jax.tree_util.keystr(p))
    # the port's writer names every tensor of the release file
    mine = T.dav2_state_dict(got)
    assert list(mine) == list(sd)
    for k, v in sd.items():
        assert torch.equal(mine[k], v), k
    # JAX's report lists absent names under "missing", which
    # check_mapping does not count (it reads "missed"): a file without the
    # DPT head loads in both packages, the head left at its init
    torch.save({k: v for k, v in sd.items()
                if not k.startswith("depth_head.")}, path)
    loads = ((J.load_dav2, TINY_J),
             (functools.partial(T.load_dav2, device="cpu"), TINY))
    for load, cfg in loads:
        load(path, cfg, verbose=False)
    # a file that maps nothing raises in both
    torch.save({"junk.weight": torch.zeros(3, 3)}, path)
    for load, cfg in loads:
        with pytest.raises(ValueError, match="coverage"):
            load(path, cfg, verbose=False)


@pytest.fixture
def registry_env(trees, tmp_path, monkeypatch):
    """DAv2 and ZoeDepth files of tiny random trees, the loaders' default
    configs swapped for the tiny ones in both packages."""
    from flexam_tpu.perception import zoedepth as JZ
    from flexam_tpu_torch.perception import zoedepth as TZ
    from tests.test_torch_zoedepth import reference_state_dict, to_jax as zj
    jparams, _ = trees
    dav = tmp_path / "dav2.pth"
    torch.save(_torch_sd_from(jparams), str(dav))
    g = torch.Generator().manual_seed(4)
    zparams = zj(TZ.zoedepth_init(g, TZ.tiny_zoe_config(), "cpu"))
    zoe = tmp_path / "zoe.pt"
    torch.save({"model": reference_state_dict(zparams)}, str(zoe))
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_DAV2_CKPT", "FLEXAM_ZOE_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(J, "load_dav2",
                        functools.partial(J.load_dav2, cfg=TINY_J))
    monkeypatch.setattr(T, "load_dav2",
                        functools.partial(T.load_dav2, cfg=TINY))
    tiny_t, tiny_j = TZ.tiny_zoe_config(), JZ.tiny_zoe_config()
    monkeypatch.setattr(TZ, "ZoeDepthConfig", lambda: tiny_t)
    monkeypatch.setattr(JZ, "ZoeDepthConfig", lambda: tiny_j)
    # JAX's loaders build a tree before they map (its eager init compiles
    # op by op): hand them fresh copies of the trees instead
    monkeypatch.setattr(JZ, "zoedepth_init", lambda key, cfg: zparams)
    monkeypatch.setattr(J, "dav2_init", lambda key, cfg:
                        jax.tree_util.tree_map(lambda x: x, jparams))
    return str(dav), str(zoe)


def test_registry_picks_dav2_then_zoe_as_jax(registry_env, monkeypatch):
    from flexam_tpu.perception import depth as jdepth
    from flexam_tpu_torch.perception import depth as tdepth
    dav, zoe = registry_env
    video = np.random.RandomState(5).rand(2, 44, 40, 3).astype(np.float32)
    calls = []
    for name in ("dav2", "zoe"):
        fn = tdepth.DEPTH_BACKENDS[name]
        monkeypatch.setitem(tdepth.DEPTH_BACKENDS, name, functools.partial(
            lambda f, n, v, **kw: (calls.append(n), f(v, **kw))[1], fn,
            name))
    monkeypatch.setenv("FLEXAM_ZOE_CKPT", zoe)
    monkeypatch.setenv("FLEXAM_DAV2_CKPT", dav)
    got = tdepth.estimate_depth(video, device="cpu")       # dav2 first
    close(got, jdepth.estimate_depth(video))
    monkeypatch.delenv("FLEXAM_DAV2_CKPT")
    got = tdepth.estimate_depth(video, device="cpu")       # then zoe
    close(got, jdepth.estimate_depth(video))
    assert calls == ["dav2", "zoe"]
    monkeypatch.setenv("FLEXAM_DAV2_CKPT", dav)
    for name in ("dav", "dav2"):
        close(tdepth.estimate_depth(video, backend=name, device="cpu"),
              jdepth.estimate_depth(video, backend=name))
    monkeypatch.setenv("FLEXAM_UNIDEPTH_CKPT", dav)    # exists: first
    monkeypatch.setitem(tdepth.DEPTH_BACKENDS, "unidepth",
                        lambda v, **kw: calls.append("unidepth") or v[..., 0])
    tdepth.estimate_depth(video, device="cpu")
    assert calls[-1] == "unidepth"
