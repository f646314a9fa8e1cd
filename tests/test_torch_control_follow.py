"""The port's train-to-follow loop (`flexam_tpu_torch/tools/
control_follow.py`) against the JAX package's, on the CPU in fp32.

The blob clips and their tracks are equal. One step of each trainer
matches JAX's: `train_vae_recon` (Adam) and `train_dit_control` (AdamW
under the cosine schedule, on batches the port's pipeline builds), each
from one crossed init (JAX's `init_*` swapped for the crossed tree), with
JAX's noise crossed for the DiT step, held as `tests/test_torch_train.py`
holds a step. `evaluate_adherence` at 4 steps on one untrained stack
crossed from JAX, from JAX's initial noise: the generated uint8 clips
within one level, the centroid and tracker scores within stated bounds.
The 5-minute training and JAX's thresholds are the card's (`chip_smoke.py`
phase `train` (f)).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
# Imported while the test files are collected: its first import walks
# every module in sys.modules (`inspect.getmodule`), and a test that ran
# earlier in the same process can leave a stub there whose every
# attribute, `__file__` included, is a function
# (`tests/reference_oracle.py` `load_reference_dataset_image_video` turns
# the torchvision.transforms stub of `load_reference_dit` into one), which
# broke this file's first `torch._dynamo` import.
import torch._dynamo  # noqa: F401

from flexam_tpu.models import dit as jdit
from flexam_tpu.models import vae as jvae
from flexam_tpu.tools import control_follow as J
from flexam_tpu_torch.io.convert import (from_jax_params, stack_blocks,
                                         tree_leaves)
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels
from flexam_tpu_torch.tools import control_follow as T

RTOL = 2e-4
CFG, JCFG = T.control_follow_config(), J.control_follow_config()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy().copy(),
                                  stack_blocks(tree), is_leaf=torch.is_tensor)


@pytest.fixture(scope="module")
def trees():
    """(JAX numpy trees, port trees) of one VAE and one DiT init."""
    vae = _np(init_vae_params(CFG.vae, seed=0, dtype=torch.float32,
                              device="cpu"))
    dit = _np(init_dit_params(CFG.dit, seed=1, dtype=torch.float32,
                              device="cpu"))
    return vae, dit


def _port(np_tree):
    return from_jax_params(np_tree, "cpu")


def test_blob_clip_and_tracks_equal():
    for p0, p1, kw in (([16, 16], [48, 48], {}),
                       ([10.5, 50], [40, 12.25], dict(T=13, H=48, W=80))):
        tv, tc = T.make_blob_clip(p0, p1, **kw)
        jv, jc = J.make_blob_clip(p0, p1, **kw)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(T.tracks_from_centers(tc),
                                      J.tracks_from_centers(jc))
    assert T.default_holdout_cases()[1][0].tolist() == \
        J.default_holdout_cases()[1][0].tolist()
    assert dataclasses.asdict(CFG.vae) == dataclasses.asdict(JCFG.vae)


def _clips(n=3, T_=5):
    rs = np.random.RandomState(0)
    return np.stack([T.make_blob_clip(rs.uniform(12, 52, 2),
                                      rs.uniform(12, 52, 2), T=T_)[0]
                     for _ in range(n)])


def test_vae_recon_step_matches_jax(trees, monkeypatch):
    """One Adam step (lr 1e-3) of the reconstruction loss: the loss at
    rtol 2e-4; every leaf within 2 lr of JAX's, and at rtol 2e-4 / atol
    1e-5 where JAX's moved it by about lr (Adam's first step is lr g /
    (|g| + eps): where g lies within the summation noise of zero its sign,
    and so the step, is not determined; `tests/test_torch_train.py`)."""
    vae, _ = trees
    clips = _clips()
    monkeypatch.setattr(jvae, "init_vae_params", lambda *a, **k: jax.tree_util
                        .tree_map(jnp.asarray, vae))
    jp, jl = J.train_vae_recon(JCFG, clips, num_steps=1, seed=0)
    tp, tl = T.train_vae_recon(CFG, clips, num_steps=1, seed=0,
                               device="cpu", params=_port(vae))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    for g, w, p0 in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                        jax.tree_util.tree_leaves(vae)):
        g, w = g.numpy(), np.asarray(w)
        assert (np.abs(g - w) <= 2e-3 + 1e-5).all()
        moved = np.abs(w - p0) > 0.9e-3
        np.testing.assert_allclose(g[moved], w[moved], rtol=RTOL, atol=1e-5)


def test_dit_control_step_matches_jax(trees, monkeypatch):
    """Batches from the port's pipeline (a crossed VAE), one AdamW step of
    the DiT under the cosine schedule from JAX's key."""
    vae, dit = trees
    pipe = FlexAMGenerationPipeline(
        FlexAMModels(cfg=CFG, vae_params=_port(vae), dit_params=_port(dit)),
        device="cpu", compute_dtype=torch.float32)
    clips = [T.make_blob_clip([16, 20], [44, 40], T=5),
             T.make_blob_clip([50, 14], [18, 46], T=5)]
    data = T.build_training_batches(pipe, clips)
    assert data[0]["y"].shape[1] == 2 * CFG.dit.out_dim + 4
    ctx = np.random.RandomState(2).randn(
        1, CFG.t5.text_length, CFG.dit.text_dim).astype(np.float32)

    monkeypatch.setattr(jdit, "init_dit_params", lambda *a, **k: jax.tree_util
                        .tree_map(jnp.asarray, dit))
    jp, jl = J.train_dit_control(JCFG, data, ctx, num_steps=1, batch=2,
                                 seed=3)
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    k_sig, k_eps = jax.random.split(key)
    lat = data[0]["latents"].shape
    sigma = np.array(jax.random.uniform(k_sig, (2,), jnp.float32, 1e-4, 1.0))
    eps = np.array(jax.random.normal(k_eps, (2,) + lat[1:], jnp.float32))
    tp, tl = T.train_dit_control(
        CFG, data, ctx, num_steps=1, batch=2, seed=3, device="cpu",
        params=_port(dit),
        noise=lambda i: (torch.from_numpy(sigma), torch.from_numpy(eps)))
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    lr = 2e-3          # the schedule's first value
    for g, w, p0 in zip(tree_leaves(stack_blocks(tp)),
                        jax.tree_util.tree_leaves(jp),
                        jax.tree_util.tree_leaves(dit)):
        g, w = g.numpy(), np.asarray(w)
        assert (np.abs(g - w) <= 2 * lr + lr / 100).all()
        moved = np.abs(w - p0 * (1 - lr * 1e-4)) > 0.9 * lr
        np.testing.assert_allclose(g[moved], w[moved], rtol=RTOL,
                                   atol=lr / 100)


def test_evaluate_adherence_matches_jax(trees):
    vae, dit = trees
    ctx = np.random.RandomState(3).randn(
        1, CFG.t5.text_length, CFG.dit.text_dim).astype(np.float32)
    geometry = {"T": 13, "H": 64, "W": 64, "size": 16.0}
    jstack = {"cfg": JCFG, "ctx": ctx, "geometry": geometry,
              "vae_params": jax.tree_util.tree_map(jnp.asarray, vae),
              "dit_params": jax.tree_util.tree_map(jnp.asarray, dit)}
    tstack = {"cfg": CFG, "ctx": ctx, "geometry": geometry,
              "vae_params": _port(vae), "dit_params": _port(dit)}
    cases = J.default_holdout_cases()
    want = J.evaluate_adherence(jstack, cases, num_inference_steps=4)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(7),
                                       (1, CFG.dit.out_dim, 4, 4, 4),
                                       jnp.float32))
    got = T.evaluate_adherence(tstack, T.default_holdout_cases(),
                               num_inference_steps=4, device="cpu",
                               latents=torch.from_numpy(noise))
    for g, w in zip(got, want):
        d = np.abs(g["video"] - w["video"])
        assert d.max() <= 1 / 255 + 1e-6 and (d > 0).mean() < 1e-3
        np.testing.assert_allclose(g["centroid"], w["centroid"], atol=0.01)
        for k in ("centroid_err", "centroid_err_alt"):
            np.testing.assert_allclose(g[k], w[k], atol=0.01)
        assert (g["tracker_disp"] is None) == (w["tracker_disp"] is None)
        if w["tracker_disp"] is not None:
            np.testing.assert_allclose(g["tracker_disp"], w["tracker_disp"],
                                       atol=0.05)
            for k in ("tracker_err", "tracker_err_alt"):
                np.testing.assert_allclose(g[k], w[k], atol=0.1)


def test_quantized_evaluation_keeps_the_callers_tree(trees):
    """`quant="int8"` quantizes a copy: the stack's DiT keeps its float
    linears (a copy of the block list alone shared the nested dicts, whose
    linears the quantization replaced)."""
    vae, dit = trees
    stack = {"cfg": CFG, "vae_params": _port(vae), "dit_params": _port(dit),
             "ctx": np.zeros((1, CFG.t5.text_length, CFG.dit.text_dim),
                             np.float32),
             "geometry": {"T": 9, "H": 64, "W": 64, "size": 16.0}}
    before = [t.clone() for t in jax.tree_util.tree_leaves(
        stack["dit_params"])]
    res = T.evaluate_adherence(stack, T.default_holdout_cases()[:1],
                               num_inference_steps=1, quant="int8",
                               device="cpu")
    assert len(res) == 1
    assert "weight" in stack["dit_params"]["blocks"][0]["self_attn"]["q"]
    after = jax.tree_util.tree_leaves(stack["dit_params"])
    assert len(after) == len(before)
    for a, b in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_artifacts_and_cache(trees, tmp_path):
    """The artifact set (as `.mp4.npz` dumps where no encoder is
    installed) and the stack cache's round trip."""
    vae, dit = trees
    ctx = np.zeros((1, CFG.t5.text_length, CFG.dit.text_dim), np.float32)
    stack = {"cfg": CFG, "ctx": ctx, "vae_params": _port(vae),
             "dit_params": _port(dit), "vae_losses": [1.0],
             "dit_losses": [2.0],
             "geometry": {"T": 9, "H": 64, "W": 64, "size": 16.0}}
    out = str(tmp_path / "artifacts")
    res = T.evaluate_adherence(stack, T.default_holdout_cases()[:1],
                               num_inference_steps=2, artifacts_dir=out,
                               device="cpu")
    assert len(res) == 1
    files = {f.split(".mp4")[0] for f in os.listdir(out)}
    assert {"case0_generated", "case0_tracking", "case0_depth",
            "case0_cos_0"} <= files

    from flexam_tpu_torch.io.checkpoints import save_pytree
    path = str(tmp_path / "stack.npz")
    save_pytree(path, {"vae": stack["vae_params"], "dit": stack["dit_params"]})
    with open(path + ".json", "w") as f:
        json.dump({"version": T.CACHE_VERSION, "ctx": ctx.tolist(),
                   "vae_losses": [1.0], "dit_losses": [2.0],
                   "geometry": stack["geometry"]}, f)
    back = T.cached_stack(path, T.CACHE_VERSION, device="cpu")
    for name in ("vae_params", "dit_params"):
        got = jax.tree_util.tree_leaves(_np(back[name]))
        want = jax.tree_util.tree_leaves(_np(stack[name]))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert back["dit_losses"] == [2.0]
    assert T.default_cache_path() != J.default_cache_path()
