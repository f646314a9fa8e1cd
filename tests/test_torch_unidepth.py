"""The port's UniDepth V2 (`flexam_tpu_torch/perception/unidepth.py`) and
depth registry (`perception/depth.py`) against the JAX package's, on the
CPU at the tiny geometry `tests/test_unidepth.py` uses (`TINY`), with the
weights crossed through `io.convert.from_jax_params`.

Module outputs in fp32 are held at rtol 2e-4 / atol 1e-5 (intrinsics,
whose focal lengths are ~60 px, at atol 1e-4). The video fast path rounds
the depth to float16 on both sides, as JAX ships it: there the two agree
to one float16 step, the most that a float32 difference at a rounding tie
can move a value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.perception import depth as jdepth
from flexam_tpu.perception import unidepth as J
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.perception import depth as tdepth
from flexam_tpu_torch.perception import unidepth as T
from tests.test_unidepth import TINY

TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These modules run thousands of small torch ops; beside the other
    test workers, torch's intra-op threads would oversubscribe the cores
    and stall at every op's barrier, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(tree, key=""):
    """The port's tree in JAX's layout: HWIO kernels, except the
    ConvTranspose kernels (`process_features`), torch-layout in both."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v, k if key != "process_features" else key)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_tree(v, key) for v in tree]
    a = tree.numpy()
    if a.ndim == 4 and key != "process_features":
        a = a.transpose(2, 3, 1, 0)
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def models():
    """Both models on one set of weights (the port's init, crossed to JAX's
    layout and back through from_jax_params)."""
    tcfg = T.UniDepthV2Config(**TINY)
    seed = T.UniDepthV2(tcfg, seed=3, device="cpu")
    jp = _jax_tree(seed.params)
    jm = J.UniDepthV2(J.UniDepthV2Config(**TINY), params=jp)
    tm = T.UniDepthV2(tcfg, params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"), device="cpu")
    return jm, tm


@pytest.mark.parametrize("h,w", [(30, 44), (24, 70)],
                         ids=["inside_ratio", "padded"])
def test_infer_matches_jax(models, h, w):
    """`infer(rgb * 255)`: depth, confidence, points, rays and the
    rescaled intrinsics; the 24x70 frame lies outside the ratio bounds, so
    it is padded before the resize and cropped after."""
    jm, tm = models
    rgb = np.random.RandomState(4).rand(3, 3, h, w).astype(np.float32) * 255
    want = jm.infer(rgb)
    got = tm.infer(torch.from_numpy(rgb))
    assert set(got) == set(want)
    for k in ("depth", "confidence", "points", "rays"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_allclose(got["intrinsics"], want["intrinsics"],
                               rtol=2e-4, atol=1e-4)
    fast_j = jm.infer(rgb, keys=("depth",))["depth"]
    fast_t = tm.infer(rgb, keys=("depth",))["depth"]
    step = np.spacing(np.abs(fast_j).astype(np.float16)).astype(np.float32)
    assert (np.abs(fast_t - fast_j) <= step).all()
    assert (fast_t == fast_j).mean() > 0.99


def test_encoder_and_decoder_match_jax(models):
    """The ViT's slice features and cls tokens, then the decoder's dict,
    on one normalized input."""
    jm, tm = models
    cfg = tm.cfg
    x = np.random.RandomState(5).randn(2, 28, 42, 3).astype(np.float32)
    fj, cj = jax.jit(J.encode_image, static_argnums=2)(
        jm.params["pixel_encoder"], jnp.asarray(x), jm.cfg)
    ft, ct = T.encode_image(tm.params["pixel_encoder"], torch.from_numpy(x),
                            cfg)
    for a, b in zip(ft + ct, fj + cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)
    want = jax.jit(J.decode, static_argnums=(3, 4))(
        jm.params["pixel_decoder"], fj, cj, (28, 42), jm.cfg)
    got = T.decode(tm.params["pixel_decoder"], ft, ct, (28, 42), cfg)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=1e-4, err_msg=k)
    only = T.decode(tm.params["pixel_decoder"], ft, ct, (28, 42), cfg,
                    depth_only=True)
    np.testing.assert_array_equal(only["depth"].numpy(),
                                  got["depth"].numpy())


def test_bicubic_pos_embed_and_ray_embedding_match_jax(models):
    """The pos-embed grid's bicubic resize (Keys a = -0.5, not torch's
    -0.75), and the rays' antialiased downsample with the fourier
    embedding."""
    jm, tm = models
    pe = jm.params["pixel_encoder"]["pos_embed"]
    for h0, w0 in ((3, 5), (1, 4), (2, 2)):
        np.testing.assert_allclose(
            T._interp_pos_embed(tm.params["pixel_encoder"]["pos_embed"],
                                h0, w0).numpy(),
            np.asarray(J._interp_pos_embed(pe, h0, w0)), **TOL)
    intr = np.asarray([[40.0, 38.0, 20.0, 15.0]], np.float32)
    rj = J._rays_from_intrinsics(jnp.asarray(intr), (30, 44))
    rt = T._rays_from_intrinsics(torch.from_numpy(intr), (30, 44))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
    np.testing.assert_allclose(
        T._embed_rays(rt, (4, 7), (30, 44), 16).numpy(),
        np.asarray(J._embed_rays(rj, (4, 7), (30, 44), 16)), rtol=2e-4,
        atol=1e-4)


def _state_dict(jtree, cfg):
    """A reference-named state dict (HF `unidepth-v2-vitl14` names, torch
    layouts) of a JAX UniDepth tree: the inverse of the loaders' map."""
    sd = {}

    def put(prefix, p, conv=False):
        for k, v in p.items():
            a = np.asarray(v)
            if conv and k == "weight":
                a = a.transpose(3, 2, 0, 1)
            sd[f"{prefix}.{k}"] = torch.from_numpy(np.ascontiguousarray(a))

    def mlp(prefix, p):
        for k in ("norm", "proj1", "proj2"):
            put(f"{prefix}.{k}", p[k])

    def ablock(prefix, p):
        for k in ("norm_attnx", "norm_attnctx", "q", "kv", "out"):
            put(f"{prefix}.{k}", p[k])
        mlp(f"{prefix}.mlp", p["mlp"])
        for k in ("ls1", "ls2"):
            if k in p:
                put(f"{prefix}.{k}", p[k])

    e, d = jtree["pixel_encoder"], jtree["pixel_decoder"]
    for k in ("cls_token", "pos_embed", "register_tokens"):
        sd[f"pixel_encoder.{k}"] = torch.from_numpy(np.asarray(e[k]))
    put("pixel_encoder.patch_embed.proj", e["patch_embed"]["proj"], True)
    for i, bp in enumerate(e["blocks"]):
        pre = f"pixel_encoder.blocks.{i}"
        for k in ("norm1", "norm2", "ls1", "ls2"):
            put(f"{pre}.{k}", bp[k])
        for k in ("qkv", "proj"):
            put(f"{pre}.attn.{k}", bp["attn"][k])
        for k in ("fc1", "fc2"):
            put(f"{pre}.mlp.{k}", bp["mlp"][k])
    pd = "pixel_decoder"
    for i in range(cfg.num_slices):
        put(f"{pd}.input_adapter.input_adapters.{i}", d["input_adapter"][i])
        put(f"{pd}.camera_token_adapter.input_adapters.{i}",
            d["camera_token_adapter"][i])
    sd[f"{pd}.level_embeds"] = torch.from_numpy(np.asarray(
        d["level_embeds"]))
    cl = d["camera_layer"]
    sd[f"{pd}.camera_layer.latents_pos"] = torch.from_numpy(
        np.asarray(cl["latents_pos"]))
    mlp(f"{pd}.camera_layer.project", cl["project"])
    mlp(f"{pd}.camera_layer.out_pinhole", cl["out_pinhole"])
    for k in ("aggregate1", "aggregate2"):
        ablock(f"{pd}.camera_layer.{k}", cl[k])
    dl, pl = d["depth_layer"], f"{pd}.depth_layer"
    put(f"{pl}.to_latents", dl["to_latents"])
    for i, p in enumerate(dl["prompt_camera"]):
        ablock(f"{pl}.prompt_camera.{i}.layers.0", p)
    for i, p in enumerate(dl["process_features"]):
        put(f"{pl}.process_features.{i}", p)
    for i, up in enumerate(dl["ups"]):
        put(f"{pl}.ups.{i}.up.0", up["up"], True)
        for j, c in enumerate(up["convs"]):
            put(f"{pl}.ups.{i}.convs.{j}.conv1", c["conv1"], True)
            put(f"{pl}.ups.{i}.convs.{j}.conv2", c["conv2"], True)
            sd[f"{pl}.ups.{i}.convs.{j}.gamma"] = torch.from_numpy(
                np.asarray(c["gamma"]))
    last = len(dl["ups"]) - 1
    put(f"{pl}.depth_mlp.{last}.0", dl["depth_mlp_last"]["norm"])
    put(f"{pl}.depth_mlp.{last}.1", dl["depth_mlp_last"]["proj"])
    put(f"{pl}.confidence_mlp.0", dl["confidence_mlp"]["norm"])
    put(f"{pl}.confidence_mlp.1", dl["confidence_mlp"]["proj"])
    for k in ("to_depth_lr", "to_confidence_lr"):
        put(f"{pl}.{k}", dl[k], True)
    for k in ("to_depth_hr", "to_confidence_hr"):
        put(f"{pl}.{k}.0", dl[k][0], True)
        put(f"{pl}.{k}.2", dl[k][1], True)
    return sd


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_loaders_match_jax(models, tmp_path, fmt):
    """A reference-named checkpoint (`model.safetensors` through the
    port's own reader, or a `{"model": ...}` .pth) loads in both packages
    to the same leaves, and the port's model infers JAX's depth; the
    verify_ckpt tool passes it and fails a file missing a tensor."""
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    from flexam_tpu_torch.tools import verify_ckpt
    jm, tm = models
    sd = _state_dict(jm.params, tm.cfg)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "safetensors":
        save_safetensors(path, sd)
        jpath = path
    else:
        torch.save({"model": sd}, path)
        jpath = path
    jl = J.load_unidepth(jpath, J.UniDepthV2Config(**TINY))
    tl = T.load_unidepth(str(tmp_path) if fmt == "safetensors" else path,
                         tm.cfg, device="cpu")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jl.params),
                           "cpu")
    from flexam_tpu_torch.perception.densetrack3d import _jax_leaves
    got_leaves, want_leaves = _jax_leaves(tl.params), _jax_leaves(want)
    for (pa, a), (pb, b) in zip(got_leaves, want_leaves):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    rgb = np.random.RandomState(6).rand(2, 3, 28, 40).astype(np.float32)
    np.testing.assert_allclose(tl.infer(rgb * 255)["depth"],
                               jl.infer(rgb * 255)["depth"], **TOL)
    import flexam_tpu_torch.perception.unidepth as tu
    orig = tu.UniDepthV2Config
    try:
        tu.UniDepthV2Config = lambda: tm.cfg
        assert verify_ckpt.verify("unidepth", path, "cpu") is True
        sd.pop("pixel_decoder.level_embeds")
        bad = str(tmp_path / "bad.pth")
        torch.save(sd, bad)
        assert verify_ckpt.verify("unidepth", bad, "cpu") is False
    finally:
        tu.UniDepthV2Config = orig


def test_depth_registry_matches_jax(models, monkeypatch, tmp_path):
    """Backends by name and the selection order (argument, then
    FLEXAM_DEPTH_BACKEND, then the checkpoints that exist); the unidepth
    backend against JAX's on a video, its model cached per checkpoint and
    device; zoe and dav2 / dav are live; onnx raises JAX's RuntimeError
    without FLEXAM_DEPTH_ONNX, and depthcrafter is live: it refuses this
    28-row clip (rounded to 0 rows) as JAX's does
    (`tests/test_torch_depthcrafter.py` holds both to JAX)."""
    jm, tm = models
    video = np.random.RandomState(7).rand(5, 28, 40, 3).astype(np.float32)
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_ZOE_CKPT", "FLEXAM_DAV2_CKPT"):
        monkeypatch.delenv(k, raising=False)
    np.testing.assert_array_equal(tdepth.estimate_depth(video),
                                  jdepth.estimate_depth(video))
    np.testing.assert_array_equal(
        tdepth.estimate_depth(video[None].transpose(0, 4, 1, 2, 3),
                              backend="luminance"),
        jdepth.estimate_depth(video, backend="luminance"))
    got = tdepth.estimate_depth(video, backend="unidepth", model=tm, chunk=2)
    want = jdepth.estimate_depth(video, backend="unidepth", model=jm,
                                 chunk=3)
    step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    assert got.shape == (5, 28, 40) and (np.abs(got - want) <= step).all()
    # the video's chunking does not change a value
    np.testing.assert_array_equal(
        T.predict_depth_video(tm, video, chunk=5), got)
    assert T.video_chunk(tm, 512, 896) >= 1
    flagship = T.UniDepthV2.__new__(T.UniDepthV2)
    flagship.cfg, flagship.resolution_level = T.UniDepthV2Config(), 9
    assert flagship.geometry(512, 896)[3] == (574, 994)
    assert T.video_chunk(flagship, 512, 896) == 11

    calls = []
    tdepth.register_depth_backend("probe", lambda v, **kw: (
        calls.append(sorted(kw)), v[..., 0])[1])
    monkeypatch.setenv("FLEXAM_DEPTH_BACKEND", "probe")
    np.testing.assert_array_equal(tdepth.estimate_depth(video, device="cpu"),
                                  video[..., 0])
    assert calls == [["device"]]
    monkeypatch.delenv("FLEXAM_DEPTH_BACKEND")
    del tdepth.DEPTH_BACKENDS["probe"]

    ckpt = tmp_path / "unidepth.safetensors"
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    save_safetensors(str(ckpt), _state_dict(jm.params, tm.cfg))
    monkeypatch.setenv("FLEXAM_UNIDEPTH_CKPT", str(ckpt))
    monkeypatch.setattr(T, "UniDepthV2Config", lambda: tm.cfg)
    T._BACKEND_CACHE.clear()
    first = tdepth.estimate_depth(video, device="cpu")   # picks unidepth
    np.testing.assert_array_equal(first, got)
    assert list(T._BACKEND_CACHE) == [(str(ckpt), "cpu")]
    cached = T._BACKEND_CACHE[(str(ckpt), "cpu")]
    tdepth.estimate_depth(video, device="cpu")
    assert T._BACKEND_CACHE[(str(ckpt), "cpu")] is cached
    T._BACKEND_CACHE.clear()

    with pytest.raises(KeyError):
        tdepth.estimate_depth(video, backend="nope")
    monkeypatch.delenv("FLEXAM_DEPTH_ONNX", raising=False)
    with pytest.raises(RuntimeError, match="FLEXAM_DEPTH_ONNX"):
        tdepth.estimate_depth(video, backend="onnx", device="cpu")
    monkeypatch.delenv("FLEXAM_DEPTHCRAFTER_CKPT", raising=False)
    with pytest.raises(ValueError, match="Invalid dimensions: 64x0"):
        tdepth.estimate_depth(video, backend="depthcrafter")  # 28 rows
    with pytest.raises(ValueError, match="Invalid dimensions: 64x0"):
        jdepth.estimate_depth(video, backend="depthcrafter")
    # zoe, dav2 and dav are live: zoe runs the model it is given, dav2 /
    # dav read FLEXAM_DAV2_CKPT, which is unset here (a KeyError, as JAX's)
    from flexam_tpu_torch.perception.zoedepth import ZoeDepth, \
        tiny_zoe_config
    zoe = tdepth.estimate_depth(video, backend="zoe", model=ZoeDepth(
        tiny_zoe_config(), device="cpu"))
    assert zoe.shape == (5, 28, 40) and np.isfinite(zoe).all()
    for name in ("dav2", "dav"):
        with pytest.raises(KeyError, match="FLEXAM_DAV2_CKPT"):
            tdepth.estimate_depth(video, backend=name, device="cpu")
    assert set(tdepth.DEPTH_BACKENDS) == set(jdepth.DEPTH_BACKENDS)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.UniDepthV2(T.UniDepthV2Config(**TINY))
