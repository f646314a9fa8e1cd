"""The port's DepthCrafter (`flexam_tpu_torch/perception/depthcrafter{,
_model}.py`), the registry's `depthcrafter` and `onnx` backends
(`perception/depth.py`), and the byte-bounded exact attention branch
(`ops/flash_attention.attention_plain`) on the CPU.

  * `attention_plain` over chunks of rows and of batch elements gives one
    whole chunk's values (up to the order of the matmuls' sums);
  * the tiny denoiser against JAX's (fp32), JAX's noise (the latents and
    the pixel noise augmentation from `PRNGKey(seed)`) handed across as
    `latents=` / `aug_noise=`: within 1e-4 of the output's [0, 1] range;
    the CLIP image-embedding function and the loaders (spatial and
    temporal VAE files, FLEXAM_SVD_CLIP) against JAX's;
  * `predict_depthcrafter`'s resize, windows, cross-fade, mono reduction
    and restore against JAX's with one shared fake denoiser (float frames
    resized by `media.resize_frames_linear` where JAX calls cv2.resize:
    within 1e-5);
  * the `onnx` hook against a `cv2.dnn` + `cv2.resize` oracle on a tiny
    graph (onnxruntime, which JAX's hook imports, is not installed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.models.flux_vae import FluxVAEConfig as JVAECfg
from flexam_tpu.models.svd_unet import SVDUNetConfig as JUCfg
from flexam_tpu.perception import depthcrafter as JD
from flexam_tpu.perception import depthcrafter_model as JM
from flexam_tpu_torch.ops.flash_attention import attention_plain
from flexam_tpu_torch.perception import depth as tdepth
from flexam_tpu_torch.perception import depthcrafter as TD
from flexam_tpu_torch.perception import depthcrafter_model as TM
from tests.test_torch_flux import crossed, randomize, to_jax

JTINY_VAE = JVAECfg(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                    scale_factor=0.18215, shift_factor=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The exact branch, bounded by bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget,what", [
    (4 * 3 * 40 * 7, "rows"),         # 7 rows of every batch element
    (4 * 3 * 40 * 3, "batch"),        # one row of each of 3 elements
    (4 * 3 * 40 - 4, "one_row"),      # under one row: single rows
], ids=["rows", "batch", "one_row"])
def test_attention_plain_chunking_equals_one_chunk(budget, what):
    """Chunked by rows, by batch elements, and row by row under a budget
    below one row: the whole computation's values, with a k_len mask and a
    keep_rows mask (B5's plain version) as well. BLAS sums the products of
    a smaller matmul in another order, so fp32 values may move by a few
    ulps (up to 8.3e-7 of values below 1 here): rtol 1e-6, atol 2e-6."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(5, 33, 3, 16, generator=g)
    k = torch.randn(5, 40, 3, 16, generator=g)
    v = torch.randn(5, 40, 3, 16, generator=g)
    k_len = torch.tensor([40, 17, 1, 39, 25])
    keep = torch.rand(5, 1, 33, 40, generator=g) > 0.3
    keep[..., 0] = True

    def rows(a, b):
        return keep[:, :, a:b]

    for kw in ({}, {"k_len": k_len}, {"keep_rows": rows}):
        whole = attention_plain(q, k, v, budget=1 << 40, **kw)
        np.testing.assert_allclose(
            attention_plain(q, k, v, budget=budget, **kw).numpy(),
            whole.numpy(), rtol=1e-6, atol=2e-6)


def test_attention_plain_bound_at_the_unet_shape():
    """At the SVD UNet's first-level spatial shape (32 frames x 5 heads x
    7,168 keys) the default budget splits the batch: no chunk's fp32
    logits exceed 1 GiB (the shapes only; the product is not run)."""
    import importlib
    fa = importlib.import_module("flexam_tpu_torch.ops.flash_attention")
    b, h, lk = 32, 5, 7168
    row = 4 * h * lk
    nb = b if fa.LOGITS_BUDGET >= b * row else fa.LOGITS_BUDGET // row
    rows = min(2048, 7168, fa.LOGITS_BUDGET // (nb * row))
    assert nb == b and rows == 234
    assert nb * h * rows * lk * 4 <= fa.LOGITS_BUDGET
    assert b * h * 2048 * lk * 4 > 9e9       # the row chunk alone: 9.4 GB


# ---------------------------------------------------------------------------
# The denoiser
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(JAX denoiser, port denoiser) over the same random tiny trees."""
    from flexam_tpu_torch.models.flux_vae import init_flux_vae_params
    from flexam_tpu_torch.models.svd_unet import (SVDUNetConfig,
                                                  init_svd_unet_params)
    unet = randomize(init_svd_unet_params(SVDUNetConfig.tiny(), seed=0,
                                          device="cpu"), 1, scale=0.02)
    vae = randomize(init_flux_vae_params(TM.TINY_VAE_CONFIG, seed=2,
                                         device="cpu"), 3, scale=0.02)
    ju, jv = to_jax(unet, conv=True), to_jax(vae, conv=True)
    jd = JM.DepthCrafterDenoiser(ju, jv, cfg=JUCfg.tiny(),
                                 vae_cfg=JTINY_VAE, dtype=jnp.float32)
    td = TM.DepthCrafterDenoiser(crossed(ju), crossed(jv),
                                 cfg=SVDUNetConfig.tiny(),
                                 vae_cfg=TM.TINY_VAE_CONFIG,
                                 dtype=torch.float32, device="cpu")
    return jd, td


def jax_noise(seed, t, h, w):
    """JAX's draws: (latents [1, T, 4, h/2, w/2], aug [T, 3, h, w]) in the
    port's layouts."""
    k_lat, k_aug = jax.random.split(jax.random.PRNGKey(seed))
    aug = np.asarray(jax.random.normal(k_aug, (t, h, w, 3), jnp.float32))
    lat = np.asarray(jax.random.normal(k_lat, (1, t, h // 2, w // 2, 4),
                                       jnp.float32))
    return lat.transpose(0, 1, 4, 2, 3), aug.transpose(0, 3, 1, 2)


def frames_of(t=3, h=16, w=24, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (t, h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("steps,guidance", [(2, 1.2), (1, 3.0)])
def test_denoiser_matches_jax(pair, steps, guidance):
    jd, td = pair
    f = frames_of()
    want = jd(f, guidance_scale=guidance, num_inference_steps=steps)
    lat, aug = jax_noise(jd.seed, *f.shape[:3])
    got = td(f, guidance_scale=guidance, num_inference_steps=steps,
             latents=lat, aug_noise=aug)
    assert got.shape == want.shape == f.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_denoiser_own_noise_and_conditioning(pair):
    """Without explicit noise the port draws from its seed (the same twice);
    the frames and the guidance reach the output."""
    _, td = pair
    f = frames_of()
    a = td(f, num_inference_steps=2)
    np.testing.assert_array_equal(a, td(f, num_inference_steps=2))
    assert np.abs(td(frames_of(seed=1), num_inference_steps=2) - a).max() \
        > 1e-4
    assert np.abs(td(f, guidance_scale=3.0, num_inference_steps=2)
                  - a).max() > 1e-5
    with pytest.raises(ValueError, match="latents"):
        td(f, num_inference_steps=1, latents=np.zeros((1, 3, 4, 2, 2)))


def test_clip_image_embed_fn_matches_jax():
    """The SVD `_encode_image` flow over the ViT (antialiased bicubic 224
    resize of the [-1, 1] frames at this tower's 28 px, CLIP-normalize,
    CLS + post-LN + projection), chunked by frames."""
    from flexam_tpu.models.clip import CLIPVisionConfig as JC
    from flexam_tpu_torch.models.clip import CLIPVisionConfig, init_vit_params
    cfg = CLIPVisionConfig(image_size=28, patch_size=14, dim=32,
                           num_heads=2, num_layers=2, activation="quick_gelu")
    tree = randomize(init_vit_params(cfg, seed=0, device="cpu",
                                     proj_dim=16), 4)
    jp = to_jax(tree)
    jfn = JM.make_clip_image_embed_fn(jp, JC(**cfg.__dict__),
                                      dtype=jnp.float32, chunk=2)
    tfn = TM.make_clip_image_embed_fn(crossed(jp), cfg, dtype=torch.float32,
                                      chunk=2, device="cpu")
    f = frames_of(t=3, h=20, w=36)
    np.testing.assert_allclose(tfn(f), jfn(f), rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    """The tiny denoiser's UNet, its spatial VAE, a temporal VAE and a CLIP
    tower, written in the published names."""
    from flexam_tpu_torch.models.clip import CLIPVisionConfig, init_vit_params
    from flexam_tpu_torch.models.svd_vae import (
        TemporalDecoderConfig, init_temporal_decoder_params)
    from flexam_tpu_torch.testing import write_depthcrafter_files
    _, td = pair
    d = tmp_path_factory.mktemp("depthcrafter_files")
    clip = randomize(init_vit_params(
        CLIPVisionConfig(image_size=28, patch_size=14, dim=32, num_heads=2,
                         num_layers=2), seed=5, device="cpu", proj_dim=48), 6)
    spatial = write_depthcrafter_files(str(d), td.params, td.vae_params,
                                       clip, clip_heads=2,
                                       clip_act="quick_gelu")
    g = torch.Generator().manual_seed(7)
    temporal = {"encoder": td.vae_params["encoder"],
                "quant_conv": {"w": 0.3 * torch.randn(8, 8, 1, 1,
                                                      generator=g),
                               "b": torch.zeros(8)},
                "decoder": randomize(init_temporal_decoder_params(
                    TemporalDecoderConfig.tiny(), seed=8, device="cpu"), 9,
                    scale=0.02)}
    (d / "t").mkdir()
    temporal = write_depthcrafter_files(str(d / "t"), td.params, temporal)
    return {"spatial": spatial, "temporal": temporal}


@pytest.mark.parametrize("vae", ["spatial", "temporal"])
def test_load_depthcrafter_denoiser_matches_jax(pair, files, vae):
    """Both loaders on the same files (the temporal decoder picked by
    `decoder.time_conv_out`, FLEXAM_SVD_CLIP's tower with its config.json
    beside it): the same denoiser output for the same noise."""
    from flexam_tpu_torch.models.svd_unet import SVDUNetConfig
    paths = files[vae]
    clip = files["spatial"]["clip"]
    jd = JM.load_depthcrafter_denoiser(paths["unet"], paths["vae"],
                                       cfg=JUCfg.tiny(), vae_cfg=JTINY_VAE,
                                       dtype=jnp.float32, clip=clip)
    td = TM.load_depthcrafter_denoiser(paths["unet"], paths["vae"],
                                       cfg=SVDUNetConfig.tiny(),
                                       vae_cfg=TM.TINY_VAE_CONFIG,
                                       dtype=torch.float32, device="cpu",
                                       clip=clip)
    assert (td.decode_fn is None) == (jd.decode_fn is None) == (
        vae == "spatial")
    f = frames_of(t=2, h=16, w=16, seed=3)
    lat, aug = jax_noise(jd.seed, *f.shape[:3])
    np.testing.assert_allclose(
        td(f, num_inference_steps=1, latents=lat, aug_noise=aug),
        jd(f, num_inference_steps=1), rtol=0, atol=1e-4)


def test_loader_refusals(tmp_path, monkeypatch):
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    monkeypatch.delenv("FLEXAM_DEPTHCRAFTER_CKPT", raising=False)
    monkeypatch.delenv("FLEXAM_SVD_VAE", raising=False)
    with pytest.raises(FileNotFoundError, match="FLEXAM_DEPTHCRAFTER_CKPT"):
        TM.load_depthcrafter_denoiser(device="cpu")
    bad = str(tmp_path / "bad.safetensors")
    save_safetensors(bad, {"nonsense": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="coverage"):
        TM.load_depthcrafter_denoiser(bad, bad, device="cpu")


# ---------------------------------------------------------------------------
# The surface, the registry and the onnx hook
# ---------------------------------------------------------------------------

def fake_denoise(frames, guidance_scale=1.2, num_inference_steps=25):
    """A smooth function of the frames (JAX's test's stand-in pipe)."""
    f = np.asarray(frames, np.float32)
    base = f.mean(-1, keepdims=True)
    return np.concatenate(
        [base, np.sqrt(base + 0.25), 0.5 + 0.3 * np.sin(3.0 * base)], -1)


@pytest.mark.parametrize("shape,max_res,window,overlap", [
    ((7, 3, 96, 128), 1024, 110, 25),
    ((5, 100, 150, 3), 1024, 110, 25),
    ((4, 3, 480, 720), 256, 110, 25),
    ((23, 40, 70, 3), 1024, 8, 3),
], ids=["chw", "hwc", "max_res", "windows"])
def test_predict_depthcrafter_matches_jax(shape, max_res, window, overlap):
    """Pixel-byte and [0, 1] input, the 64-multiple rules, the windows and
    their cross-fade, the mono reduction and the nearest restore."""
    video = np.random.RandomState(0).randint(0, 255, size=shape).astype(
        np.float32)
    if shape[0] == 23:
        video /= 255.0
    calls = []

    def fn(frames, **kw):
        calls.append(frames.shape)
        return fake_denoise(frames, **kw)

    kw = dict(max_res=max_res, window_size=window, overlap=overlap)
    got = TD.predict_depthcrafter(video, fn, **kw)
    want = JD.predict_depthcrafter(video, fake_denoise, **kw)
    assert got.shape == want.shape == (shape[0],) + (
        shape[2:] if shape[1] == 3 else shape[1:3])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if shape[0] == 23:
        assert [c[0] for c in calls] == [8, 8, 8, 8]   # starts 0, 5, 10, 15
    assert TD._resize_dims(*shape[-2:] if shape[1] == 3 else shape[1:3],
                           max_res) == JD._resize_dims(
        *shape[-2:] if shape[1] == 3 else shape[1:3], max_res)


def test_registry_depthcrafter(pair, files, monkeypatch):
    """`estimate_depth(backend="depthcrafter")`: without a checkpoint, the
    substitute denoiser (the default depth stack, luminance here) as JAX's;
    with FLEXAM_DEPTHCRAFTER_CKPT + FLEXAM_SVD_VAE, the SVD UNet loop on
    the caller's device, equal to the loaded denoiser's own run."""
    from flexam_tpu.perception import depth as jdepth
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_ZOE_CKPT", "FLEXAM_DAV2_CKPT",
              "FLEXAM_DEPTHCRAFTER_CKPT", "FLEXAM_SVD_VAE",
              "FLEXAM_SVD_CLIP"):
        monkeypatch.delenv(k, raising=False)
    video = frames_of(t=3, h=40, w=60, seed=4)
    np.testing.assert_allclose(
        tdepth.estimate_depth(video, backend="depthcrafter"),
        jdepth.estimate_depth(video, backend="depthcrafter"),
        rtol=0, atol=1e-5)
    from flexam_tpu_torch.models.svd_unet import SVDUNetConfig
    import functools
    monkeypatch.setattr(TM, "load_depthcrafter_denoiser", functools.partial(
        TM.load_depthcrafter_denoiser, cfg=SVDUNetConfig.tiny(),
        vae_cfg=TM.TINY_VAE_CONFIG))
    monkeypatch.setenv("FLEXAM_DEPTHCRAFTER_CKPT", files["spatial"]["unet"])
    monkeypatch.setenv("FLEXAM_SVD_VAE", files["spatial"]["vae"])
    monkeypatch.setenv("FLEXAM_DEPTH_BACKEND", "depthcrafter")
    got = tdepth.estimate_depth(video, device="cpu", dtype=torch.float32,
                                num_inference_steps=1)
    dn = TM.load_depthcrafter_denoiser(device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(got, TD.predict_depthcrafter(
        video, dn, num_inference_steps=1))
    assert got.shape == (3, 40, 60)


@pytest.mark.parametrize("size", [32, 24])
def test_onnx_hook_matches_cv2_dnn(tmp_path, monkeypatch, size):
    """The hook on a tiny depth graph against JAX's algorithm with
    `cv2.dnn` in onnxruntime's place: each frame resized to size x size
    (INTER_LINEAR), run, squeezed and resized back. Without
    FLEXAM_DEPTH_ONNX both raise JAX's RuntimeError."""
    cv2 = pytest.importorskip("cv2")
    from flexam_tpu_torch.testing import tiny_depth_onnx
    path = tmp_path / "depth.onnx"
    path.write_bytes(tiny_depth_onnx(seed=0, size=size))
    video = frames_of(t=2, h=30, w=44, seed=5)
    monkeypatch.delenv("FLEXAM_DEPTH_ONNX", raising=False)
    with pytest.raises(RuntimeError, match="FLEXAM_DEPTH_ONNX"):
        tdepth.estimate_depth(video, backend="onnx", size=size,
                              device="cpu")
    monkeypatch.setenv("FLEXAM_DEPTH_ONNX", str(path))
    got = tdepth.estimate_depth(video, backend="onnx", size=size,
                                device="cpu")
    net = cv2.dnn.readNetFromONNX(str(path))
    want = np.zeros((2, 30, 44), np.float32)
    for i, frame in enumerate(video):
        x = cv2.resize(frame, (size, size)).transpose(2, 0, 1)[None]
        net.setInput(x.astype(np.float32))
        d = net.forward()[0]
        want[i] = cv2.resize(np.squeeze(d), (44, 30))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
