"""The port's conditioning from tracks against the JAX package, on the CPU:
`prepare_conditioning_from_tracks` (device rasterizer, masked-video
producers, whole-clip and streamed encodes) and `generate_from_cond` on its
dict.

Weights are the JAX init's (through `from_jax_params`); tracks, frames,
masks and noise are made from numpy seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.models import dit as jdit
from flexam_tpu.models import vae as jvae
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                           rasterize_cos_videos,
                                           rasterize_depth_video,
                                           rasterize_tracking_video)
from flexam_tpu_torch.io.convert import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: beside the other test workers, torch's
    intra-op threads would oversubscribe the cores and stall at every op's
    barrier (tests/test_torch_video_tracking.py), so one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-4, atol=1e-5)
T, H, W = 9, 32, 32
KEYS = ("control_latents", "mask_latents", "masked_video_latents",
        "additional_control", "ref_latents", "mask_ti2v")


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


@pytest.fixture(scope="module")
def pipes():
    """A JAX and a port pipeline over the same tiny weights (fp32)."""
    cfg = jcfg.tiny_test_config()
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    dp = jdit.init_dit_params(k1, cfg.dit, dtype=jnp.float32)
    vp = jvae.init_vae_params(k2, cfg.vae)
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=dp, vae_params=vp),
        compute_dtype=jnp.float32)
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tcfg.tiny_test_config(),
                           dit_params=_port(dp), vae_params=_port(vp)),
        device="cpu")
    return jp, tp


def _tracks(t=T, n=60, seed=4):
    """Drifting points with distinct depths, some invisible, a few off the
    frame."""
    rng = np.random.RandomState(seed)
    base = np.stack([rng.uniform(-2, W + 2, n), rng.uniform(-2, H + 2, n),
                     np.zeros(n)], axis=1)
    drift = rng.uniform(-2, 2, (t, 1, 3)).cumsum(0)
    tracks = (base[None] + drift).astype(np.float32)
    flat = tracks.reshape(-1, 3)
    flat[:, 2] = np.linspace(0.5, 3.0, flat.shape[0])[
        rng.permutation(flat.shape[0])]
    return tracks, rng.rand(t, n) > 0.2


def _frames(t, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (1, 3, t, H, W)) / 255.0).astype(np.float32)


def _fg_inputs(t=T, seed=3):
    video = _frames(t, seed)
    mask01 = np.zeros((1, 1, t, H, W), np.float32)
    mask01[:, :, :, : H // 2] = 1.0
    mask01[:, :, ::3, :, : W // 4] = 1.0
    return video, mask01, mask01[0, 0].copy()


def _assert_cond_matches(cond, jcond):
    assert cond["first_frame_known"] == jcond["first_frame_known"]
    assert cond["per_token_t"] == jcond["per_token_t"]
    assert tuple(cond["latent_shape"]) == tuple(jcond["latent_shape"])
    for k in KEYS:
        assert cond[k].device.type == "cpu"
        np.testing.assert_allclose(cond[k].numpy(), np.asarray(jcond[k]),
                                   err_msg=k, **F32)


def _both(pipes, *args, **kw):
    jp, tp = pipes
    return (tp.prepare_conditioning_from_tracks(*args, **kw),
            jp.prepare_conditioning_from_tracks(*args, **kw))


def test_full_edit_from_first_frame(pipes):
    tracks, vis = _tracks()
    first = _frames(1, 11)
    cond, jcond = _both(pipes, tracks, vis, H, W, first_frame=first)
    assert cond["first_frame_known"] and cond["per_token_t"]
    assert cond["latent_shape"] == (8, 3, 2, 2)
    _assert_cond_matches(cond, jcond)


def test_foreground_edit_with_mask_video(pipes):
    tracks, vis = _tracks(seed=9)
    video, mask01, raster_mask = _fg_inputs()
    cond, jcond = _both(pipes, tracks, vis, H, W,
                        generate_type="foreground_edit",
                        raster_mask=raster_mask, video=video,
                        mask_video=mask01, ref_image=video[:, :, :1])
    assert cond["per_token_t"] and not cond["first_frame_known"]
    _assert_cond_matches(cond, jcond)


@pytest.mark.parametrize("gen_type", ["background_edit", "full_edit"])
def test_video_without_mask_video(pipes, gen_type):
    """A video and no mask video: zero mask and masked-video latents, an
    all-ones TI2V mask, no per-token timestep; no reference image."""
    tracks, vis = _tracks(seed=5)
    video, _, raster_mask = _fg_inputs(seed=6)
    cond, jcond = _both(pipes, tracks, vis, H, W, generate_type=gen_type,
                        raster_mask=raster_mask, video=video, point_wise=2)
    assert not cond["per_token_t"] and not cond["first_frame_known"]
    assert not cond["masked_video_latents"].any()
    assert not cond["ref_latents"].any()
    _assert_cond_matches(cond, jcond)


@pytest.mark.parametrize("mode", ["full_edit", "foreground_edit"])
def test_streamed_producers(pipes, mode):
    """Above VAE_STREAM_THRESHOLD (lowered on both pipelines) every stream
    is encoded group by group from its producer; 13 frames also take the
    whole-clip path's 9 + 4 grouping below it."""
    jp, tp = pipes
    t = 13
    tracks, vis = _tracks(t=t, seed=8)
    kw = (dict(first_frame=_frames(1, 2)) if mode == "full_edit" else
          dict(zip(("video", "mask_video", "raster_mask"), _fg_inputs(t)),
               generate_type=mode))
    whole = tp.prepare_conditioning_from_tracks(tracks, vis, H, W, **kw)
    old = (jp.VAE_STREAM_THRESHOLD, tp.VAE_STREAM_THRESHOLD)
    try:
        jp.VAE_STREAM_THRESHOLD = tp.VAE_STREAM_THRESHOLD = 1000
        assert tp._use_streaming(1, t, H, W)
        cond, jcond = _both(pipes, tracks, vis, H, W, **kw)
    finally:
        jp.VAE_STREAM_THRESHOLD, tp.VAE_STREAM_THRESHOLD = old
    _assert_cond_matches(cond, jcond)
    for k in KEYS:
        np.testing.assert_allclose(cond[k].numpy(), whole[k].numpy(),
                                   err_msg=k, **F32)


def test_return_videos(pipes):
    """The rasterized streams come back as host float32 [1, 3, T, H, W] in
    [0, 1]: uint8 planes bit for bit equal to JAX's and to the numpy
    rasterizer's, floats within JAX's one ulp; the cond is unchanged."""
    tracks, vis = _tracks(seed=12)
    video, mask01, raster_mask = _fg_inputs(seed=13)
    kw = dict(generate_type="foreground_edit", raster_mask=raster_mask,
              video=video, mask_video=mask01, return_videos=True)
    cond, jcond = _both(pipes, tracks, vis, H, W, **kw)
    _assert_cond_matches(cond, jcond)
    got, want = cond["videos"], jcond["videos"]
    assert sorted(got) == sorted(want) == sorted(
        ["tracking", "depth"] + [f"cos_{i}" for i in range(4)])
    fg = dict(mask_video=raster_mask, generate_type="foreground_edit")
    enc = cosine_positional_encoding(tracks, H, W)
    host = {"tracking": rasterize_tracking_video(tracks, vis, H, W, **fg),
            "depth": rasterize_depth_video(tracks, vis, H, W, **fg)}
    host.update({f"cos_{i}": v for i, v in
                 rasterize_cos_videos(enc, tracks, vis, H, W, **fg).items()})

    def u8(v):
        return np.round(v * 255).astype(np.uint8)

    for k, v in got.items():
        assert isinstance(v, np.ndarray) and v.dtype == np.float32
        assert v.shape == (1, 3, T, H, W)
        np.testing.assert_array_equal(u8(v), u8(np.asarray(want[k])),
                                      err_msg=k)
        np.testing.assert_array_equal(u8(v), u8(host[k]), err_msg=k)
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1.2e-7,
                                   err_msg=k)
    plain = pipes[1].prepare_conditioning_from_tracks(
        tracks, vis, H, W, **{**kw, "return_videos": False})
    assert "videos" not in plain
    for k in KEYS:
        np.testing.assert_array_equal(plain[k].numpy(), cond[k].numpy())


def test_matches_host_path(pipes):
    """Against the port's own `prepare_conditioning` fed the numpy-rasterized
    videos: equal up to the host path's fp16 rounding of the normalized
    clips (the track path rounds the frame, not the normalized clip), the
    bound of `tests/test_pipeline.py`."""
    _, tp = pipes
    tracks, vis = _tracks()
    first = _frames(1, 11)
    cond = tp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                               first_frame=first)
    enc = cosine_positional_encoding(tracks, H, W)
    cos = rasterize_cos_videos(enc, tracks, vis, H, W)
    mask = np.ones((1, 1, T, H, W), np.float32)
    mask[:, :, 0] = 0.0
    host = tp.prepare_conditioning(
        np.repeat(first, T, axis=2), mask,
        rasterize_tracking_video(tracks, vis, H, W),
        rasterize_depth_video(tracks, vis, H, W),
        [cos[k] for k in sorted(cos)], first)
    assert host["first_frame_known"] == cond["first_frame_known"]
    for k in KEYS:
        np.testing.assert_allclose(cond[k].numpy(), host[k].numpy(),
                                   atol=5e-3, err_msg=k)


def test_needs_video_or_first_frame(pipes):
    tracks, vis = _tracks()
    with pytest.raises(ValueError, match="first_frame"):
        pipes[1].prepare_conditioning_from_tracks(tracks, vis, H, W)


@pytest.mark.parametrize("mode", ["full_edit", "background_edit"])
def test_generate_from_cond_matches_jax(pipes, mode):
    """Denoise + decode on the track path's dict, the noise shared: the
    latents at 1e-4, the decoded uint8 video within one step."""
    jp, tp = pipes
    tracks, vis = _tracks(seed=14)
    kw = (dict(first_frame=_frames(1, 15)) if mode == "full_edit" else
          dict(video=_frames(T, 16), generate_type=mode))
    cond, jcond = _both(pipes, tracks, vis, H, W, **kw)
    ctx = np.random.RandomState(17).randn(2, 16, 64).astype(np.float32)
    noise = np.random.RandomState(18).randn(1, 8, 3, 2, 2).astype(np.float32)
    run = dict(num_inference_steps=2, guidance_scale=6.0, density=0.3)
    jax_lat = np.asarray(jp.denoise(jcond, jnp.asarray(ctx),
                                    latents=jnp.asarray(noise), **run))
    lat = tp.generate_from_cond(cond, torch.from_numpy(ctx), latents=noise,
                                output_type="latent", **run)
    np.testing.assert_allclose(lat, jax_lat, rtol=1e-4, atol=1e-4)
    out = tp.generate_from_cond(cond, torch.from_numpy(ctx), latents=noise,
                                **run)
    jax_video = np.asarray(jp._decode_u8_host(jnp.asarray(jax_lat))
                           ).transpose(0, 4, 1, 2, 3).astype(np.float32) / 255
    assert out.shape == (1, 3, T, H, W)
    np.testing.assert_allclose(out, jax_video, rtol=0, atol=1.01 / 255)
