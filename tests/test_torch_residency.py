"""Weights between host and card, and the decode's choices, against the JAX
package on the CPU: the DiT's offload around the decode (the host copy kept
across cycles, refetched after any write), `generate`'s default offload of
a streamed clip, the decode's group sizes and out-of-memory ladder, the
YUV 4:2:0 fetch and its OpenCV inverse, `save_video_yuv420`, and the
encoder's batch over the conditioning streams.

Weights are the port's init, carried to JAX in its layout (and back through
`from_jax_params`); latents, tracks and frames are made from numpy seeds
and handed to both packages. Streaming is
forced at tiny sizes by lowering VAE_STREAM_THRESHOLD on both pipelines.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import config as jcfg
from flexam_tpu import pipeline as jpipe
from flexam_tpu.models import vae_stream as jvs
from flexam_tpu_torch import config as tcfg
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.io.convert import (from_jax_params, stack_blocks,
                                         tree_leaves)
from flexam_tpu_torch.models import vae_stream as tvs
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.utils.cv import yuv420_to_rgb
from flexam_tpu_torch.utils.media import save_video_yuv420


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops beside the other test workers: one thread
    (tests/test_torch_video_tracking.py says why)."""
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


def _np(tree):
    """A port tree in JAX's layout (stacked blocks), numpy."""
    return jax.tree_util.tree_map(lambda t: t.detach().numpy().copy(),
                                  stack_blocks(tree), is_leaf=torch.is_tensor)


@pytest.fixture(scope="module")
def pipes():
    """A JAX and a port pipeline over the same tiny weights (fp32), drawn
    by the port's inits (JAX's eager inits compile op by op)."""
    cfg = tcfg.tiny_test_config()
    dit = _np(init_dit_params(cfg.dit, seed=42, dtype=torch.float32,
                              device="cpu"))
    vae = _np(init_vae_params(cfg.vae, seed=43, dtype=torch.float32,
                              device="cpu"))
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jcfg.tiny_test_config(),
                           dit_params=jax.tree_util.tree_map(jnp.asarray, dit),
                           vae_params=jax.tree_util.tree_map(jnp.asarray,
                                                             vae)),
        compute_dtype=jnp.float32)
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=cfg, dit_params=_port(dit),
                           vae_params=_port(vae)),
        device="cpu")
    return jp, tp


@pytest.fixture
def streaming(pipes):
    """Both pipelines stream the VAE at the tests' sizes."""
    jp, tp = pipes
    old = (jp.VAE_STREAM_THRESHOLD, tp.VAE_STREAM_THRESHOLD)
    jp.VAE_STREAM_THRESHOLD = tp.VAE_STREAM_THRESHOLD = 1000
    yield
    jp.VAE_STREAM_THRESHOLD, tp.VAE_STREAM_THRESHOLD = old


@pytest.fixture
def dit_kept(pipes):
    """The port's DiT tree is put back after the test (offload cycles
    replace it by copies; the tests also rewrite leaves)."""
    tp = pipes[1]
    tree = tp.models.dit_params
    yield tree
    tp.set_dit_params(tree)


def _latents(seed, lt=5, b=1):
    return (np.random.RandomState(seed).randn(b, 8, lt, 2, 2) * 0.5
            ).astype(np.float32)


def _tracks(t=T, n=60, seed=4):
    rng = np.random.RandomState(seed)
    base = np.stack([rng.uniform(-2, W + 2, n), rng.uniform(-2, H + 2, n),
                     np.linspace(0.5, 3.0, n)], axis=1)
    drift = rng.uniform(-2, 2, (t, 1, 3)).cumsum(0)
    return (base[None] + drift).astype(np.float32), rng.rand(t, n) > 0.2


def _frame(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (1, 3, 1, H, W)) / 255.0).astype(np.float32)


def _cond(pipe, seed=3):
    tracks, vis = _tracks(seed=seed)
    return pipe.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                                 first_frame=_frame(seed + 1))


def _ctx(seed=5):
    return np.random.RandomState(seed).randn(2, 16, 64).astype(np.float32)


def _leaf_values(tree):
    return [t.clone() for t in tree_leaves(tree)]


RUN = dict(num_inference_steps=2, guidance_scale=6.0, density=0.3)


def test_generate_with_forced_offload_and_host_cache(pipes, dit_kept):
    """`test_pipeline.py`'s case on the port: with offload_dit_for_decode
    the decode runs without the DiT, the weights come back equal, the
    second cycle reuses the host copy, and set_dit_params drops it."""
    tp = pipes[1]
    cond = _cond(tp)
    ctx = torch.from_numpy(_ctx())
    noise = _latents(6, lt=3)
    before = _leaf_values(tp.models.dit_params)
    seen = []
    decode = tp.decode_u8

    def spy(lat):
        seen.append(tp.models.dit_params is None)
        return decode(lat)
    tp.decode_u8 = spy
    try:
        out = tp.generate_from_cond(cond, ctx, offload_dit_for_decode=True,
                                    latents=noise, **RUN)
        host1 = tp._dit_host
        out2 = tp.generate_from_cond(cond, ctx, offload_dit_for_decode=True,
                                     latents=noise, **RUN)
    finally:
        del tp.decode_u8
    assert seen == [True, True]
    assert out.shape == (1, 3, T, H, W) and out.dtype == np.float32
    assert 0 <= out.min() and out.max() <= 1
    assert tp.models.dit_params is not None and host1 is not None
    assert tp._dit_host is host1                       # the copy reused
    np.testing.assert_array_equal(out, out2)
    after = tree_leaves(tp.models.dit_params)
    host = tree_leaves(host1)
    for a, b, h in zip(before, after, host):
        assert a.dtype == b.dtype == h.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert h.data_ptr() != b.data_ptr()            # a copy, not a view
    tp.set_dit_params(tp.models.dit_params)
    assert tp._dit_host is None


def test_offload_refetches_after_a_write(pipes, dit_kept):
    """An in-place write to a leaf after an offload cycle, and a leaf put in
    another's place, make the next offload copy again: a restore never
    brings back stale weights."""
    tp = pipes[1]
    tp.offload_dit_to_host()
    tp.restore_dit()
    host1 = tp._dit_host
    tp.offload_dit_to_host()
    tp.restore_dit()
    assert tp._dit_host is host1                       # nothing written
    leaf = tp.models.dit_params["blocks"][0]["self_attn"]["q"]["weight"]
    leaf.mul_(2.0)
    want = leaf.clone()
    tp.offload_dit_to_host()
    assert tp._dit_host is not host1
    tp.restore_dit()
    got = tp.models.dit_params["blocks"][0]["self_attn"]["q"]["weight"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    host2 = tp._dit_host
    tp.models.dit_params["head"]["head"]["bias"] = torch.ones_like(
        tp.models.dit_params["head"]["head"]["bias"])
    tp.offload_dit_to_host()
    assert tp._dit_host is not host2
    tp.restore_dit()
    assert bool((tp.models.dit_params["head"]["head"]["bias"] == 1).all())
    tp.release_dit()
    assert tp.models.dit_params is None and tp._dit_host is None


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_offload_keeps_quantized_leaves(pipes, dit_kept, mode):
    """A quantized tree round-trips as it is: int8 `weight_q` and its
    scales, or float8 storage, come back in their dtypes and values, not
    quantized anew."""
    tp = pipes[1]
    q = tpipe._quantize_dit(_port(pipes[0].models.dit_params), mode,
                            torch.device("cpu"))
    tp.models.dit_params = q
    before = _leaf_values(q)
    narrow = torch.int8 if mode == "int8" else torch.float8_e4m3fn
    assert any(t.dtype == narrow for t in before)
    tp.offload_dit_to_host()
    tp.restore_dit()
    for a, b in zip(before, tree_leaves(tp.models.dit_params)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dtype == narrow else a,
                           b.view(torch.uint8) if b.dtype == narrow else b)


def _group_spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, group_size=4, **kw):
        log.append(group_size)
        return real(*args, group_size=group_size, **kw)
    monkeypatch.setattr(module, name, spy)


def test_default_generate_offloads_and_decodes_in_fours(pipes, streaming,
                                                        dit_kept,
                                                        monkeypatch):
    """With default arguments a streamed clip moves the DiT off the device
    for the decode, which then runs in groups of 4 latent frames, in both
    packages; the videos agree within one uint8 step."""
    jp, tp = pipes
    t = 17
    tracks, vis = _tracks(t=t, seed=8)
    first = _frame(9)
    cond = tp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                               first_frame=first)
    jcond = jp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                                first_frame=first)
    noise = _latents(10, lt=5)
    jgroups, tgroups = [], []
    _group_spy(monkeypatch, jpipe, "vae_decode_streamed_u8", jgroups)
    _group_spy(monkeypatch, tpipe, "vae_decode_streamed_u8", tgroups)
    monkeypatch.setattr(jp, "denoise", functools.partial(
        jp.denoise, latents=jnp.asarray(noise)))
    jvideo = jp.generate_from_cond(jcond, jnp.asarray(_ctx()), **RUN)
    video = tp.generate_from_cond(cond, torch.from_numpy(_ctx()),
                                  latents=noise, **RUN)
    assert jgroups == tgroups == [4]
    assert tp.models.dit_params is not None
    assert video.shape == jvideo.shape == (1, 3, t, H, W)
    assert np.abs(video - np.asarray(jvideo)).max() <= 1 / 255 + 1e-6
    tgroups.clear()
    tp.generate_from_cond(cond, torch.from_numpy(_ctx()), latents=noise,
                          offload_dit_for_decode=False, **RUN)
    assert tgroups == [2]                    # the DiT resident: groups of 2


@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_groups_match_jax(pipes, streaming, monkeypatch, group):
    """FLEXAM_DECODE_GROUP sets the first group in both packages; the float
    streamed decode at that group agrees with JAX's at fp32 tolerance and
    the uint8 video within one step."""
    jp, tp = pipes
    monkeypatch.setenv("FLEXAM_DECODE_GROUP", str(group))
    z = _latents(11)
    jgroups, tgroups = [], []
    _group_spy(monkeypatch, jpipe, "vae_decode_streamed_u8", jgroups)
    _group_spy(monkeypatch, tpipe, "vae_decode_streamed_u8", tgroups)
    got = tp.decode_u8(torch.from_numpy(z)).numpy()
    want = np.asarray(jp._decode_u8_host(jnp.asarray(z))
                      ).transpose(0, 4, 1, 2, 3)
    assert jgroups == tgroups == [group]
    assert tp.decode_group_sizes() == {1: [1], 2: [2, 1], 4: [4, 2, 1]}[group]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    f = tvs.vae_decode_streamed(tp.models.vae_params, tp.cfg.vae,
                                torch.from_numpy(z), group_size=group)
    jf = jvs.vae_decode_streamed(jp.models.vae_params, jp.cfg.vae,
                                 jnp.asarray(z), group_size=group)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=2e-4,
                               atol=2e-4)


def test_decode_ladder_steps_down(pipes, streaming, monkeypatch, capsys):
    """Out of memory at group 4 steps down to 2, printing JAX's warning,
    and gives group 2's video bit for bit; any other error passes through,
    and so does running out on the last size."""
    tp = pipes[1]
    z = torch.from_numpy(_latents(12))
    direct = tvs.vae_decode_streamed_u8(tp.models.vae_params, tp.cfg.vae, z,
                                        group_size=2)
    real = tvs.vae_decode_streamed_u8
    tried = []

    def oom_above(limit, exc=torch.cuda.OutOfMemoryError):
        def fake(*args, group_size=4, **kw):
            tried.append(group_size)
            if group_size > limit:
                raise exc("CUDA out of memory (test)")
            return real(*args, group_size=group_size, **kw)
        return fake

    monkeypatch.setenv("FLEXAM_DECODE_GROUP", "4")
    monkeypatch.setattr(tpipe, "vae_decode_streamed_u8", oom_above(2))
    got = tp.decode_u8(z)
    assert tried == [4, 2]
    assert torch.equal(got, direct)
    assert ("WARNING: streamed decode OOM at group_size=4; retrying smaller"
            in capsys.readouterr().out)

    tried.clear()
    monkeypatch.setattr(tpipe, "vae_decode_streamed_u8",
                        oom_above(2, ValueError))
    with pytest.raises(ValueError):
        tp.decode_u8(z)
    assert tried == [4]

    tried.clear()
    monkeypatch.setattr(tpipe, "vae_decode_streamed_u8", oom_above(0))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tp.decode_u8(z)
    assert tried == [4, 2, 1]


@pytest.mark.parametrize("room,want", [(4, [4, 2, 1]), (2, [2, 1]),
                                       (1, [1])])
def test_decode_starts_at_the_group_that_fits(pipes, streaming, monkeypatch,
                                              capsys, room, want):
    """The device's room (faked) at a group's estimated peak: the decode
    starts at the largest group whose peak fits and never tries a larger
    one (which would run out of memory and leave slower cuDNN plans behind
    for its shapes); the video is that group's, bit for bit, and a step
    below the first size is announced. Room below group 1's peak starts
    at 1 and leaves the error to the ladder."""
    tp = pipes[1]
    z = torch.from_numpy(_latents(12))
    n, _, _, lh, lw = z.shape
    peak = {g: tvs.decode_group_peak_bytes(tp.cfg.vae, n, g, lh, lw,
                                           z.element_size())
            for g in (1, 2, 4)}
    assert peak[1] < peak[2] < peak[4]
    bytes_free = peak[room] if room > 1 else peak[1] - 1
    monkeypatch.setenv("FLEXAM_DECODE_GROUP", "4")
    monkeypatch.setattr(tpipe, "device_room_bytes",
                        lambda device: bytes_free)
    assert tp.decode_group_sizes() == [4, 2, 1]
    assert tp.decode_group_sizes(z) == want
    tried = []
    _group_spy(monkeypatch, tpipe, "vae_decode_streamed_u8", tried)
    got = tp.decode_u8(z)
    assert tried == want[:1]
    direct = tvs.vae_decode_streamed_u8(tp.models.vae_params, tp.cfg.vae, z,
                                        group_size=want[0])
    assert torch.equal(got, direct)
    out = capsys.readouterr().out
    assert (f"starting at group_size={want[0]}" in out) == (want[0] != 4)


def _luma(a):
    a = a.astype(np.float32)
    return 16.0 + 0.256788 * a[..., 0] + 0.504129 * a[..., 1] \
        + 0.097906 * a[..., 2]


def test_decode_fetch_yuv420_env(pipes, streaming, monkeypatch):
    """`test_pipeline.py`'s case on the port: FLEXAM_DECODE_FETCH=yuv420
    decodes through the YUV 4:2:0 fetch and the host inverse, luma within
    JAX's bound of the RGB path; and within a few levels of JAX's own
    yuv420 route (the same planes up to one rounding step, through
    OpenCV's inverse on both sides)."""
    jp, tp = pipes
    z = _latents(7, lt=3)
    exact = tp.decode_u8(torch.from_numpy(z)).numpy()
    monkeypatch.setenv("FLEXAM_DECODE_FETCH", "yuv420")
    got = tp.decode_u8(torch.from_numpy(z)).numpy()
    jgot = np.asarray(jp._decode_u8_host(jnp.asarray(z)))   # [B,T,H,W,3]
    assert got.shape == exact.shape and got.dtype == np.uint8
    g, e = got.transpose(0, 2, 3, 4, 1), exact.transpose(0, 2, 3, 4, 1)
    assert np.abs(_luma(g) - _luma(e)).mean() < 3.0
    assert np.abs(g.astype(int) - jgot.astype(int)).max() <= 3


def test_decode_streamed_yuv420_matches_spec(pipes):
    """`test_vae_stream.py`'s case on the port: the planes equal the
    BT.601 limited-range, 2x2-chroma-mean spec applied to the float
    streamed decode within one level, luma near the uint8 path's, and
    JAX's planes within one level."""
    jp, tp = pipes
    z = _latents(4, b=2)
    luma, uv = tvs.vae_decode_streamed_yuv420(
        tp.models.vae_params, tp.cfg.vae, torch.from_numpy(z), group_size=2)
    exact = tvs.vae_decode_streamed_u8(tp.models.vae_params, tp.cfg.vae,
                                       torch.from_numpy(z), group_size=2)
    b, _, t, h, w = exact.shape
    assert luma.shape == (b, t, h, w) and luma.dtype == torch.uint8
    assert uv.shape == (b, t, 2, h // 2, w // 2) and uv.dtype == torch.uint8
    rgb = tvs.yuv420_to_rgb(luma, uv)
    assert rgb.shape == (b, t, h, w, 3) and rgb.dtype == torch.uint8

    ref = tvs.vae_decode_streamed(tp.models.vae_params, tp.cfg.vae,
                                  torch.from_numpy(z), group_size=2).numpy()
    rf = (np.clip(ref.transpose(0, 2, 3, 4, 1), -1, 1) + 1.0) * 127.5
    r, g, bl = rf[..., 0], rf[..., 1], rf[..., 2]
    y_ref = 16.0 + 0.256788 * r + 0.504129 * g + 0.097906 * bl
    u_ref = 128.0 - 0.148223 * r - 0.290993 * g + 0.439216 * bl
    v_ref = 128.0 + 0.439216 * r - 0.367788 * g - 0.071427 * bl
    uv_ref = np.stack([u_ref, v_ref], 2).reshape(
        b, t, 2, h // 2, 2, w // 2, 2).mean(axis=(4, 6))
    assert np.abs(luma.numpy() - y_ref).max() <= 1.0
    assert np.abs(uv.numpy() - uv_ref).max() <= 1.0
    y_u8 = _luma(exact.numpy().transpose(0, 2, 3, 4, 1))
    assert np.abs(luma.numpy() - y_u8).max() <= 1.5
    jl, juv = jvs.vae_decode_streamed_yuv420(
        jp.models.vae_params, jp.cfg.vae, jnp.asarray(z), group_size=2)
    assert np.abs(luma.numpy().astype(int) - np.asarray(jl)).max() <= 1
    assert np.abs(uv.numpy().astype(int) - np.asarray(juv)).max() <= 1


def test_yuv420_to_rgb_equals_opencv_on_every_triple():
    """`yuv420_to_rgb` against `cv2.cvtColor(COLOR_YUV2RGB_I420)` on all
    256^3 (Y, U, V): a 4096 x 4096 frame whose 2x2 blocks hold every (U,
    V) pair 64 times with 4 distinct Y each."""
    cv2 = pytest.importorskip("cv2")
    h = w = 4096
    pair = np.arange(65536).repeat(64)
    u = (pair >> 8).astype(np.uint8).reshape(h // 2, w // 2)
    v = (pair & 255).astype(np.uint8).reshape(h // 2, w // 2)
    j = np.tile(np.arange(64), 65536).reshape(h // 2, w // 2) * 4
    y = np.empty((h, w), np.uint8)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y[dy::2, dx::2] = j + k
    want = cv2.cvtColor(np.concatenate([y, u.reshape(h // 4, w),
                                        v.reshape(h // 4, w)]),
                        cv2.COLOR_YUV2RGB_I420)
    got = yuv420_to_rgb(y[None, None], np.stack([u, v])[None, None])
    np.testing.assert_array_equal(got[0, 0].numpy(), want)


def test_save_video_yuv420(tmp_path, monkeypatch):
    """`test_pipeline.py`'s case, then the frame dump's route (no
    encoder): the frames written are `yuv420_to_rgb`'s, byte for byte."""
    rng = np.random.RandomState(0)
    luma = rng.randint(16, 235, (1, 5, 32, 64)).astype(np.uint8)
    uv = rng.randint(16, 240, (1, 5, 2, 16, 32)).astype(np.uint8)
    import os
    out = save_video_yuv420(luma, uv, str(tmp_path / "v.mp4"), fps=8)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = save_video_yuv420(luma[0], uv[0], str(tmp_path / "w.mp4"), fps=8)
    assert out.endswith(".npz")
    with np.load(out) as z:
        np.testing.assert_array_equal(z["video"],
                                      yuv420_to_rgb(luma, uv)[0].numpy())
        assert int(z["fps"]) == 8


@pytest.mark.parametrize("batch", [2, 3])
def test_prepare_encode_batch_matches_jax(pipes, streaming, batch):
    """`prepare_encode_batch` streams share the streamed encoder's batch:
    each stream's latents equal JAX's at the same batch (fp32) and the
    port's one stream at a time."""
    jp, tp = pipes
    tracks, vis = _tracks(seed=14)
    first = _frame(15)
    one = tp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                              first_frame=first)
    try:
        jp.prepare_encode_batch = tp.prepare_encode_batch = batch
        cond = tp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                                   first_frame=first)
        jcond = jp.prepare_conditioning_from_tracks(tracks, vis, H, W,
                                                    first_frame=first)
    finally:
        jp.prepare_encode_batch = tp.prepare_encode_batch = 1
    for k in KEYS:
        np.testing.assert_allclose(cond[k].numpy(), np.asarray(jcond[k]),
                                   err_msg=k, **F32)
        np.testing.assert_allclose(cond[k].numpy(), one[k].numpy(),
                                   err_msg=k, **F32)
