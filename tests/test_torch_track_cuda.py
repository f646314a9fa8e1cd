"""Conditioning from tracks on the card: the device rasterizer and
`prepare_conditioning_from_tracks` on CUDA against the numpy rasterizer and
the same code on the CPU.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_track_cuda.py

The rasterizer is exact (integer ranks, gathers and a table of k / 255),
so every stream must equal the numpy rasterizer's float for float, and the
CUDA rasterizer's point-index images the CPU one's, tied depths included.
The tiny pipeline runs in fp32 with TF32 off, so its cond must agree with
the CPU pipeline's at the suite's fp32 tolerance.
"""

import numpy as np
import pytest
import torch

from flexam_tpu_torch.conditioning import (cosine_positional_encoding,
                                           rasterize_cos_videos,
                                           rasterize_depth_video,
                                           rasterize_tracking_video)
from flexam_tpu_torch.conditioning.rasterize_device import (DeviceRasterizer,
                                                            colorize)

pytestmark = pytest.mark.cuda

T, H, W = 9, 48, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tracks(seed, n=300, tied=False):
    """Dense points (splats overlap), some invisible, some off the frame,
    one NaN; depths distinct, or on a grid of 4 values."""
    rng = np.random.RandomState(seed)
    base = np.stack([rng.uniform(-3, W + 3, n), rng.uniform(-3, H + 3, n),
                     rng.uniform(0.5, 3.0, n)], axis=1)
    tracks = (base[None] + rng.uniform(-2, 2, (T, 1, 3)).cumsum(0)
              ).astype(np.float32)
    flat = tracks.reshape(-1, 3)
    if tied:
        flat[:, 2] = np.round(flat[:, 2] * 1.5) / 1.5
    else:
        flat[:, 2] = np.linspace(0.5, 3.0, flat.shape[0])[
            rng.permutation(flat.shape[0])]
    tracks[2, 5, 0] = np.nan
    return tracks, rng.rand(T, n) > 0.2


def _streams(r):
    out = {"tracking": r.tracking_video(), "depth": r.depth_video()}
    out.update({f"cos_{i}": v for i, v in enumerate(r.cos_videos())})
    return out


@pytest.mark.parametrize("point_wise,gen_type", [(4, "full_edit"),
                                                 (2, "foreground_edit"),
                                                 (4, "background_edit")])
def test_rasterizer_equals_numpy(dev, point_wise, gen_type):
    tracks, vis = _tracks(1)
    mask = np.zeros((T, H, W), np.float32)
    mask[:, : H // 2] = 1.0
    kw = dict(mask_video=mask, generate_type=gen_type)
    enc = cosine_positional_encoding(tracks, H, W)
    host = {"tracking": rasterize_tracking_video(tracks, vis, H, W,
                                                 point_wise=point_wise, **kw),
            "depth": rasterize_depth_video(tracks, vis, H, W,
                                           point_wise=point_wise, **kw)}
    host.update({f"cos_{i}": v for i, v in
                 rasterize_cos_videos(enc, tracks, vis, H, W, **kw).items()})
    rast = DeviceRasterizer(tracks, vis, H, W, point_wise=point_wise,
                            raster_mask=mask, generate_type=gen_type,
                            device=dev)
    for k, v in _streams(rast).items():
        assert v.is_cuda and v.dtype == torch.float32
        np.testing.assert_array_equal(v.cpu().numpy(), host[k], err_msg=k)


def test_tied_depths_match_the_cpu(dev):
    """The stable sorts on the card pick the CPU's winners for tied depths."""
    tracks, vis = _tracks(2, tied=True)
    on_card = DeviceRasterizer(tracks, vis, H, W, device=dev)
    on_cpu = DeviceRasterizer(tracks, vis, H, W, device="cpu")
    a, b = _streams(on_card), _streams(on_cpu)
    for key, pimg in on_cpu._pimg_cache.items():
        np.testing.assert_array_equal(on_card._pimg_cache[key].cpu().numpy(),
                                      pimg.numpy())
    for k in b:
        np.testing.assert_array_equal(a[k].cpu().numpy(), b[k].numpy())


@pytest.mark.parametrize("normalize", [False, True])
def test_colorize_divides_exactly(dev, normalize):
    """Every uint8 value k becomes k / 255 (and 2 k / 255 - 1) as numpy's
    fp32 division gives it, in fp32 and in bf16."""
    colors = torch.arange(256, dtype=torch.uint8, device=dev)[:, None] \
        .expand(256, 3).contiguous()
    pimg = torch.arange(-1, 255, dtype=torch.int32, device=dev
                        ).reshape(1, 16, 16)
    unit = np.arange(256, dtype=np.float32) / np.float32(255.0)
    want = unit * np.float32(2) - np.float32(1) if normalize else unit
    want = np.where(pimg.cpu().numpy() >= 0,
                    want[np.maximum(pimg.cpu().numpy(), 0)], want[0])
    for dtype in (torch.float32, torch.bfloat16):
        got = colorize(pimg, colors, False, normalize, dtype)
        assert got.dtype == dtype and got.shape == (1, 3, 1, 16, 16)
        np.testing.assert_array_equal(
            got[0, 1].float().cpu().numpy(),
            torch.from_numpy(want).to(dtype).float().numpy())


def test_prepare_from_tracks_on_the_card(dev):
    """The tiny fp32 pipeline's cond on CUDA: every tensor on the card and
    equal to the CPU pipeline's at fp32 tolerance, streamed and whole."""
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = tiny_test_config()
        dp = init_dit_params(cfg.dit, seed=0, dtype=torch.float32,
                             device="cpu")
        vp = init_vae_params(cfg.vae, seed=1, dtype=torch.float32,
                             device="cpu")
        pipes = {}
        for d in ("cpu", dev):
            to = (lambda t: t) if d == "cpu" else _to_dev(dev)
            pipes[str(d)] = FlexAMGenerationPipeline(
                FlexAMModels(cfg=cfg, dit_params=to(dp), vae_params=to(vp)),
                device=d)
        tracks, vis = _tracks(3, n=80)
        rng = np.random.RandomState(4)
        first = (rng.randint(0, 256, (1, 3, 1, H, W)) / 255.0
                 ).astype(np.float32)
        video = (rng.randint(0, 256, (1, 3, T, H, W)) / 255.0
                 ).astype(np.float32)
        mask = np.zeros((1, 1, T, H, W), np.float32)
        mask[..., : W // 2] = 1.0
        cases = [dict(first_frame=first),
                 dict(video=video, mask_video=mask, raster_mask=mask[0, 0],
                      generate_type="foreground_edit"),
                 dict(video=video, generate_type="background_edit")]
        for threshold in (8_000_000, 1000):
            for kw in cases:
                conds = {}
                for name, p in pipes.items():
                    p.VAE_STREAM_THRESHOLD = threshold
                    conds[name] = p.prepare_conditioning_from_tracks(
                        tracks, vis, H, W, **kw)
                got, want = conds[str(dev)], conds["cpu"]
                for k in ("per_token_t", "first_frame_known", "latent_shape"):
                    assert got[k] == want[k], k
                for k, v in want.items():
                    if isinstance(v, torch.Tensor):
                        assert got[k].is_cuda, k
                        np.testing.assert_allclose(
                            got[k].cpu().numpy(), v.numpy(), rtol=2e-4,
                            atol=1e-5, err_msg=k)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _to_dev(dev):
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to(v) for v in tree)
        return tree.to(dev) if isinstance(tree, torch.Tensor) else tree
    return to
