"""The node pack on the card at tiny sizes: the sampler node launches the
port's kernels (B1 or B2, B3, B4; B5 after FunAttention("sparse")), the
depth annotators' models and Canny on the card against the CPU.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nodes_cuda.py

The sampler runs a DiT of head dim 128 (dim 256, 2 heads), the kernels'
width, in bf16. ZoeDepth and Depth-Anything-V2 run in fp32 with TF32 off
on both devices, whose sums run in other orders: a K-term fp32 sum moves
by at most about K x 2^-24 of its size (K <= 576 here), so the outputs
stay within 1e-3 of their largest value, the bound of `chip_smoke.py`'s
card-against-CPU checks. Canny is integer work: equal on both.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from flexam_tpu_torch import nodes as N
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
from flexam_tpu_torch.perception import depth_anything as dav2
from flexam_tpu_torch.perception import zoedepth as zoe
from flexam_tpu_torch.utils.cv import canny_u8

pytestmark = pytest.mark.cuda

REL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, d) for v in tree]
    return tree.to(d)


def _close(got, ref, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= REL * scale, (
        name, np.abs(got - ref).max(), scale)


def _cfg():
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, dim=256, ffn_dim=512, num_heads=2))


def test_sampler_node_launches_the_kernels(dev):
    pipe, = N.LoadFlexAMModel().loadmodel("x", random_init="small",
                                          config=_cfg())
    assert pipe.device.type == "cuda"
    rs = np.random.RandomState(0)
    t, h, w = 9, 64, 64
    video = rs.rand(t, h, w, 3).astype(np.float32)
    kw = dict(prompt="a node graph video", original_video=video,
              control_video=rs.rand(t, h, w, 3).astype(np.float32),
              video_length=t, base_resolution=64, steps=2, density=10.0)
    reset_launch_counts()
    out, = N.FlexAMV2VSampler().process(funmodels=pipe, **kw)
    counts = launch_counts()
    assert out.shape == (1, 3, t, h, w) and np.isfinite(out).all()
    assert counts["flash_attention"] + counts["single_kv_attention"] > 0
    assert counts["rmsnorm_rope"] > 0, counts
    assert counts["ln_mod_binary"] + counts["ln_mod_bcast"] > 0, counts
    assert counts["sparse_attention"] == counts["int8_attention"] == 0
    prev = os.environ.get("FLEXAM_ATTENTION")
    try:
        N.FunAttention().process("sparse", pipe)
        reset_launch_counts()
        N.FlexAMV2VSampler().process(funmodels=pipe, **{**kw, "steps": 1})
        assert launch_counts()["sparse_attention"] > 0
    finally:
        if prev is None:
            os.environ.pop("FLEXAM_ATTENTION", None)
        else:
            os.environ["FLEXAM_ATTENTION"] = prev
        from flexam_tpu_torch.core.attention import _backend_choice
        _backend_choice.cache_clear()


def test_depth_models_card_match_cpu(dev):
    cfg = zoe.tiny_zoe_config()
    g = torch.Generator().manual_seed(1)
    cpu = zoe.ZoeDepth(cfg, params=zoe.zoedepth_init(g, cfg, "cpu"),
                       device="cpu")
    card = zoe.ZoeDepth(cfg, params=_to(cpu.params, dev), device=dev)
    video = np.random.RandomState(2).rand(3, 48, 64, 3).astype(np.float32)
    _close(zoe.zoe_depth_video(video, model=card, batch=2),
           zoe.zoe_depth_video(video, model=cpu, batch=2), "zoe")
    x = video[:1].transpose(0, 3, 1, 2)
    _close(card.infer(x), cpu.infer(x), "zoe infer (pad, flip)")
    dcfg = dav2.tiny_dav2_config()
    g = torch.Generator().manual_seed(3)
    params = dav2.dav2_init(g, dcfg, "cpu")
    _close(dav2.dav2_infer_video(_to(params, dev), video, dcfg, batch=2),
           dav2.dav2_infer_video(params, video, dcfg, batch=2), "dav2")


def test_annotator_nodes_on_the_card(dev, monkeypatch, tmp_path):
    """VideoToDepth through the registry's DAv2 on the card (a tiny file),
    VideoToTrackingPredict's device flow tracker, Canny on the card equal
    to the CPU's."""
    dcfg = dav2.tiny_dav2_config()
    g = torch.Generator().manual_seed(4)
    path = tmp_path / "dav2.pth"
    torch.save(dav2.dav2_state_dict(dav2.dav2_init(g, dcfg, "cpu")),
               str(path))
    for k in ("FLEXAM_DEPTH_BACKEND", "FLEXAM_UNIDEPTH_CKPT",
              "FLEXAM_ZOE_CKPT", "FLEXAM_DELTA_CKPT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("FLEXAM_DAV2_CKPT", str(path))
    monkeypatch.setattr(dav2, "DAv2Config", lambda: dcfg)
    rs = np.random.RandomState(5)
    video = rs.rand(1, 3, 5, 48, 64).astype(np.float32)
    card, = N.VideoToDepth().process(video, 5, device="cuda")
    cpu, = N.VideoToDepth().process(video, 5, device="cpu")
    assert card.shape == video.shape
    _close(card, cpu, "VideoToDepth")
    monkeypatch.chdir(tmp_path)                # no ./checkpoints here
    monkeypatch.delenv("FLEXAM_DAV2_CKPT")
    tracks, vis = N.VideoToTrackingPredict().process(video, density=8,
                                                     device="cuda")
    assert tracks.shape[0] == 5 and vis.dtype == bool
    frames = (rs.rand(3, 48, 64) * 255).astype(np.uint8)
    np.testing.assert_array_equal(canny_u8(frames, 60, 120, device="cuda"),
                                  canny_u8(frames, 60, 120))
