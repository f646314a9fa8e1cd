"""MoGe-2, VGGT and Pi3 on the card against the same models on the CPU, at
the tiny geometries of `tests/test_{moge,vggt,pi3}.py`, with the same
weights and inputs, in fp32 with TF32 off.

These need a CUDA device and skip without one. On a machine with an H100:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_geometry_cuda.py

The two devices sum in other orders (cuBLAS, cuDNN, the GPU's reductions),
which moves a K-term fp32 sum by at most about K x 2^-24 of its size
(K <= 1,536 here: 1e-4), typically 1e-6; through a few layers the outputs
stay within 1e-3 of their largest value, the bound `chip_smoke.py`'s
card-against-CPU checks use. MoGe's mask is `logits > 0`: an entry may
flip only where the CPU's logit lies within 1e-3 of its largest |logit|
of 0. The camera heads' zero-initialised last layers are set to random
values, so that the poses are not the identity on both devices by
construction.
"""

import numpy as np
import pytest
import torch

from flexam_tpu_torch.perception import moge, pi3, vggt

pytestmark = pytest.mark.cuda

REL = 1e-3
MOGE = moge.MoGeConfig(patch_size=14, embed_dim=32, depth=2, num_heads=2,
                       num_register_tokens=2, output_idx=(1, 2),
                       pretrain_img_size=28, head_dim=32, num_upsamples=1,
                       pixels_min=28 * 28, pixels_max=70 * 70)
VGGT = vggt.VGGTConfig(patch_size=14, embed_dim=32, enc_depth=2, enc_heads=2,
                       num_register_tokens=0, agg_dim=32, agg_depth=2,
                       agg_heads=2, cam_iters=2, cam_heads=2,
                       depth_taps=(0, 1), depth_features=16)
PI3 = pi3.Pi3Config(patch_size=14, embed_dim=32, enc_depth=2, enc_heads=2,
                    num_register_tokens=0, dec_dim=32, dec_depth=1,
                    dec_heads=2, infer_hw=(28, 42))


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


def _random_fc2(params, n, seed):
    g = torch.Generator().manual_seed(seed)
    d = params["cam_fc2"]["weight"].shape[1]
    params["cam_fc2"] = {"weight": torch.randn((n, d), generator=g) * 0.05,
                         "bias": torch.randn((n,), generator=g) * 0.05}


def test_moge_card_matches_cpu(dev):
    cpu = moge.MoGeModel(MOGE, seed=3, device="cpu")
    card = moge.MoGeModel(MOGE, params=_to(cpu.params, dev), device=dev)
    img = np.random.RandomState(1).rand(3, 44, 60).astype(np.float32)
    ref, got = cpu.infer(img), card.infer(img)
    logits = cpu.last_info["mask_logits"]
    flips = got["mask"] != ref["mask"]
    assert not (flips & (np.abs(logits) > REL * np.abs(logits).max())).any()
    if not flips.any():
        for k in ("points", "depth", "intrinsics"):
            _close(got[k], ref[k], k)
    _close(got["normal"], ref["normal"], "normal")


def test_vggt_card_matches_cpu(dev):
    cpu = vggt.VGGT(VGGT, seed=4, device="cpu")
    _random_fc2(cpu.params, 9, 5)
    card = vggt.VGGT(VGGT, device=dev)
    card.params = _to(cpu.params, dev)
    imgs = np.random.RandomState(2).rand(1, 3, 3, 28, 42).astype(np.float32)
    rt, rps = cpu.aggregator(imgs)
    gt, gps = card.aggregator(imgs)
    assert gps == rps and gt[-1].device.type == "cuda"
    for i, (a, b) in enumerate(zip(gt, rt)):
        _close(a.cpu(), b, f"tokens {i}")
    for a, b in zip(card.camera_head(gt), cpu.camera_head(rt)):
        _close(a, b, "pose encoding")
    for a, b in zip(card.depth_head(gt, imgs, gps),
                    cpu.depth_head(rt, imgs, rps)):
        _close(a, b, "depth head")
    video = np.random.RandomState(3).rand(3, 30, 40, 3).astype(np.float32)
    for a, b in zip(vggt.vggt_video_poses(video, model=card),
                    vggt.vggt_video_poses(video, model=cpu)):
        _close(a, b, "vggt_video_poses")


def test_pi3_card_matches_cpu(dev):
    cpu = pi3.Pi3(PI3, seed=6, device="cpu")
    _random_fc2(cpu.params, 7, 7)
    card = pi3.Pi3(PI3, device=dev)
    card.params = _to(cpu.params, dev)
    imgs = np.random.RandomState(4).rand(1, 3, 3, 28, 42).astype(np.float32)
    ref, got = cpu(imgs), card(imgs)
    for k in ref:
        _close(got[k], ref[k], k)
    video = np.random.RandomState(5).rand(6, 30, 44, 3).astype(np.float32)
    _close(pi3.pi3_video_poses(video, model=card, chunk=1),
           pi3.pi3_video_poses(video, model=cpu, chunk=1), "pi3_video_poses")


def test_models_default_to_the_card(dev):
    for m in (moge.MoGeModel(MOGE), vggt.VGGT(VGGT), pi3.Pi3(PI3)):
        leaf = m.params["encoder"]["pos_embed"]
        assert m.device.type == "cuda" and leaf.device.type == "cuda"
