"""The port's CLIP ViT tower, SVD UNet and SVD video VAE
(`flexam_tpu_torch/models/{clip,svd_unet,svd_vae}.py`) against the JAX
package's, on the CPU at JAX's tiny configs, with the weights crossed
through `io.convert.from_jax_params`; the ViT image-embedding head also
against transformers' random `CLIPVisionModelWithProjection` (as
`tests/test_svd_clip_oracle.py` holds JAX's).

Forwards at rtol 2e-4 / atol 1e-5 in fp32, or the bound a test states;
the loaders give JAX's trees and coverage reports on files in the
published names (the UNet's diffusers layout, the VAE's CompVis and
diffusers layouts, HF's CLIP vision names). JAX's UNet and decoder run
under one `jax.jit` each (eager, every op compiles on its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.models import clip as JCL
from flexam_tpu.models import svd_unet as JU
from flexam_tpu.models import svd_vae as JS
from flexam_tpu.models.flux_vae import FluxVAEConfig as JVAECfg
from flexam_tpu_torch.models import clip as TCL
from flexam_tpu_torch.models import svd_unet as TU
from flexam_tpu_torch.models import svd_vae as TS
from flexam_tpu_torch.models.flux_vae import FluxVAEConfig, \
    flux_vae_state_dict, init_flux_vae_params
from tests.test_torch_flux import (assert_trees_equal, close, crossed,
                                   randomize, same_report, to_jax)

UCFG_T, UCFG_J = TU.SVDUNetConfig.tiny(), JU.SVDUNetConfig.tiny()
DCFG_T, DCFG_J = TS.TemporalDecoderConfig.tiny(), \
    JS.TemporalDecoderConfig.tiny()
ENC_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
              scale_factor=0.18215, shift_factor=0.0)
ENC_T, ENC_J = FluxVAEConfig(**ENC_KW), JVAECfg(**ENC_KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_vision(act: str, proj_dim: int = 16):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=28, patch_size=14,
        projection_dim=proj_dim, hidden_act=act)
    torch.manual_seed(0)
    return transformers.CLIPVisionModelWithProjection(cfg).eval()


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_image_embed_matches_jax_and_transformers(act):
    """HF weights -> both loaders (equal trees and reports) -> the image
    embedding against JAX's and transformers'; the penultimate-block tokens
    of `clip_encode_video_frames` (antialiased bicubic resize) against
    JAX's."""
    model = _hf_vision(act)
    sd = model.state_dict()
    tp, tcfg, trep = TCL.clip_vision_params_from_hf(sd, num_heads=2,
                                                    activation=act,
                                                    device="cpu")
    jp, jcfg, jrep = JCL.clip_vision_params_from_hf(
        {k: v.numpy() for k, v in sd.items()}, num_heads=2, activation=act)
    assert same_report(trep, jrep) and not trep["missed"]
    assert (tcfg.dim, tcfg.num_layers, tcfg.image_size) == (
        jcfg.dim, jcfg.num_layers, jcfg.image_size) == (32, 2, 28)
    assert_trees_equal(tp, crossed(jp))
    x = np.random.default_rng(0).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    got = TCL.clip_image_embed(tp, tcfg, torch.from_numpy(x))
    close(got, JCL.clip_image_embed(jax.tree_util.tree_map(jnp.asarray, jp),
                                    jcfg, jnp.asarray(x)))
    with torch.no_grad():
        ref = model(pixel_values=torch.from_numpy(x)).image_embeds
    close(got, ref, atol=2e-4)
    video = np.random.default_rng(1).uniform(-1, 1, (1, 3, 2, 40, 36)
                                             ).astype(np.float32)
    close(TCL.clip_encode_video_frames(tp, tcfg, torch.from_numpy(video)),
          JCL.clip_encode_video_frames(
              jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
              jnp.asarray(video)))
    # the writer's names load back as they were
    back, _, rep = TCL.clip_vision_params_from_hf(
        TCL.clip_vision_state_dict(tp), num_heads=2, activation=act,
        device="cpu")
    assert not rep["missed"] and not rep["unused"]
    assert_trees_equal(back, tp)


@pytest.mark.parametrize("case", ["junk", "no_post_ln", "no_qkv_bias"])
def test_clip_vision_loader_reports_match_jax(case):
    model = _hf_vision("gelu")
    sd = dict(model.state_dict())
    if case == "junk":
        sd = {"junk": torch.zeros(2, 2)}
    elif case == "no_post_ln":
        sd = {k: v for k, v in sd.items() if "post_layernorm" not in k}
    else:
        sd = {k: v for k, v in sd.items()
              if not ("self_attn" in k and k.endswith(".bias"))}
    tp, _, trep = TCL.clip_vision_params_from_hf(sd, num_heads=2,
                                                 device="cpu")
    jp, _, jrep = JCL.clip_vision_params_from_hf(
        {k: v.numpy() for k, v in sd.items()}, num_heads=2)
    assert tp == {} and jp == {} and trep["missed"]
    assert same_report(trep, jrep)


def test_vit_reference_loader_matches_jax():
    """`vit_params_from_state_dict` over the reference VisionTransformer's
    names (patch bias and pre-norm present)."""
    cfg_t = TCL.CLIPVisionConfig(image_size=28, patch_size=14, dim=32,
                                 num_heads=2, num_layers=2)
    cfg_j = JCL.CLIPVisionConfig(image_size=28, patch_size=14, dim=32,
                                 num_heads=2, num_layers=2)
    g = torch.Generator().manual_seed(0)
    tree = TCL.init_vit_params(cfg_t, seed=0, device="cpu")
    sd = {"patch_embedding.weight": tree["patch_embedding"]["weight"],
          "patch_embedding.bias": torch.randn(32, generator=g),
          "cls_embedding": tree["cls_embedding"],
          "pos_embedding": tree["pos_embedding"],
          "pre_norm.weight": tree["pre_norm_w"],
          "pre_norm.bias": tree["pre_norm_b"]}
    for i, bp in enumerate(tree["blocks"]):
        for ours, ref in (("to_qkv", "attn.to_qkv"), ("proj", "attn.proj"),
                          ("fc1", "mlp.0"), ("fc2", "mlp.2")):
            sd[f"transformer.{i}.{ref}.weight"] = bp[ours]["weight"]
            sd[f"transformer.{i}.{ref}.bias"] = bp[ours]["bias"]
        for n in ("1", "2"):
            sd[f"transformer.{i}.norm{n}.weight"] = bp[f"norm{n}_w"]
            sd[f"transformer.{i}.norm{n}.bias"] = bp[f"norm{n}_b"]
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in sd.items()}
    tp = TCL.vit_params_from_state_dict(sd, cfg_t, device="cpu")
    jp = JCL.vit_params_from_state_dict({k: v.numpy() for k, v in sd.items()},
                                        cfg_j)
    assert_trees_equal(tp, crossed(jp))
    x = np.random.default_rng(2).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    for use31 in (True, False):
        close(TCL.vit_forward(tp, cfg_t, torch.from_numpy(x), use31),
              JCL.vit_forward(jax.tree_util.tree_map(jnp.asarray, jp), cfg_j,
                              jnp.asarray(x), use31))


@pytest.fixture(scope="module")
def unet_trees():
    port = randomize(TU.init_svd_unet_params(UCFG_T, seed=0, device="cpu"),
                     1, scale=0.02)
    jp = to_jax(port, conv=True)
    return jp, crossed(jp)


def unet_inputs(b=2, t=3, h=8, w=12, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        latents=rng.standard_normal((b, t, UCFG_J.in_channels, h, w)
                                    ).astype(np.float32),
        timestep=np.asarray([1.5, -0.3][:b], np.float32),
        encoder_hidden_states=rng.standard_normal(
            (b, t, 1, UCFG_J.cross_attention_dim)).astype(np.float32),
        added_time_ids=np.tile(np.asarray([[6.0, 127.0, 0.02]], np.float32),
                               (b, 1)))


@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (1, 4, 6, 10)],
                         ids=["b2", "odd_half"])
def test_svd_unet_forward_matches_jax(unet_trees, shape):
    """The whole UNet ([B, T, C, H, W] here, [B, T, H, W, C] in JAX); at
    6 x 10 the stride-2 downsample sees 3 x 5 halves below it, and JAX's
    SAME padding (the odd pixel at the high end) matters."""
    jp, tp = unet_trees
    x = unet_inputs(*shape)
    fwd = jax.jit(JU.svd_unet_forward, static_argnums=1)
    want = fwd(jp, UCFG_J, jnp.asarray(x["latents"].transpose(0, 1, 3, 4, 2)),
               jnp.asarray(x["timestep"]),
               jnp.asarray(x["encoder_hidden_states"]),
               jnp.asarray(x["added_time_ids"]))
    got = TU.svd_unet_forward(tp, UCFG_T, **{k: torch.from_numpy(v)
                                             for k, v in x.items()})
    close(got.permute(0, 1, 3, 4, 2), want)


def test_svd_unet_loader_matches_jax(unet_trees):
    """The published names (`to_out.0`, `ff.net.0.proj`, `ff_in.net.2`)
    both ways; a garbage file maps nothing in either."""
    jp, tp = unet_trees
    sd = TU.svd_unet_state_dict(tp)
    jsd = JU.svd_unet_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp))
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k])
    assert ("down_blocks.0.attentions.0.temporal_transformer_blocks.0"
            ".ff_in.net.0.proj.weight") in sd
    tl, trep = TU.svd_unet_params_from_state_dict(sd, UCFG_T, device="cpu")
    jl, jrep = JU.svd_unet_params_from_state_dict(jsd, UCFG_J)
    assert same_report(trep, jrep) and not trep["missed"]
    assert_trees_equal(tl, crossed(jl))
    garbage = {"nonsense": torch.zeros(3, 3)}
    _, trep = TU.svd_unet_params_from_state_dict(garbage, UCFG_T,
                                                 device="cpu")
    _, jrep = JU.svd_unet_params_from_state_dict(
        {"nonsense": np.zeros((3, 3), np.float32)}, UCFG_J)
    assert same_report(trep, jrep) and not trep["loaded"]


def test_karras_sigmas_and_euler_v_step_match_jax():
    for n in (1, 2, 25):
        np.testing.assert_array_equal(TU.karras_sigmas(n),
                                      JU.karras_sigmas(n))
    rng = np.random.default_rng(3)
    s, v = (rng.standard_normal((1, 2, 4, 3, 5)).astype(np.float32)
            for _ in range(2))
    sig = TU.karras_sigmas(4)
    for i in range(4):
        close(TU.euler_v_step(torch.from_numpy(s), torch.from_numpy(v),
                              sig[i], sig[i + 1]),
              JU.euler_v_step(jnp.asarray(s), jnp.asarray(v),
                              jnp.float32(sig[i]), jnp.float32(sig[i + 1])),
              rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def vae_trees():
    enc = randomize(init_flux_vae_params(ENC_T, seed=2, device="cpu"), 3,
                    scale=0.02)["encoder"]
    dec = randomize(TS.init_temporal_decoder_params(DCFG_T, seed=4,
                                                    device="cpu"), 5,
                    scale=0.02)
    g = torch.Generator().manual_seed(6)
    port = {"encoder": enc, "decoder": dec,
            "quant_conv": {"w": 0.3 * torch.randn(8, 8, 1, 1, generator=g),
                           "b": 0.1 * torch.randn(8, generator=g)}}
    jp = {"encoder": to_jax({"encoder": enc}, conv=True)["encoder"],
          "decoder": to_jax(dec, conv=True),
          "quant_conv": to_jax({"encoder": {"conv_in": port["quant_conv"]}},
                               conv=True)["encoder"]["conv_in"]}
    return jp, port


def test_temporal_decode_and_encode_match_jax(vae_trees):
    """The temporal decoder over 3 frames (its temporal resnets and the
    final 3-tap RGB conv mix frames) and the SD encoder with quant_conv."""
    jp, tp = vae_trees
    z = np.random.default_rng(7).standard_normal((3, 4, 8, 6)).astype(
        np.float32)
    want = jax.jit(JS.temporal_decode, static_argnums=1)(
        jp["decoder"], DCFG_J, jnp.asarray(z.transpose(0, 2, 3, 1)))
    got = TS.temporal_decode(tp["decoder"], DCFG_T, torch.from_numpy(z))
    assert got.shape == (3, 3, 16, 12)
    close(got.permute(0, 2, 3, 1), want)
    x = np.random.default_rng(8).uniform(-1, 1, (2, 3, 16, 12)).astype(
        np.float32)
    close(TS.svd_vae_encode(tp, ENC_T, torch.from_numpy(x)).permute(
        0, 2, 3, 1),
        JS.svd_vae_encode(jp, ENC_J, jnp.asarray(x.transpose(0, 2, 3, 1))))
    fn = TS.make_temporal_decode_fn(tp, DCFG_T)
    np.testing.assert_array_equal(fn(torch.from_numpy(z)).numpy(),
                                  got.numpy())


def _diffusers_names(sd):
    """The video release's diffusers spellings of a CompVis-named file
    (written out as JAX's test writes them)."""
    attn_inv = {"q": "to_q", "k": "to_k", "v": "to_v",
                "proj_out": "to_out.0", "norm": "group_norm"}
    out = {}
    for k, v in sd.items():
        nk = k
        if k.startswith("encoder."):
            nk = nk.replace(".norm_out.", ".conv_norm_out.")
            for i in range(len(ENC_KW["ch_mult"])):
                nk = nk.replace(f"down.{i}.block.",
                                f"down_blocks.{i}.resnets.")
                nk = nk.replace(f"down.{i}.downsample.conv.",
                                f"down_blocks.{i}.downsamplers.0.conv.")
            nk = nk.replace("mid.block_1.", "mid_block.resnets.0.")
            nk = nk.replace("mid.block_2.", "mid_block.resnets.1.")
            for a, b in attn_inv.items():
                nk = nk.replace(f"mid.attn_1.{a}.",
                                f"mid_block.attentions.0.{b}.")
            nk = nk.replace(".nin_shortcut.", ".conv_shortcut.")
        if k.startswith("decoder.mid_block.attentions.0."):
            for a, b in attn_inv.items():
                nk = nk.replace(f"attentions.0.{a}.", f"attentions.0.{b}.")
        if (any(t in nk for t in ("to_q", "to_k", "to_v", "to_out"))
                and nk.endswith(".weight") and v.dim() == 4):
            v = v[:, :, 0, 0]
        out[nk] = v
    return out


@pytest.mark.parametrize("naming", ["compvis", "diffusers"])
def test_svd_vae_loader_matches_jax(vae_trees, naming):
    jp, tp = vae_trees
    sd = TS.svd_vae_state_dict(tp)
    assert "decoder.time_conv_out.weight" in sd and "quant_conv.bias" in sd
    if naming == "diffusers":
        sd = _diffusers_names(sd)
    tl, trep = TS.svd_vae_params_from_state_dict(sd, ENC_T, DCFG_T,
                                                 device="cpu")
    jl, jrep = JS.svd_vae_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, ENC_J, DCFG_J)
    assert same_report(trep, jrep)
    assert not trep["missed"] and not trep["unused"]
    assert_trees_equal(tl, crossed(jl))
    del sd["decoder.conv_in.weight"]
    _, trep = TS.svd_vae_params_from_state_dict(sd, ENC_T, DCFG_T,
                                                device="cpu")
    _, jrep = JS.svd_vae_params_from_state_dict(
        {k: v.numpy() for k, v in sd.items()}, ENC_J, DCFG_J)
    assert same_report(trep, jrep) and trep["missed"]


def test_svd_full_geometry():
    """The published widths (shapes only, on the meta device): the SVD UNet
    at about 1.52 B parameters, the temporal decoder beside the SD
    encoder."""
    from flexam_tpu_torch.core.layers import ParamDraw
    from flexam_tpu_torch.io.convert import tree_leaves
    unet = TU._unet_tree(TU.SVDUNetConfig(), ParamDraw(0, device="meta"))
    n = sum(t.numel() for t in tree_leaves(unet))
    assert 1.4e9 < n < 1.6e9, n
    dec = TS._decoder_tree(TS.TemporalDecoderConfig(),
                           ParamDraw(0, device="meta"))
    n = sum(t.numel() for t in tree_leaves(dec))
    assert 50e6 < n < 120e6, n
    assert flux_vae_state_dict is not None
