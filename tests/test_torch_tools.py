"""The port's tools against the JAX package's, on the CPU: `compare_latents`
(`psnr`, `ssim`, and the CLI's output and exit code on the same dumps) and
`verify_ckpt` (junk files fail the dit, vae and t5 kinds as in JAX; files
written from tiny random trees pass; the device defaults to CUDA; the
perception kinds delta, unidepth, zoe and dav2 fail a junk file as in JAX,
and the FLUX / SVD kinds pass files written from JAX's trees and fail a
junk file, as in JAX;
`tests/test_torch_video_tracking.py`, `tests/test_torch_unidepth.py`,
`tests/test_torch_zoedepth.py` and `tests/test_torch_depth_anything.py`
hold the loaders to JAX's). The
hygiene scan covers the server and both tools."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from flexam_tpu.tools import compare_latents as jcl
from flexam_tpu.tools import verify_ckpt as jvc
from flexam_tpu_torch.tools import compare_latents as tcl
from flexam_tpu_torch.tools import verify_ckpt as tvc


def test_psnr_ssim_match_jax():
    rs = np.random.RandomState(0)
    a = rs.rand(3, 16, 20)
    for b in (a, a + rs.randn(*a.shape) * 1e-3, a + 0.1,
              rs.rand(3, 16, 20)):
        assert tcl.psnr(a, b) == jcl.psnr(a, b)
        assert tcl.psnr(a, b, peak=1.0) == jcl.psnr(a, b, peak=1.0)
        assert tcl.ssim(a, b) == jcl.ssim(a, b)
        assert tcl.ssim(a, b, peak=2.0, win=5) == jcl.ssim(a, b, peak=2.0,
                                                          win=5)


def _run(main, argv, capsys):
    try:
        main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_compare_latents_cli_matches_jax(tmp_path, capsys):
    rs = np.random.RandomState(2)
    x = rs.randn(3, 4, 4).astype(np.float32)
    np.savez(tmp_path / "a.npz", latents=x, other=x[:2])
    np.savez(tmp_path / "b.npz", latents=x + 1e-4, other=x[:2] + 0.5)
    np.savez(tmp_path / "c.npz", latents=x[:2])
    np.savez(tmp_path / "d.npz", unrelated=x)
    np.save(tmp_path / "e.npy", x)
    torch.save(torch.from_numpy(x + 1e-3), str(tmp_path / "f.pt"))
    a, b, c, d, e, f = (str(tmp_path / n) for n in (
        "a.npz", "b.npz", "c.npz", "d.npz", "e.npy", "f.pt"))
    cases = [[a, b], [a, b, "--key", "latents"],
             [a, b, "--per-step", "--key", "latents"],
             [a, b, "--threshold", "0"], [a, c], [a, d], [e, f]]
    for argv in cases:
        assert _run(tcl.main, argv, capsys) == _run(jcl.main, argv,
                                                    capsys), argv
    # both exit codes occur among the cases: a pass, and a shape mismatch
    assert _run(tcl.main, cases[1], capsys)[0] == 0
    assert _run(tcl.main, cases[4], capsys)[0] == 1


def test_compare_latents_module_entry(tmp_path):
    x = np.random.RandomState(3).randn(2, 4, 4).astype(np.float32)
    np.savez(tmp_path / "a.npz", latents=x)
    np.savez(tmp_path / "b.npz", latents=x + 1e-4)
    out = subprocess.run(
        [sys.executable, "-m", "flexam_tpu_torch.tools.compare_latents",
         str(tmp_path / "a.npz"), str(tmp_path / "b.npz")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "latents" in out.stdout and "dB" in out.stdout


@pytest.fixture
def junk(tmp_path):
    from flexam_tpu_torch.io.checkpoints import save_safetensors
    d = tmp_path / "transformer"
    d.mkdir()
    save_safetensors(str(d / "model.safetensors"),
                     {"junk.weight": torch.zeros(3, 3)})
    pth = tmp_path / "junk.pth"
    torch.save({"junk.weight": torch.zeros(3, 3)}, str(pth))
    return {"dit": str(d), "vae": str(pth), "t5": str(pth)}


@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_verify_ckpt_junk_fails_as_in_jax(junk, kind, capsys):
    assert jvc.verify(kind, junk[kind]) is False
    assert tvc.verify(kind, junk[kind], "cpu") is False
    assert "FAILED" in capsys.readouterr().out
    assert tvc.main(["--model", kind, "--platform", "cpu", junk[kind]]) == 1


@pytest.mark.parametrize("kind", ["dit", "vae", "t5"])
def test_verify_ckpt_passes_a_full_file_on_the_cpu(tmp_path, monkeypatch,
                                                   kind, capsys):
    """`--platform cpu` loads every expected tensor of a file the loader
    can read (the tool's config swapped for the tiny one)."""
    import flexam_tpu_torch.config as tcfg
    from tests.test_torch_cli_cuda import write_tiny_checkpoints
    cfg, paths = write_tiny_checkpoints(tmp_path)
    monkeypatch.setattr(tcfg, "FlexAMConfig", lambda: cfg)
    assert tvc.verify(kind, paths[kind], "cpu") is True
    assert tvc.main(["--model", kind, "--platform", "cpu",
                     paths[kind]]) == 0
    assert "OK" in capsys.readouterr().out


def test_verify_ckpt_defaults_to_cuda(junk):
    """Without `--platform cpu` the tool loads onto the card, and asking
    for the card where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvc.verify("vae", junk["vae"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tvc.main(["--model", "vae", junk["vae"]])


FLUX_SVD_KINDS = ["flux", "flux-ae", "svd-unet", "svd-vae", "svd-clip"]


@pytest.fixture(scope="module")
def flux_svd_files(tmp_path_factory):
    """One file a FLUX / SVD kind, written by JAX's writers from JAX trees
    at the tiny geometries (the port's random inits crossed to JAX), plus
    the tiny configs each tool is given."""
    from safetensors.numpy import save_file

    from flexam_tpu.models import flux as jf
    from flexam_tpu.models import flux_vae as jv
    from flexam_tpu.models import svd_unet as ju
    from flexam_tpu.models.svd_vae import TemporalDecoderConfig
    from flexam_tpu_torch.models import clip as tcl_
    from flexam_tpu_torch.models import flux as tf_
    from flexam_tpu_torch.models import flux_vae as tv_
    from flexam_tpu_torch.models import svd_unet as tu_
    from flexam_tpu_torch.models import svd_vae as ts_
    from tests.test_torch_flux import to_jax
    d = tmp_path_factory.mktemp("flux_svd_files")
    sd_cfg = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
                  scale_factor=0.18215, shift_factor=0.0)
    jsd_vae = jv.FluxVAEConfig(**sd_cfg)
    enc = to_jax(tv_.init_flux_vae_params(tv_.FluxVAEConfig(**sd_cfg),
                                          device="cpu"), conv=True)
    dec = to_jax(ts_.init_temporal_decoder_params(
        ts_.TemporalDecoderConfig.tiny(), device="cpu"), conv=True)
    svd_vae = {k: v for k, v in jv.flux_vae_params_to_state_dict(
        enc, jsd_vae).items() if k.startswith("encoder.")}
    for ours, val in ju._flatten(dec).items():
        v = np.asarray(val)
        v = (v.transpose(3, 2, 0, 1) if v.ndim == 4 else
             v.transpose(4, 3, 0, 1, 2) if v.ndim == 5 else v)
        svd_vae[f"decoder.{ours}"] = v
    vit = tcl_.init_vit_params(tcl_.CLIPVisionConfig(
        image_size=28, patch_size=14, dim=32, num_heads=2, num_layers=2),
        device="cpu", proj_dim=16)
    sds = {
        "flux": jf.flux_params_to_state_dict(to_jax(tf_.init_flux_params(
            tf_.FluxConfig.tiny(), dtype=torch.float32, device="cpu")),
            jf.FluxConfig.tiny()),
        "flux-ae": jv.flux_vae_params_to_state_dict(to_jax(
            tv_.init_flux_vae_params(tv_.FluxVAEConfig.tiny(),
                                     device="cpu"), conv=True),
            jv.FluxVAEConfig.tiny()),
        "svd-unet": ju.svd_unet_params_to_state_dict(to_jax(
            tu_.init_svd_unet_params(tu_.SVDUNetConfig.tiny(),
                                     device="cpu"), conv=True)),
        "svd-vae": svd_vae,
        "svd-clip": {k: v.numpy() for k, v in
                     tcl_.clip_vision_state_dict(vit).items()},
    }
    paths = {}
    for kind, sd in sds.items():
        paths[kind] = str(d / f"{kind}.safetensors")
        save_file({k: np.ascontiguousarray(np.asarray(v, np.float32))
                   for k, v in sd.items()}, paths[kind])
    paths["junk"] = str(d / "junk.safetensors")
    save_file({"junk": np.zeros((2, 2), np.float32)}, paths["junk"])
    assert TemporalDecoderConfig.tiny().block_out_channels == (32, 64)
    return paths, jsd_vae, sd_cfg


def _tiny_flux_svd_configs(monkeypatch, jsd_vae, sd_cfg):
    """Both tools' default geometries swapped for the tiny ones."""
    from flexam_tpu.models import flux as jf
    from flexam_tpu.models import flux_vae as jv
    from flexam_tpu.models import svd_unet as ju
    from flexam_tpu.perception import depthcrafter_model as jm
    from flexam_tpu_torch.models import flux as tf_
    from flexam_tpu_torch.models import flux_vae as tv_
    from flexam_tpu_torch.models import svd_unet as tu_
    from flexam_tpu_torch.perception import depthcrafter_model as tm
    monkeypatch.setattr(jm, "SD_VAE_CONFIG", jsd_vae)
    monkeypatch.setattr(tm, "SD_VAE_CONFIG", tv_.FluxVAEConfig(**sd_cfg))
    for mod, name, tiny in (
            (jf, "FluxConfig", jf.FluxConfig.tiny()),
            (tf_, "FluxConfig", tf_.FluxConfig.tiny()),
            (jv, "FluxVAEConfig", jv.FluxVAEConfig.tiny()),
            (tv_, "FluxVAEConfig", tv_.FluxVAEConfig.tiny()),
            (ju, "SVDUNetConfig", ju.SVDUNetConfig.tiny()),
            (tu_, "SVDUNetConfig", tu_.SVDUNetConfig.tiny())):
        monkeypatch.setattr(mod, name, lambda tiny=tiny: tiny)


@pytest.mark.parametrize("file", ["good", "junk"])
@pytest.mark.parametrize("kind", FLUX_SVD_KINDS)
def test_verify_ckpt_flux_svd_kinds_match_jax(flux_svd_files, kind, file,
                                              monkeypatch, capsys):
    """Each FLUX / SVD kind on a file JAX's writers made (the tools'
    geometry swapped for the tiny one): both tools pass it, and both fail
    a file holding one stray tensor; the CLI's exit code follows."""
    paths, jsd_vae, sd_cfg = flux_svd_files
    _tiny_flux_svd_configs(monkeypatch, jsd_vae, sd_cfg)
    path = paths[kind if file == "good" else "junk"]
    want = file == "good"
    assert jvc.verify(kind, path) is want
    assert tvc.verify(kind, path, "cpu") is want
    assert tvc.main(["--model", kind, "--platform", "cpu", path]) == (
        0 if want else 1)
    assert f"{kind}[{path}]" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["delta", "unidepth", "zoe", "dav2"])
def test_verify_ckpt_perception_kinds_on_junk_match_jax(junk, kind,
                                                        monkeypatch):
    """A checkpoint holding one stray tensor fails the perception kinds in
    both tools: unidepth's and zoe's name maps miss their keys, delta's
    shape map and dav2's name map cover nothing. JAX's zoe and dav2
    loaders build a model before they map, so their default geometry is
    swapped for the tiny one (and the port's dav2 likewise)."""
    from flexam_tpu.perception import depth_anything as jdav
    from flexam_tpu.perception import zoedepth as jzoe
    from flexam_tpu_torch.perception import depth_anything as tdav
    tiny_zoe, tiny_dav2 = jzoe.tiny_zoe_config(), tdav.tiny_dav2_config()
    monkeypatch.setattr(jzoe, "ZoeDepthConfig", lambda: tiny_zoe)
    monkeypatch.setattr(jdav.load_dav2, "__defaults__",
                        (jdav.tiny_dav2_config(), True))
    monkeypatch.setattr(tdav, "DAv2Config", lambda: tiny_dav2)
    assert jvc.verify(kind, junk["vae"]) is False
    assert tvc.verify(kind, junk["vae"], "cpu") is False
    assert tvc.main(["--model", kind, "--platform", "cpu",
                     junk["vae"]]) == 1


def test_hygiene_scans_the_server_and_tools():
    from tests.test_torch_hygiene import ROOT, _modules
    names = {p.relative_to(ROOT).as_posix() for p, _ in _modules()}
    assert {"flexam_tpu_torch/serve.py",
            "flexam_tpu_torch/tools/compare_latents.py",
            "flexam_tpu_torch/tools/verify_ckpt.py"} <= names
