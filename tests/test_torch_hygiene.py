"""Boundaries of the PyTorch port: it imports neither jax nor anything of
the JAX package, nor the host libraries the card's machine lacks
(matplotlib, cv2, PIL, and safetensors / ml_dtypes, which the checkpoint
readers do without), its entry points refuse to run on the CPU unless
asked, and `chip_smoke.py` fails cleanly where there is no CUDA device."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "flexam_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        name = ".".join(rel.parts)
        yield p, name[:-len(".__init__")] if name.endswith(".__init__") else name


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "flexam_tpu" or name.startswith("flexam_tpu."))


@pytest.mark.parametrize("path", [p for p, _ in _modules()]
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    """AST scan: no `import jax*` and no `flexam_tpu.*` import."""
    bad = [n for n in _imported_roots(path) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


# host libraries the card's machine does not have (or may lack)
# (`google.protobuf`, not `google`: a namespace-package .pth may load the
# bare `google` at interpreter start)
HOST_ONLY = ("matplotlib", "cv2", "PIL", "safetensors", "ml_dtypes",
             "google.protobuf", "onnx", "onnxruntime")


def _host_only(name: str) -> bool:
    return any(name == h or name.startswith(h + ".") for h in HOST_ONLY)


@pytest.mark.parametrize("path", [p for p, _ in _modules()]
                         + [ROOT / "chip_smoke.py"], ids=lambda p: p.name)
def test_no_host_only_library_import(path):
    """AST scan: no `import matplotlib`, `cv2`, `PIL`, `safetensors`,
    `ml_dtypes`, `google.protobuf`, `onnx` or `onnxruntime` anywhere in the
    port or the smoke (the conditioning modules keep their own Spectral
    table and numpy painter, the masks and media readers their own OpenCV /
    PIL steps, the checkpoint loaders their own safetensors reader, DWPose
    its own ONNX reader and runner)."""
    bad = [n for n in _imported_roots(path) if _host_only(n)]
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_port_loads_no_host_only_library():
    """In a fresh interpreter, importing every module of the port and
    building a device rasterizer leaves none of those libraries in
    sys.modules."""
    names = [n for _, n in _modules()]
    code = ("import sys\n"
            + "".join(f"import {n}\n" for n in names)
            + "import numpy as np\n"
              "from flexam_tpu_torch.conditioning.rasterize_device import "
              "DeviceRasterizer\n"
              "tr = np.random.RandomState(0).rand(3, 5, 3).astype('f4') * 8\n"
              "DeviceRasterizer(tr, None, 8, 8, device='cpu').depth_video()\n"
              f"bad = sorted(m for m in sys.modules if any(m == h or "
              f"m.startswith(h + '.') for h in {HOST_ONLY!r}))\n"
              "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing every module of the port leaves no
    jax or flexam_tpu module in sys.modules."""
    names = [n for _, n in _modules()]
    code = ("import sys\n"
            + "".join(f"import {n}\n" for n in names)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib')) or m == 'flexam_tpu' or "
              "m.startswith('flexam_tpu.'))\n"
              "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.io.convert import from_jax_params
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)

    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        FlexAMGenerationPipeline(FlexAMModels(cfg=cfg, dit_params={},
                                              vae_params={}))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_dit_params(cfg.dit)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({})
    # the geometry models (at tiny sizes: the default is raised before any
    # weight is made)
    from flexam_tpu_torch.perception.moge import MoGeConfig, MoGeModel
    from flexam_tpu_torch.perception.pi3 import Pi3, Pi3Config
    from flexam_tpu_torch.perception.vggt import VGGT, VGGTConfig
    tiny = dict(embed_dim=32, num_heads=2, num_register_tokens=0,
                pretrain_img_size=28)
    for make in (
            lambda **k: MoGeModel(MoGeConfig(depth=1, output_idx=(1,),
                                             head_dim=8, **tiny), **k),
            lambda **k: VGGT(VGGTConfig(
                embed_dim=32, enc_depth=1, enc_heads=2, agg_dim=32,
                agg_depth=1, agg_heads=2, cam_iters=1, cam_heads=2,
                depth_taps=(0,), depth_features=8), **k),
            lambda **k: Pi3(Pi3Config(
                embed_dim=32, enc_depth=1, enc_heads=2, dec_dim=32,
                dec_depth=1, dec_heads=2), **k)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert make(device="cpu").device.type == "cpu"
    # asked for explicitly, the CPU works
    params = init_dit_params(cfg.dit, device="cpu", dtype=torch.float32)
    FlexAMGenerationPipeline(FlexAMModels(cfg=cfg, dit_params=params,
                                          vae_params={}), device="cpu")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a CUDA device, and alone in a directory, the smoke exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_track_path_defaults_to_cuda():
    """The device rasterizer runs on CUDA unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    import numpy as np
    from flexam_tpu_torch.conditioning.rasterize_device import \
        DeviceRasterizer
    tracks = np.zeros((2, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceRasterizer(tracks, None, 8, 8)
    rast = DeviceRasterizer(tracks, None, 8, 8, device="cpu")
    assert rast.tracking_video().device.type == "cpu"
