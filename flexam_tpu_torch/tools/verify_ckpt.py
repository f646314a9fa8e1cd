"""Checkpoint-map verification CLI (the reference's own load report,
`wan_transformer3d_FlexAM.py:1321-1329`, for each loader of the port).

Port of `flexam_tpu/tools/verify_ckpt.py`:

    python -m flexam_tpu_torch.tools.verify_ckpt --model dit path/transformer/
    python -m flexam_tpu_torch.tools.verify_ckpt --model vae path/Wan2.2_VAE.pth
    python -m flexam_tpu_torch.tools.verify_ckpt --model t5  path/models_t5_umt5-xxl-enc-bf16.pth
    python -m flexam_tpu_torch.tools.verify_ckpt --model delta path/densetrack3d.pth
    python -m flexam_tpu_torch.tools.verify_ckpt --model unidepth path/ckpt
    python -m flexam_tpu_torch.tools.verify_ckpt --model moge path/model.pt
    python -m flexam_tpu_torch.tools.verify_ckpt --model vggt path/model.safetensors
    python -m flexam_tpu_torch.tools.verify_ckpt --model pi3 path/model.safetensors
    python -m flexam_tpu_torch.tools.verify_ckpt --model zoe path/ZoeD_M12_N.pt
    python -m flexam_tpu_torch.tools.verify_ckpt --model dav2 path/depth_anything_v2_vitl.pth
    python -m flexam_tpu_torch.tools.verify_ckpt --model flux flux1-depth-dev.safetensors
    python -m flexam_tpu_torch.tools.verify_ckpt --model svd-vae vae.safetensors
    # flux / flux-ae / svd-unet / svd-vae / svd-clip

The dit, vae, t5, unidepth and zoe loaders (`io/checkpoints.py`,
`perception/{unidepth,zoedepth}.py`) are name-mapped: they raise on any
missing key, so success means every expected tensor was found; dav2's
(`perception/depth_anything.py`) is name-mapped and raises below full
coverage. The delta, moge, vggt and pi3 loaders
(`perception/{densetrack3d,moge,vggt,pi3}.py`) map by shape and print
per-module coverage (`io/verify_load.py`); `--threshold` is their bar
(moge's loader, which raises below it, reports instead, under
FLEXAM_MOGE_BESTEFFORT=1 for the call). The FLUX / SVD kinds run their
single-file maps (`models/{flux,flux_vae,svd_unet,svd_vae,clip}.py`) and
print the coverage report, as JAX's. Exit status 0 = the checkpoint
passes, 1 = it does not. The checkpoint loads onto the card unless
`--platform cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

KINDS = ["delta", "moge", "unidepth", "dit", "vae", "t5", "pi3", "vggt",
         "zoe", "dav2", "flux", "flux-ae", "svd-unet", "svd-vae",
         "svd-clip"]


def _report_name_mapped(kind: str, path: str, load_fn) -> bool:
    """Name-mapped loaders raise on any missing key: success means 100% of
    the expected tensors were found."""
    try:
        load_fn()
    except KeyError as e:
        print(f"{kind}[{path}]: FAILED — missing checkpoint key {e}")
        return False
    except Exception as e:  # malformed file, wrong format ...
        print(f"{kind}[{path}]: FAILED — {type(e).__name__}: {e}")
        return False
    print(f"{kind}[{path}]: OK — all expected tensors found "
          "(exact name-mapped loader)")
    return True


def verify(kind: str, path: str, device=None,
           threshold: float = 0.9) -> bool:
    """True when the `kind` loader maps every expected tensor of `path`
    (the shape-mapped kinds: their coverage passes `threshold`), loaded
    onto `device` (CUDA unless the caller asks for the CPU)."""
    if kind not in KINDS:
        raise SystemExit(f"unknown --model {kind}")
    from flexam_tpu_torch.config import FlexAMConfig
    from flexam_tpu_torch.device import resolve_device
    from flexam_tpu_torch.io import checkpoints as ck
    device = resolve_device("cuda" if device is None else device)
    if kind == "delta":
        from flexam_tpu_torch.io.verify_load import check_mapping
        from flexam_tpu_torch.perception.densetrack3d import \
            load_densetrack3d
        model = load_densetrack3d(path, verify=False,
                                  coverage_threshold=threshold,
                                  device=device)
        return check_mapping(model.load_report, name=f"delta[{path}]",
                             threshold=threshold)
    if kind == "moge":
        from flexam_tpu_torch.io.verify_load import check_mapping
        from flexam_tpu_torch.perception.moge import load_moge
        before = os.environ.get("FLEXAM_MOGE_BESTEFFORT")
        os.environ["FLEXAM_MOGE_BESTEFFORT"] = "1"     # report, don't raise
        try:
            model = load_moge(path, coverage_threshold=threshold,
                              device=device)
        finally:
            if before is None:
                del os.environ["FLEXAM_MOGE_BESTEFFORT"]
            else:
                os.environ["FLEXAM_MOGE_BESTEFFORT"] = before
        return check_mapping(model.load_report, name=f"moge[{path}]",
                             threshold=threshold)
    if kind in ("pi3", "vggt"):
        from flexam_tpu_torch.io.verify_load import check_mapping
        if kind == "pi3":
            from flexam_tpu_torch.perception.pi3 import load_pi3 as loader
        else:
            from flexam_tpu_torch.perception.vggt import load_vggt as loader
        try:
            model = loader(path, coverage_threshold=threshold, device=device)
        except Exception as e:  # malformed file, wrong format ...
            print(f"{kind}[{path}]: FAILED — {type(e).__name__}: {e}")
            return False
        return check_mapping(model.load_report, name=f"{kind}[{path}]",
                             threshold=threshold)
    if kind == "unidepth":
        from flexam_tpu_torch.perception.unidepth import load_unidepth
        return _report_name_mapped(
            kind, path, lambda: load_unidepth(path, device=device))
    if kind == "zoe":
        from flexam_tpu_torch.perception.zoedepth import load_zoedepth
        return _report_name_mapped(
            kind, path, lambda: load_zoedepth(path, device=device))
    if kind == "dav2":
        from flexam_tpu_torch.perception.depth_anything import load_dav2
        return _report_name_mapped(
            kind, path, lambda: load_dav2(path, device=device))
    if kind in ("flux", "flux-ae", "svd-unet", "svd-vae", "svd-clip"):
        from flexam_tpu_torch.io.verify_load import check_mapping
        return check_mapping(_single_file_report(kind, ck._load_one(path),
                                                 device),
                             name=f"{kind}[{path}]", threshold=threshold)
    cfg = FlexAMConfig()
    load = {"dit": lambda: ck.load_dit_checkpoint(path, cfg.dit,
                                                  device=device),
            "vae": lambda: ck.load_vae_checkpoint(path, cfg.vae,
                                                  device=device),
            "t5": lambda: ck.load_t5_checkpoint(path, cfg.t5,
                                                device=device)}[kind]
    return _report_name_mapped(kind, path, load)


def _single_file_report(kind: str, sd, device) -> dict:
    """The coverage report of a FLUX / SVD kind's map over `sd` (the
    tensors mapped onto `device`, as the loaders do; FLUX's 12 B in
    bfloat16, the repainter's dtype)."""
    import torch
    if kind == "flux":
        from flexam_tpu_torch.models.flux import (FluxConfig,
                                                  flux_params_from_state_dict)
        return flux_params_from_state_dict(sd, FluxConfig(),
                                           dtype=torch.bfloat16,
                                           device=device)[1]
    if kind == "flux-ae":
        from flexam_tpu_torch.models.flux_vae import (
            FluxVAEConfig, flux_vae_params_from_state_dict)
        return flux_vae_params_from_state_dict(sd, FluxVAEConfig(),
                                               device=device)[1]
    if kind == "svd-unet":
        from flexam_tpu_torch.models.svd_unet import (
            SVDUNetConfig, svd_unet_params_from_state_dict)
        return svd_unet_params_from_state_dict(sd, SVDUNetConfig(),
                                               device=device)[1]
    if kind == "svd-vae":
        from flexam_tpu_torch.perception.depthcrafter_model import (
            SD_VAE_CONFIG, temporal_decoder_config)
        if "decoder.time_conv_out.weight" in sd:
            from flexam_tpu_torch.models.svd_vae import \
                svd_vae_params_from_state_dict
            return svd_vae_params_from_state_dict(
                sd, SD_VAE_CONFIG, temporal_decoder_config(SD_VAE_CONFIG),
                device=device)[1]
        from flexam_tpu_torch.models.flux_vae import \
            flux_vae_params_from_state_dict
        return flux_vae_params_from_state_dict(sd, SD_VAE_CONFIG,
                                               device=device)[1]
    from flexam_tpu_torch.models.clip import clip_vision_params_from_hf
    return clip_vision_params_from_hf(sd, device=device)[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", required=True, choices=KINDS)
    ap.add_argument("--platform", default=None,
                    help="torch device to load onto: cuda (the default) "
                         "or cpu")
    ap.add_argument("--threshold", type=float, default=0.9,
                    help="coverage bar of the shape-mapped loaders")
    ap.add_argument("path")
    args = ap.parse_args(argv)
    from flexam_tpu_torch.demo import _device
    return 0 if verify(args.model, args.path, _device(args.platform),
                       args.threshold) else 1


if __name__ == "__main__":
    sys.exit(main())
