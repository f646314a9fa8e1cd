"""Whole-clip against group-streamed VAE decode, on one CUDA card.

    python -m flexam_tpu_torch.tools.decode_probe [--frames 17,97]

Builds the pipeline at full width (Wan2.2-Fun-5B: the DiT and the
48-channel VAE, random bf16 weights on the card, the DiT resident as on the
main path) and decodes random latents of each clip length at 512x896
through `FlexAMGenerationPipeline.decode_u8`, once with the streaming
threshold raised above the clip (whole clip) and once lowered below it
(groups of 2 latent frames), in the order whole, streamed, streamed, whole.
For each leg it prints the seconds and the peak memory allocated above what
was allocated before the decode; then whether the two decodes gave the same
uint8 video, and the nvidia-smi name and power limit. A whole-clip decode
that does not fit on the card is reported as out of memory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from flexam_tpu_torch.config import WAN22_5B_FLEXAM
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline, FlexAMModels


def decode_leg(pipe, lat, streamed: bool) -> tuple:
    """(uint8 video or None, JSON-able leg record)."""
    pipe.VAE_STREAM_THRESHOLD = 0 if streamed else 1 << 62
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        video = pipe.decode_u8(lat)
    except torch.cuda.OutOfMemoryError:
        video = None
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec = {"mode": "streamed" if streamed else "whole",
           "seconds": seconds, "out_of_memory": video is None,
           "resident_gb": base / 1e9,
           "peak_above_resident_gb":
               (torch.cuda.max_memory_allocated() - base) / 1e9}
    return video, rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", default="17,97")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_probe: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = WAN22_5B_FLEXAM
    models = FlexAMModels(
        cfg=cfg, dit_params=init_dit_params(cfg.dit, seed=1, device=dev),
        vae_params=init_vae_params(cfg.vae, seed=2, device=dev))
    pipe = FlexAMGenerationPipeline(models, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for frames in (int(f) for f in args.frames.split(",")):
        lt = (frames - 1) // 4 + 1
        lat = torch.randn((1, cfg.vae.latent_channels, lt, 512 // 16, 896 // 16),
                          generator=gen, device=dev, dtype=torch.bfloat16)
        for streamed in (False, True):         # cuDNN plans, allocator
            decode_leg(pipe, lat, streamed)
        legs, videos = [], {}
        for streamed in (False, True, True, False):
            video, rec = decode_leg(pipe, lat, streamed)
            legs.append(rec)
            videos.setdefault(rec["mode"], video)
        same = (None if any(v is None for v in videos.values())
                else bool(torch.equal(videos["whole"], videos["streamed"])))
        max_diff = (None if same is None else int(
            (videos["whole"].int() - videos["streamed"].int()).abs().max()))
        print(json.dumps({"frames": frames, "latent_frames": lt,
                          "counted_pixels": lt * 4 * 512 * 896,
                          "legs": legs, "same_uint8": same,
                          "max_uint8_diff": max_diff}), flush=True)
        del lat, videos
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
