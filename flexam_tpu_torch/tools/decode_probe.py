"""Whole-clip against group-streamed VAE decode, on one CUDA card.

    python -m flexam_tpu_torch.tools.decode_probe [--frames 17,97]
    python -m flexam_tpu_torch.tools.decode_probe --ladder

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

`--ladder` looks at what a decode that runs out of memory leaves behind,
on the 48-channel VAE alone (no DiT): first each group size's peak above
its start at 97 frames (25 latent frames) for two frame sizes, beside
`decode_group_peak_bytes`'s estimate; then a 9-latent-frame group-4
decode at 512x896 timed and profiled, a 97-frame group-4 decode under
memory held so that only group 2's peak and three quarters of the gap to
group 4's stay free (which runs out of memory), and the short decode
timed and profiled again. It prints both profiles' kernels by device time
and the kernel names found on one side only.
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


def kernel_ms(fn) -> tuple:
    """(wall seconds, {kernel name: device ms}) of one call of `fn` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ms = {}
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0):
            ms[ev.key] = ms.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return wall, ms


def peak_above_start(fn) -> tuple:
    """(seconds, bytes allocated at the peak of `fn` above its start)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def ladder(dev, cfg) -> None:
    from flexam_tpu_torch.models.vae_stream import (decode_group_peak_bytes,
                                                    decode_widest_bytes,
                                                    vae_decode_streamed_u8)
    vae = init_vae_params(cfg.vae, seed=2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def decode(z, g):
        return vae_decode_streamed_u8(vae, cfg.vae, z, group_size=g)

    peaks = {}
    for lh, lw in ((32, 56), (30, 52)):
        z = torch.randn((1, cfg.vae.latent_channels, 25, lh, lw),
                        generator=gen, device=dev, dtype=torch.bfloat16)
        for g in (4, 2, 1):
            decode(z[:, :, :9], g)                  # cuDNN plans, warm
            s, peak = peak_above_start(lambda: decode(z, g))
            widest = decode_widest_bytes(cfg.vae, 1, lh, lw)
            peaks[(lh, lw, g)] = peak
            print(json.dumps({
                "latent": [25, lh, lw], "group": g, "seconds": s,
                "peak_above_start_gb": peak / 1e9,
                "estimate_gb": decode_group_peak_bytes(cfg.vae, 1, g, lh,
                                                       lw) / 1e9,
                "peak_in_widest_copies": peak / widest}), flush=True)
    z = torch.randn((1, cfg.vae.latent_channels, 25, 32, 56), generator=gen,
                    device=dev, dtype=torch.bfloat16)

    def short():
        decode(z[:, :, :9], 4)

    sides = {}
    for side in ("before", "after"):
        if side == "after":
            e2, e4 = peaks[(32, 56, 2)], peaks[(32, 56, 4)]
            torch.cuda.empty_cache()
            free, _ = torch.cuda.mem_get_info()
            target = e2 + 0.75 * (e4 - e2)
            ballast = torch.empty(max(0, int(free - target)),
                                  dtype=torch.uint8, device=dev)
            try:
                decode(z, 4)
                oom = False
            except torch.cuda.OutOfMemoryError:
                oom = True
            del ballast
            torch.cuda.empty_cache()
            print(json.dumps({"held_room_gb": target / 1e9,
                              "group4_out_of_memory": oom}), flush=True)
        times = [peak_above_start(short)[0] for _ in range(2)]
        wall, ms = kernel_ms(short)
        sides[side] = ms
        top = sorted(ms.items(), key=lambda kv: -kv[1])[:15]
        print(json.dumps({"side": side, "seconds": times,
                          "profiled_seconds": wall,
                          "device_ms": sum(ms.values()),
                          "top_kernels": [[round(v, 3), k[:110]]
                                          for k, v in top]}), flush=True)
    b, a = sides["before"], sides["after"]
    print(json.dumps({
        "only_before": {k[:110]: round(v, 3) for k, v in b.items()
                        if k not in a},
        "only_after": {k[:110]: round(v, 3) for k, v in a.items()
                       if k not in b}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", default="17,97")
    ap.add_argument("--ladder", action="store_true",
                    help="what a decode that runs out of memory leaves "
                         "behind (module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_probe: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = WAN22_5B_FLEXAM
    if args.ladder:
        ladder(dev, cfg)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
        return 0
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
