"""Time to first video for a cold serving process on the card.

Port of `flexam_tpu/tools/cold_start.py`. The deployment recipe under
test: a fresh process, a prequantized int8 DiT `.npz` (`tools/
prequant_ckpt.py`'s format, JAX's stacked layout), its weights crossing
PCIe, and the CUDA kernels built (or their built library loaded) at first
use. Levers on the upload:

  --upload-threads N   host-to-card copies from N threads, each on its own
                       CUDA stream;
  --overlap            the DiT upload runs in a background thread, on side
                       streams, while the main thread acquires the VAE and
                       prepares the conditioning on the default stream
                       (prepare needs no DiT); the denoise waits on the
                       upload's events;
  --stream-upload      each npz member is copied to the card as soon as it
                       is read, so the disk read hides under the copies;
  serve bundle         --make-prequant --with-vae packs the VAE (bf16)
                       under vae/ ahead of dit/ in one npz: the stream
                       uploader copies vae/ first and hands it to the
                       prepare stage (cast to float32 on the card) while
                       dit/ is still crossing.

Usage (on the card):
  python -m flexam_tpu_torch.tools.cold_start \\
      --make-prequant build/bundle.npz --with-vae
  python -m flexam_tpu_torch.tools.cold_start --prequant build/bundle.npz \\
      --overlap --upload-threads 4 --stream-upload
  python -m flexam_tpu_torch.tools.cold_start --platform cpu --tiny \\
      --make-prequant /tmp/tiny.npz --with-vae     (then --prequant, with
      --size 32 32 --frames 9 --steps 2)

Prints one JSON line: every stage in seconds, and the time to the first
video `ttfv_s`, since the module was imported (a fresh process's start).
JAX's record, less its link probe (`probe_rtt_ms`, `healthy`,
`probe_done_s`) and `--aot-cache`, which are the TPU's (ROADMAP A15); in
their place `kernel_build_s` is the kernel library's build or load at
first use, the card's counterpart of compiling (`kernel_build_cached`:
whether a build of the same sources was on disk). On the CPU there are no
kernels and both are null. `video_shape` is the port's decode layout,
[B, 3, T, H, W]. Times are host clock around work that ends in a
synchronize, unrounded.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys
import threading
import time

import numpy as np

_T0 = time.perf_counter()


def log(msg):
    print(f"[cold_start +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _since_start() -> float:
    return time.perf_counter() - _T0


def make_prequant(out_path: str, with_vae: bool = False, cfg=None,
                  device="cuda") -> None:
    """Write a prequantized int8 DiT `.npz` with random values: the DiT of
    `cfg` (default Wan2.2-Fun-5B at full depth) drawn in bf16 from seed 0 on
    `device`, quantized as `tools/prequant_ckpt` quantizes a checkpoint,
    the rest cast to the deploy dtype, and written in JAX's stacked layout.
    Upload and kernel timings do not depend on the values.

    with_vae packs the VAE (seed 1, stored bf16) under `vae/` ahead of the
    `dit/` tree: one serve bundle, whose `vae/` members the stream
    uploader copies first."""
    import torch

    from flexam_tpu_torch.config import WAN22_5B_FLEXAM
    from flexam_tpu_torch.device import resolve_device
    from flexam_tpu_torch.io.checkpoints import save_pytree
    from flexam_tpu_torch.io.convert import (map_leaves, stack_blocks,
                                             tree_leaves)
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.tools.prequant_ckpt import (_cast_wide_to_bf16,
                                                      prequantize)

    cfg = cfg or WAN22_5B_FLEXAM
    dev = resolve_device(device)

    def to_host(tree):
        return map_leaves(tree, lambda k, t, b: t.cpu())

    dit = init_dit_params(cfg.dit, seed=0, dtype=torch.bfloat16, device=dev)
    tree = stack_blocks(to_host(_cast_wide_to_bf16(prequantize(dit,
                                                               "int8"))))
    del dit
    if with_vae:
        from flexam_tpu_torch.models.vae import init_vae_params
        # dict order is the npz member order: vae/ first
        tree = {"vae": to_host(init_vae_params(cfg.vae, seed=1,
                                               dtype=torch.bfloat16,
                                               device=dev)),
                "dit": tree}
    n = sum(t.nbytes for t in tree_leaves(tree))
    save_pytree(out_path, tree)
    log(f"wrote {n / 1e9:.2f} GB prequantized tree -> {out_path}")


class _Uploader:
    """Host-to-device copies from `n_threads` threads. On a CUDA device each
    thread copies on its own stream: the copy's memory comes from that
    stream's pool and is recorded on the consumer stream (the creating
    thread's current stream, the default stream in a fresh thread, where
    the denoise runs), so the caching allocator never hands it to a side
    stream while the consumer may still read it. `wait()` returns when
    every copy is done and orders the consumer stream after each copy's
    event. On the CPU a put is the tensor itself."""

    def __init__(self, n_threads: int, device):
        import torch
        self.device = device
        self.cuda = device.type == "cuda"
        self.consumer = (torch.cuda.current_stream(device) if self.cuda
                         else None)
        self.pool = cf.ThreadPoolExecutor(max_workers=max(n_threads, 1))
        self.local = threading.local()
        self.events = []
        self.lock = threading.Lock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True)

    def _put(self, t):
        import torch
        if not self.cuda:
            return t.to(self.device)
        stream = getattr(self.local, "stream", None)
        if stream is None:
            stream = self.local.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            d = t.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        d.record_stream(self.consumer)
        with self.lock:
            self.events.append(ev)
        return d

    def submit(self, t) -> cf.Future:
        return self.pool.submit(self._put, t)

    def wait(self) -> None:
        """Block until every copy so far is done; the consumer stream then
        waits on each copy's event (already complete: the default stream
        is not held up by a copy while another thread queues work on it)."""
        with self.lock:
            events = list(self.events)
        for ev in events:
            ev.synchronize()
            self.consumer.wait_event(ev)


def parallel_put(tree, n_threads: int, device="cuda"):
    """Every leaf of a host tree copied to `device` by `n_threads` threads,
    each on its own stream, largest leaves first (JAX's order); returns the
    device tree once the copies are done and the current stream is ordered
    after them."""
    from flexam_tpu_torch.device import resolve_device
    from flexam_tpu_torch.io.convert import map_leaves, tree_leaves

    dev = resolve_device(device)
    leaves = tree_leaves(tree)
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].nbytes)
    with _Uploader(n_threads, dev) as up:
        futs = {i: up.submit(leaves[i]) for i in order}
        out = [futs[i].result() for i in range(len(leaves))]
        if up.cuda:
            up.wait()
    it = iter(out)
    return map_leaves(tree, lambda k, t, b: next(it))


def stream_upload_npz(path: str, n_threads: int,
                      priority_prefix: str = None,
                      on_priority_ready=None,
                      cast_wide_prefix: str = None, device="cuda"):
    """Read a save_pytree `.npz` and copy each member to `device` as soon as
    it is read, from `n_threads` threads (each on its own stream), so the
    read of the next member overlaps the copies of the earlier ones.
    Returns (the nested device tree in the file's layout, its bytes).

    `priority_prefix` members are read and copied first; once the last of
    them is on the device, `on_priority_ready(subtree)` is called from the
    reading thread (a bundle's `vae/` tree becomes usable while `dit/` is
    still crossing). `cast_wide_prefix` ("" for all members) casts the
    matching members by `pipeline._put_quantized`'s rule on the host, so
    float32 matrices but the scales cross as bf16: the streamed tree has
    the leaf dtypes of the restore-then-put recipe."""
    from flexam_tpu_torch.device import resolve_device
    from flexam_tpu_torch.io.checkpoints import nest_flat_paths, npz_member
    from flexam_tpu_torch.io.convert import deploy_dtype

    dev = resolve_device(device)
    futs = {}
    n_bytes = 0
    with np.load(path) as z, _Uploader(n_threads, dev) as up:
        files = list(z.files)
        if priority_prefix:
            files.sort(key=lambda k: not k.startswith(priority_prefix))
        n_prio = sum(1 for k in files
                     if priority_prefix and k.startswith(priority_prefix))
        for idx, k in enumerate(files):
            key, t = npz_member(z, k)
            if (cast_wide_prefix is not None
                    and key.startswith(cast_wide_prefix)):
                wide = deploy_dtype(t, key.rsplit("/", 1)[-1], False)
                if wide is not None:
                    t = t.to(wide)
            n_bytes += t.nbytes
            futs[key] = up.submit(t)
            if on_priority_ready is not None and idx + 1 == n_prio:
                sub = {kk[len(priority_prefix):]: f.result()
                       for kk, f in futs.items()
                       if kk.startswith(priority_prefix)}
                if up.cuda:
                    up.wait()
                on_priority_ready(nest_flat_paths(sub))
                on_priority_ready = None
        flat = {k: f.result() for k, f in futs.items()}
        if up.cuda:
            up.wait()
    return nest_flat_paths(flat), n_bytes


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--make-prequant", metavar="OUT.npz",
                    help="write a random int8 DiT npz (full depth, or the "
                         "tiny config with --tiny) and exit")
    ap.add_argument("--with-vae", action="store_true",
                    help="with --make-prequant: pack the VAE under vae/ "
                         "ahead of dit/ (one serve bundle)")
    ap.add_argument("--prequant", metavar="NPZ",
                    help="prequantized DiT tree (or serve bundle) to serve")
    ap.add_argument("--overlap", action="store_true",
                    help="upload the DiT concurrently with the prepare stage")
    ap.add_argument("--upload-threads", type=int, default=1)
    ap.add_argument("--stream-upload", action="store_true",
                    help="copy each npz member to the card as it is read")
    ap.add_argument("--size", type=int, nargs=2, default=(512, 896),
                    metavar=("H", "W"))
    ap.add_argument("--frames", type=int, default=97)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance", type=float, default=6.0)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (pair with --size 32 32 --frames 9 "
                         "--steps 2 and a tiny --prequant file)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; none or cuda on the card")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    from flexam_tpu_torch.config import WAN22_5B_FLEXAM, tiny_test_config
    from flexam_tpu_torch.demo import _device
    from flexam_tpu_torch.device import resolve_device

    device = resolve_device(_device(args.platform))
    cfg = tiny_test_config() if args.tiny else WAN22_5B_FLEXAM
    if args.make_prequant:
        make_prequant(args.make_prequant, with_vae=args.with_vae, cfg=cfg,
                      device=device)
        return 0
    if not args.prequant:
        build_argparser().error("--prequant or --make-prequant required")
    return _serve_cold(args, cfg, device, torch)


def _serve_cold(args, cfg, device, torch):
    from flexam_tpu_torch.io.checkpoints import restore_pytree_nested
    from flexam_tpu_torch.io.convert import (from_jax_params, map_leaves,
                                             tree_leaves)
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels, _put_quantized)
    from flexam_tpu_torch.tools.serving_bench import synthetic_inputs

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def float_vae(tree):
        # bundles ship the VAE in bf16 for the bytes; it computes in float32
        return map_leaves(tree, lambda k, t, b: (
            t.float() if t.dtype == torch.bfloat16 else t))

    rec = {"recipe": "prequant-int8 + kernels built at first use",
           "overlap": args.overlap, "upload_threads": args.upload_threads,
           "stream_upload": args.stream_upload}
    with np.load(args.prequant) as z:
        bundle = any(k.startswith("vae/") for k in z.files[:4])
    rec["bundle"] = bundle
    vae_ready = threading.Event()
    shared = {}

    def vae_arrived(subtree):
        shared["vae"] = float_vae(from_jax_params(subtree, device))
        sync()
        rec["vae_upload_done_s"] = _since_start()
        log(f"bundle vae/ on the device (+{rec['vae_upload_done_s']:.1f}s)")
        vae_ready.set()

    if args.stream_upload:
        host_dit = None
        rec["npz_load_s"] = 0.0                # folded into the upload
        rec["dit_gb"] = os.path.getsize(args.prequant) / 1e9
    else:
        t0 = time.perf_counter()
        host_dit = restore_pytree_nested(args.prequant)
        if bundle:
            shared["host_vae"] = host_dit["vae"]
            host_dit = host_dit["dit"]
        rec["npz_load_s"] = time.perf_counter() - t0
        rec["dit_gb"] = sum(t.nbytes for t in tree_leaves(host_dit)) / 1e9
        log(f"npz load: {rec['npz_load_s']:.1f}s ({rec['dit_gb']:.2f} GB)")

    def upload_dit():
        """The DiT in the file's layout on the device, its copies done and
        the default stream (the denoise's) ordered after them."""
        t0 = time.perf_counter()
        if args.stream_upload:
            dev_tree, nb = stream_upload_npz(
                args.prequant, args.upload_threads,
                priority_prefix="vae/" if bundle else None,
                on_priority_ready=vae_arrived if bundle else None,
                cast_wide_prefix="dit/" if bundle else "", device=device)
            rec["dit_gb"] = nb / 1e9
            if bundle:
                dev_tree = dev_tree["dit"]
        elif args.upload_threads > 1:
            dev_tree = parallel_put(host_dit, args.upload_threads, device)
        else:
            dev_tree = _put_quantized(host_dit, device)
            sync()
        rec["upload_s"] = time.perf_counter() - t0
        log(f"DiT upload: {rec['upload_s']:.1f}s "
            f"({rec['dit_gb'] / max(rec['upload_s'], 1e-9):.2f} GB/s)")
        return dev_tree

    uploader = None
    if args.overlap:
        pool = cf.ThreadPoolExecutor(max_workers=1)
        uploader = pool.submit(upload_dit)
    else:
        dit_dev = upload_dit()

    # everything that does not need the DiT: the VAE and the prepare stage
    t0 = time.perf_counter()
    if bundle and args.stream_upload:
        while not vae_ready.wait(timeout=1.0):
            if uploader is not None and uploader.done():
                uploader.result()   # the upload failed before the VAE came
        vae_params = shared["vae"]
    elif bundle:
        vae_params = float_vae(from_jax_params(shared.pop("host_vae"),
                                               device))
    else:
        vae_params = init_vae_params(cfg.vae, seed=1, dtype=torch.float32,
                                     device=device)
    sync()
    rec["vae_init_s"] = time.perf_counter() - t0

    dt = torch.float32 if args.tiny else torch.bfloat16
    h, w = args.size
    frame, tracks = synthetic_inputs(h, w, args.frames)
    ctx = torch.from_numpy(np.random.RandomState(0).randn(
        2, cfg.t5.text_length, cfg.dit.text_dim) * 0.02).to(device, dt)

    # a pipeline without a DiT carries the prepare stage while the upload runs
    prep_pipe = FlexAMGenerationPipeline(
        FlexAMModels(cfg=cfg, dit_params=None, vae_params=vae_params),
        device=device, compute_dtype=dt)
    t0 = time.perf_counter()
    cond = prep_pipe.prepare_conditioning_from_tracks(
        tracks, None, h, w, point_wise=4, first_frame=frame)
    sync()
    rec["prepare_s"] = time.perf_counter() - t0
    log(f"prepare: {rec['prepare_s']:.1f}s")

    rec["kernel_build_s"] = rec["kernel_build_cached"] = None
    if cuda:
        from flexam_tpu_torch.ops import build
        t0 = time.perf_counter()
        build.library()
        rec["kernel_build_s"] = time.perf_counter() - t0
        rec["kernel_build_cached"] = build.build_info["cached"]
        log(f"kernels: {rec['kernel_build_s']:.1f}s "
            f"(cached {rec['kernel_build_cached']})")

    if uploader is not None:
        t0 = time.perf_counter()
        dit_dev = uploader.result()
        pool.shutdown()
        rec["upload_join_s"] = time.perf_counter() - t0
        log(f"upload join (wait after prepare): {rec['upload_join_s']:.1f}s")

    pipe = FlexAMGenerationPipeline(
        FlexAMModels(cfg=cfg, dit_params=from_jax_params(dit_dev, device),
                     vae_params=vae_params),
        device=device, compute_dtype=dt)
    del host_dit, dit_dev

    t0 = time.perf_counter()
    latents = pipe.denoise(cond, ctx, num_inference_steps=args.steps,
                           guidance_scale=args.guidance, seed=0)
    sync()
    rec["denoise_s"] = time.perf_counter() - t0
    rec["steps_per_s"] = args.steps / max(rec["denoise_s"], 1e-9)
    log(f"denoise: {rec['denoise_s']:.1f}s")

    t0 = time.perf_counter()
    u8 = pipe.decode_u8(latents)                # on the host: the copy syncs
    rec["decode_s"] = time.perf_counter() - t0
    rec["video_shape"] = list(u8.shape)
    rec["ttfv_s"] = _since_start()
    log(f"decode: {rec['decode_s']:.1f}s; time to first video "
        f"{rec['ttfv_s']:.1f}s")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
