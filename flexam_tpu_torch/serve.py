"""Minimal host/client generation API.

Port of `flexam_tpu/serve.py`: the reference's Gradio host/client protocol
(`FlexAM/ui/controller.py:345-424`) rebuilt on http.server. The host keeps
the model resident on the card and serializes requests; a client posts
JSON with base64 media (npz, the JAX package's wire format: either package
reads the other's payloads) and gets the video back. `JobManager` is the
async job API (submit, status with progress, result, cancel); `UI_HTML` a
built-in web form over it.

  python -m flexam_tpu_torch.serve --host --port 7860 --random_init tiny
  python -m flexam_tpu_torch.serve --client --prompt "..." --port 7860

Differences from JAX's module: `health` reports the torch device
("backend" "cuda" or "cpu", the card's name) and has no link probe; the
server-side tracker (`track_method`) runs on the pipeline's device, its
flow method the device tracker (JAX's host Farneback needs OpenCV);
`--platform` names the torch device. Pipeline work runs under `torch.no_grad()`, in whichever thread
serves it (grad mode is per thread).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np


def _decode_array(obj):
    buf = io.BytesIO(base64.b64decode(obj["data"]))
    arr = np.load(buf)
    return arr["arr"] if hasattr(arr, "files") else arr


def _encode_array(arr) -> dict:
    buf = io.BytesIO()
    np.savez_compressed(buf, arr=np.asarray(arr))
    return {"data": base64.b64encode(buf.getvalue()).decode()}


class JobCancelled(Exception):
    """Raised from a progress callback to abort a running generation
    between denoise steps."""


class JobManager:
    """Async job queue over one resident model: requests return at once,
    the card runs one job at a time.

    States: queued -> running -> done | error | cancelled. Progress comes
    from the pipeline's per-step callback, which also honours a cancel.
    Results are kept for the most recent `keep` jobs.
    """

    def __init__(self, server: "GenerationServer", keep: int = 8):
        import collections
        import uuid

        self._uuid = uuid.uuid4
        self.server = server
        self.keep = keep
        self.jobs: dict = {}
        self.queue: "collections.deque" = collections.deque()
        self.cv = threading.Condition()
        self._order: list = []
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def submit(self, payload: dict) -> str:
        jid = self._uuid().hex[:12]
        with self.cv:
            self.jobs[jid] = {"state": "queued", "progress": None,
                              "error": None, "result": None}
            self.queue.append((jid, payload))
            self._order.append(jid)
            # evict old finished jobs
            while len(self._order) > self.keep:
                old = self._order[0]
                if self.jobs.get(old, {}).get("state") in (
                        "done", "error", "cancelled"):
                    self._order.pop(0)
                    self.jobs.pop(old, None)
                else:
                    break
            self.cv.notify()
        return jid

    def status(self, jid: str) -> dict:
        with self.cv:
            job = self.jobs.get(jid)
            if job is None:
                return {"error": "unknown job"}
            pos = next((i for i, (q, _) in enumerate(self.queue)
                        if q == jid), None)
            return {"state": job["state"], "progress": job["progress"],
                    "queue_position": pos, "error": job["error"]}

    def result(self, jid: str) -> dict:
        with self.cv:
            job = self.jobs.get(jid)
        if job is None:
            return {"error": "unknown job"}
        if job["state"] != "done":
            return {"error": f"job is {job['state']}"}
        return job["result"]

    def cancel(self, jid: str) -> dict:
        with self.cv:
            job = self.jobs.get(jid)
            if job is None:
                return {"error": "unknown job"}
            if job["state"] == "queued":
                self.queue = type(self.queue)(
                    (q, p) for q, p in self.queue if q != jid)
                job["state"] = "cancelled"
            elif job["state"] == "running":
                job["cancel"] = True   # honoured at the next step
            return {"state": job["state"]}

    def _run(self):
        while True:
            with self.cv:
                while not self.queue:
                    self.cv.wait()
                jid, payload = self.queue.popleft()
                job = self.jobs[jid]
                if job["state"] == "cancelled":
                    continue
                job["state"] = "running"

            def progress(done, total, _job=job):
                _job["progress"] = {"step": int(done), "total": int(total)}
                if _job.get("cancel"):
                    raise JobCancelled()

            try:
                if payload.pop("ui", False):
                    result = self.server.handle_ui_payload(
                        payload, progress_cb=progress)
                else:
                    result = self.server.handle(payload,
                                                progress_cb=progress)
                job["result"], job["state"] = result, "done"
            except JobCancelled:
                job["state"] = "cancelled"
            except Exception as e:  # noqa: BLE001 — error containment
                job["error"], job["state"] = str(e), "error"


class GenerationServer:
    def __init__(self, pipeline, fps: int = 16):
        self.pipe = pipeline
        self.fps = fps
        self.lock = threading.Lock()
        self.jobs = JobManager(self)
        self.httpd = None

    # the Gradio parameter surface (`ui/wan2_2_fun_ui.py:178-399`): sampler
    # knobs, TeaCache, cfg-skip, RIFLEx, long-video sliding windows, and
    # the device-rasterized tracks path (tracks [T, N, 3] instead of full
    # control videos)
    SCALAR_KEYS = ("num_inference_steps", "guidance_scale", "seed",
                   "density", "scheduler_type", "cfg_skip_ratio",
                   "teacache_thresh", "teacache_skip_start",
                   "negative_prompt")

    def handle(self, payload: dict, progress_cb=None) -> dict:
        import torch

        kwargs = {}
        for key in ("video", "mask_video", "control_video", "depth_video",
                    "ref_image"):
            if key in payload:
                kwargs[key] = _decode_array(payload[key]).astype(np.float32)
        if "cos_videos" in payload:
            kwargs["cos_videos"] = [
                _decode_array(o).astype(np.float32)
                for o in payload["cos_videos"]]
        if payload.get("camera_conditions"):
            # the Control-Camera path (the ComfyUI sampler's input,
            # `wan2_2_fun_flexam/nodes.py:577-583`): generation is
            # camera-driven; a posted video gives the geometry and length
            from flexam_tpu_torch.conditioning.camera import \
                camera_inputs_from_trajectory
            if kwargs.get("video") is not None:
                _, _, t, ch, cw = kwargs["video"].shape
            else:
                t = int(payload.get("video_length", 49))
                ch = int(payload.get("height", 512))
                cw = int(payload.get("width", 896))
            (kwargs["camera_video"], kwargs["video"],
             kwargs["mask_video"]) = camera_inputs_from_trajectory(
                payload["camera_conditions"], t, ch, cw)
        for key in self.SCALAR_KEYS:
            if key in payload:
                kwargs[key] = payload[key]

        riflex_k = payload.get("riflex_k")
        with self.lock, torch.no_grad():   # one job on the card at a time
            if riflex_k:
                frames = (kwargs.get("video").shape[2]
                          if kwargs.get("video") is not None
                          else payload.get("video_length", 49))
                lat_frames = ((frames - 1)
                              // self.pipe.cfg.vae.temporal_compression_ratio
                              + 1)
                self.pipe.enable_riflex(
                    k=int(riflex_k),
                    L_test=int(payload.get("riflex_L_test", lat_frames)))
            try:
                if "tracks" in payload or "track_method" in payload:
                    out = self._generate_from_tracks(payload, kwargs,
                                                     progress_cb)
                elif "partial_video_length" in payload:
                    out = self._generate_long(payload, kwargs,
                                              progress_cb)
                else:
                    out = self.pipe.generate(prompt=payload["prompt"],
                                             progress_cb=progress_cb,
                                             **kwargs)
            finally:
                if riflex_k:
                    self.pipe.disable_riflex()
        return {"video": _encode_array(
            (np.asarray(out) * 255).astype(np.uint8)), "fps": self.fps}

    def _generate_from_tracks(self, payload, kwargs, progress_cb=None):
        """Tracks cross the wire (KBs) instead of rasterized videos: the
        device rasterizer builds the conditioning on the card. With
        `track_method` ("flow"/"delta"/"auto") and no precomputed tracks,
        the server runs the tracker on the posted video, on the pipeline's
        device: the client ships only the clip."""
        video = kwargs.get("video")
        gen_type = payload.get("generate_type", "full_edit")
        if "tracks" in payload:
            tracks = _decode_array(payload["tracks"]).astype(np.float32)
            vis = (_decode_array(payload["visibility"]).astype(bool)
                   if "visibility" in payload else None)
        else:
            from flexam_tpu_torch.perception.tracking import \
                dispatch_tracking
            if video is None:
                raise ValueError("track_method needs a posted video")
            tracks, vis = dispatch_tracking(
                video, payload.get("track_method", "auto"),
                density=int(payload.get("track_density", 10)),
                device=self.pipe.device)
        first = (_decode_array(payload["first_frame"]).astype(np.float32)
                 if "first_frame" in payload else None)
        v_shape = video.shape if video is not None else None
        if (first is None and video is not None
                and gen_type == "full_edit" and "tracks" not in payload):
            # motion transfer from a bare clip (track_method path only):
            # anchor on the clip's own first frame, as the demo's full_edit
            # does; payloads with precomputed tracks keep their
            # pass-through semantics
            first = video[:, :, :1]
            video = None
        h = int(payload.get("height", v_shape[3] if v_shape else 512))
        w = int(payload.get("width", v_shape[4] if v_shape else 896))
        cond = self.pipe.prepare_conditioning_from_tracks(
            tracks, vis, h, w,
            point_wise=int(payload.get("point_wise", 4)),
            generate_type=gen_type,
            video=video, first_frame=first,
            mask_video=kwargs.get("mask_video"),
            ref_image=kwargs.get("ref_image"))
        gen_kwargs = {k: v for k, v in kwargs.items()
                      if k in self.SCALAR_KEYS}
        neg = gen_kwargs.pop("negative_prompt", None)
        context = self.pipe.encode_prompt(
            payload["prompt"], neg,
            do_cfg=gen_kwargs.get("guidance_scale", 6.0) > 1.0)
        return self.pipe.generate_from_cond(cond, context,
                                            progress_cb=progress_cb,
                                            **gen_kwargs)

    def _generate_long(self, payload, kwargs, progress_cb=None):
        """Sliding-window long video (`ui/controller.py:324-325`,
        partial_video_length / overlap_video_length). progress_cb reports
        each window's denoise steps (and carries job cancellation)."""
        from flexam_tpu_torch.long_video import (generate_long_video,
                                                 window_inputs_from_seed)
        total = int(payload["video_length"])
        partial = int(payload["partial_video_length"])
        overlap = int(payload.get("overlap_video_length", 4))
        controls = {k: kwargs.get(k) for k in
                    ("control_video", "depth_video")}
        cos = kwargs.get("cos_videos")
        if kwargs.get("video") is not None:
            h, w = kwargs["video"].shape[-2:]
        elif controls["control_video"] is not None:
            h, w = controls["control_video"].shape[-2:]
        else:
            h, w = int(payload.get("height", 512)), \
                int(payload.get("width", 896))
        gen_kwargs = {k: v for k, v in kwargs.items()
                      if k in self.SCALAR_KEYS}

        def window(start_frames=None, num_frames=None, frame_offset=0):
            video, mask = window_inputs_from_seed(start_frames, num_frames,
                                                  h, w)
            sl = slice(frame_offset, frame_offset + num_frames)
            win = {k: (v[:, :, sl] if v is not None else None)
                   for k, v in controls.items()}
            cw = [c[:, :, sl] for c in cos] if cos else None
            return self.pipe.generate(
                video, payload["prompt"], mask_video=mask,
                control_video=win["control_video"],
                depth_video=win["depth_video"], cos_videos=cw,
                ref_image=kwargs.get("ref_image"),
                progress_cb=progress_cb, **gen_kwargs)

        return generate_long_video(
            window, total, partial, overlap,
            temporal_compression=self.pipe.cfg.vae
            .temporal_compression_ratio)

    def health(self) -> dict:
        """Liveness and observability: the torch device, queue depth, and
        the last denoise's diagnostics (`last_denoise_info`)."""
        import torch

        dev = getattr(self.pipe, "device", None)
        backend = (dev.type if isinstance(dev, torch.device)
                   else "cuda" if torch.cuda.is_available() else "cpu")
        info = {
            "ok": True,
            "backend": backend,
            "n_devices": (torch.cuda.device_count() if backend == "cuda"
                          else 1),
            "queue_depth": len(self.jobs.queue),
            "busy": self.lock.locked(),
        }
        if backend == "cuda":
            info["device_name"] = torch.cuda.get_device_name(
                dev if isinstance(dev, torch.device) else None)
        last = getattr(self.pipe, "last_denoise_info", None)
        if last:
            info["last_denoise"] = last
        cfg = getattr(self.pipe, "cfg", None)
        if cfg is not None:
            info["model"] = {"dim": cfg.dit.dim, "layers": cfg.dit.num_layers}
        return info

    # the built-in web UI (the reference's Gradio layer imports the absent
    # FlexAM/dist in its release): generation form -> /submit -> poll ->
    # inline video
    UI_HTML = """<!doctype html><html><head><title>FlexAM-TPU</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
label{display:block;margin-top:.6em}input,textarea,select{width:100%}
video{width:100%;margin-top:1em}button{margin-top:1em;padding:.5em 2em}
</style></head><body><h2>FlexAM-TPU generation</h2>
<form id=f>
<label>Prompt<textarea name=prompt rows=2>a cinematic scene</textarea></label>
<label>Negative prompt<textarea name=negative_prompt rows=1></textarea></label>
<label>Steps<input name=num_inference_steps type=number value=50></label>
<label>CFG<input name=guidance_scale type=number step=0.1 value=6.0></label>
<label>Seed<input name=seed type=number value=43></label>
<label>Density (the sampler receives 1/density like the reference)<input name=density type=number step=0.001 value=0.0667></label>
<label>Scheduler<select name=scheduler_type><option value="">default</option>
<option>flow_match_euler</option><option>flow_unipc</option>
<option>flow_dpm</option></select></label>
<label>TeaCache threshold<input name=teacache_thresh type=number step=0.01 value=0></label>
<label>CFG-skip ratio<input name=cfg_skip_ratio type=number step=0.05 value=0></label>
<label>RIFLEx k (0=off)<input name=riflex_k type=number value=0></label>
<label>Frames<input name=video_length type=number value=49></label>
<label>Height<input name=height type=number value=512></label>
<label>Width<input name=width type=number value=896></label>
<button>Generate</button></form>
<p id=status></p><video id=v controls></video>
<script>
f.onsubmit = async (e) => {
  e.preventDefault();
  const p = {ui: true}; new FormData(f).forEach((v, k) => { if (v !== "")
    p[k] = isNaN(v) ? v : Number(v); });
  status.textContent = "submitting...";
  const sub = await (await fetch("/submit", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(p)})).json();
  if (sub.error) { status.textContent = "error: " + sub.error; return; }
  for (;;) {
    const st = await (await fetch("/status/" + sub.job_id)).json();
    if (st.state === "done") break;
    if (st.state === "error" || st.state === "cancelled") {
      status.textContent = st.state + (st.error ? ": " + st.error : "");
      return;
    }
    status.textContent = st.state + (st.progress ?
      ` step ${st.progress.step}/${st.progress.total}` :
      (st.queue_position != null ? ` (queue ${st.queue_position})` : ""));
    await new Promise(r => setTimeout(r, 1000));
  }
  const out = await (await fetch("/result/" + sub.job_id)).json();
  if (out.error) { status.textContent = "error: " + out.error; return; }
  status.textContent = "done (" + out.fps + " fps)";
  v.src = "data:video/mp4;base64," + out.mp4;
};
</script></body></html>"""

    def handle_ui_payload(self, payload: dict, progress_cb=None) -> dict:
        """Form request: no input video, so a zeros video with an
        all-generate mask; returns the video file `save_video` writes (an
        mp4 through imageio, else its `.npz` frame dump) as base64 "mp4"."""
        t = int(payload.pop("video_length", 49))
        h = int(payload.pop("height", 512))
        w = int(payload.pop("width", 896))
        payload.setdefault("video", _encode_array(
            np.zeros((1, 3, t, h, w), np.float32)))
        out = self.handle(payload, progress_cb=progress_cb)
        video = _decode_array(out["video"]).astype(np.float32) / 255.0
        import tempfile

        from flexam_tpu_torch.utils.media import save_video
        with tempfile.TemporaryDirectory() as d:
            path = save_video(video, f"{d}/out.mp4", fps=self.fps)
            with open(path, "rb") as fh:
                mp4 = fh.read()
        out["mp4"] = base64.b64encode(mp4).decode()
        return out

    def serve(self, port: int = 7860, host: str = "0.0.0.0"):
        """Serve HTTP on (host, port) until `self.httpd.shutdown()`; port 0
        takes a free one (`self.httpd.server_address`)."""
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/status/"):
                    return self._json(server_ref.jobs.status(
                        self.path.rsplit("/", 1)[1]))
                if self.path.startswith("/result/"):
                    out = server_ref.jobs.result(
                        self.path.rsplit("/", 1)[1])
                    return self._json(out, 200 if "error" not in out
                                      else 409)
                if self.path == "/health":
                    return self._json(server_ref.health())
                body = server_ref.UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    if self.path.startswith("/cancel/"):
                        return self._json(server_ref.jobs.cancel(
                            self.path.rsplit("/", 1)[1]))
                    payload = json.loads(self.rfile.read(n))
                    if self.path == "/submit":
                        # async job API: returns at once
                        return self._json(
                            {"job_id": server_ref.jobs.submit(payload)})
                    media = any(k in payload for k in
                                ("video", "control_video", "tracks",
                                 "first_frame", "track_method"))
                    result = (server_ref.handle(payload) if media
                              else server_ref.handle_ui_payload(payload))
                    body = json.dumps(result).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                print(f"[serve] {fmt % args}", flush=True)

        self.httpd = HTTPServer((host, port), Handler)
        print(f"[serve] listening on :{self.httpd.server_address[1]}",
              flush=True)
        self.httpd.serve_forever()


def post_generate(payload: dict, port: int = 7860,
                  host: str = "127.0.0.1") -> dict:
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=3600)
    conn.request("POST", "/generate", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return json.loads(resp.read())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", action="store_true")
    p.add_argument("--client", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--prompt", type=str, default="a video")
    p.add_argument("--random_init", type=str, default="tiny")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--platform", type=str, default=None,
                   help="cpu runs on the CPU; none or cuda on the card")
    p.add_argument("--quant", type=str, default=None,
                   choices=["int8", "fp8"],
                   help="DiT weight quantization for the resident model "
                        "(int8: int8 block linears; fp8: float8 weight "
                        "storage); both halve the resident DiT, timed by "
                        "tools/serving_bench.py")
    p.add_argument("--prequant", type=str, default=None,
                   help="prequantized DiT .npz (tools/prequant_ckpt) or a "
                        "serve bundle with the VAE: narrow upload, no "
                        "quantization at startup")
    # client-side generation knobs (`ui/wan2_2_fun_ui.py:178-399` surface)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--cfg", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--scheduler", type=str, default=None)
    p.add_argument("--cfg_skip_ratio", type=float, default=0.0)
    p.add_argument("--teacache_thresh", type=float, default=0.0)
    p.add_argument("--riflex_k", type=int, default=0)
    p.add_argument("--video_length", type=int, default=9)
    p.add_argument("--sample_size", type=int, nargs=2, default=[32, 32])
    p.add_argument("--partial_video_length", type=int, default=0)
    p.add_argument("--overlap_video_length", type=int, default=4)
    args = p.parse_args(argv)

    if args.host:
        from flexam_tpu_torch.demo import _build_models
        pipe = _build_models(argparse.Namespace(
            checkpoint_path=args.checkpoint_path,
            random_init=args.random_init, quant=args.quant,
            prequant=args.prequant, platform=args.platform))
        GenerationServer(pipe).serve(args.port)
    elif args.client:
        t = args.video_length
        h, w = args.sample_size
        rng = np.random.RandomState(0)
        payload = {
            "prompt": args.prompt,
            "video": _encode_array(rng.rand(1, 3, t, h, w)),
            "mask_video": _encode_array(np.ones((1, 1, t, h, w))),
            "control_video": _encode_array(rng.rand(1, 3, t, h, w)),
            "num_inference_steps": args.steps,
            "guidance_scale": args.cfg,
            "seed": args.seed,
            "cfg_skip_ratio": args.cfg_skip_ratio,
            "teacache_thresh": args.teacache_thresh,
            "density": 0.1,
            "video_length": t,
        }
        if args.scheduler:
            payload["scheduler_type"] = args.scheduler
        if args.riflex_k:
            payload["riflex_k"] = args.riflex_k
        if args.partial_video_length:
            payload["partial_video_length"] = args.partial_video_length
            payload["overlap_video_length"] = args.overlap_video_length
        out = post_generate(payload, args.port)
        if "error" in out:
            raise SystemExit(f"server error: {out['error']}")
        video = _decode_array(out["video"])
        print(f"received video {video.shape}")


if __name__ == "__main__":
    main()
