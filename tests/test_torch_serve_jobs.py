"""The port's async job API (`flexam_tpu_torch.serve.JobManager`) on the
CPU: `tests/test_serve_jobs.py`'s cases with the same fake pipelines
(submit / status / result / cancel, progress from the pipeline's per-step
callback, error containment, eviction, health, the long-video windows, the
real tiny pipeline's progress and abort), then one HTTP round trip
(/submit -> /status -> /result, /health) on a 127.0.0.1 ephemeral port."""

import threading
import time

import numpy as np
import torch

from flexam_tpu_torch.serve import (GenerationServer, JobCancelled, _decode_array,
                              _encode_array)


def _wait(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


class SteppingPipe:
    """Fake pipeline that reports chunked progress and honors abort."""

    def __init__(self, steps=4, delay=0.05):
        self.steps, self.delay = steps, delay
        self.started = threading.Event()

    def generate(self, prompt, progress_cb=None, **kw):
        self.started.set()
        for i in range(self.steps):
            time.sleep(self.delay)
            if progress_cb is not None:
                progress_cb(i + 1, self.steps)
        return np.zeros((1, 3, 2, 8, 8), np.float32)


def _payload():
    return {"prompt": "hi",
            "video": _encode_array(np.zeros((1, 3, 2, 8, 8)))}


def test_submit_poll_result_with_progress():
    srv = GenerationServer(SteppingPipe())
    jid = srv.jobs.submit(_payload())
    st = srv.jobs.status(jid)
    assert st["state"] in ("queued", "running")
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "done")
    st = srv.jobs.status(jid)
    assert st["progress"] == {"step": 4, "total": 4}
    out = srv.jobs.result(jid)
    assert _decode_array(out["video"]).shape == (1, 3, 2, 8, 8)


def test_result_before_done_and_unknown():
    srv = GenerationServer(SteppingPipe(steps=10, delay=0.1))
    jid = srv.jobs.submit(_payload())
    assert "error" in srv.jobs.result(jid)      # not done yet
    assert "error" in srv.jobs.status("nope")
    assert "error" in srv.jobs.cancel("nope")
    srv.jobs.cancel(jid)


def test_cancel_queued_job():
    srv = GenerationServer(SteppingPipe(steps=20, delay=0.1))
    first = srv.jobs.submit(_payload())
    second = srv.jobs.submit(_payload())        # sits in queue
    assert srv.jobs.status(second)["queue_position"] is not None
    out = srv.jobs.cancel(second)
    assert out["state"] == "cancelled"
    assert srv.jobs.status(second)["state"] == "cancelled"
    srv.jobs.cancel(first)


def test_cancel_running_job_at_chunk_boundary():
    pipe = SteppingPipe(steps=50, delay=0.05)
    srv = GenerationServer(pipe)
    jid = srv.jobs.submit(_payload())
    assert pipe.started.wait(10)
    srv.jobs.cancel(jid)
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "cancelled")


def test_error_containment():
    class Boom:
        def generate(self, prompt, progress_cb=None, **kw):
            raise RuntimeError("boom")

    srv = GenerationServer(Boom())
    jid = srv.jobs.submit(_payload())
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "error")
    assert "boom" in srv.jobs.status(jid)["error"]
    # the worker survives the error and takes the next job
    srv2 = SteppingPipe(steps=1)
    srv.pipe = srv2
    jid2 = srv.jobs.submit(_payload())
    assert _wait(lambda: srv.jobs.status(jid2)["state"] == "done")


def test_eviction_keeps_recent():
    srv = GenerationServer(SteppingPipe(steps=1, delay=0.0))
    ids = [srv.jobs.submit(_payload()) for _ in range(12)]
    assert _wait(lambda: srv.jobs.status(ids[-1])["state"] == "done")
    # oldest finished jobs evicted past keep=8
    assert "error" in srv.jobs.status(ids[0])
    assert srv.jobs.status(ids[-1])["state"] == "done"


def test_health_endpoint():
    srv = GenerationServer(SteppingPipe())
    info = srv.health()
    assert info["ok"] and info["n_devices"] >= 1
    assert "queue_depth" in info and "busy" in info
    # the torch device instead of JAX's backend and link probe
    assert info["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert "link" not in info


class LongSteppingPipe:
    """Fake pipeline for the long-video path: the sliding-window loop
    calls `generate(video, prompt, ...)` positionally per window."""

    class _VaeCfg:
        temporal_compression_ratio = 4

    class _Cfg:
        vae = None

    def __init__(self, delay=0.05):
        self.delay = delay
        self.cfg = self._Cfg()
        self.cfg.vae = self._VaeCfg()
        self.windows = 0

    def generate(self, video, prompt, mask_video=None, progress_cb=None,
                 **kw):
        self.windows += 1
        for i in range(3):
            time.sleep(self.delay)
            if progress_cb is not None:
                progress_cb(i + 1, 3)
        return np.zeros_like(video)


def _long_payload(total=11, partial=5, overlap=2):
    return {"prompt": "hi", "video_length": total,
            "partial_video_length": partial,
            "overlap_video_length": overlap,
            "video": _encode_array(np.zeros((1, 3, total, 8, 8)))}


def test_long_video_job_reports_progress():
    """partial_video_length payloads get progress too (the windowed
    loop threads progress_cb into every window's generate)."""
    pipe = LongSteppingPipe(delay=0.02)
    srv = GenerationServer(pipe)
    jid = srv.jobs.submit(_long_payload())
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "done")
    assert srv.jobs.status(jid)["progress"] == {"step": 3, "total": 3}
    assert pipe.windows == 3                        # 11f @ 5/2 overlap
    out = srv.jobs.result(jid)
    assert _decode_array(out["video"]).shape[2] == 11


def test_long_video_job_cancels_mid_window():
    pipe = LongSteppingPipe(delay=0.2)
    srv = GenerationServer(pipe)
    jid = srv.jobs.submit(_long_payload())
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "running")
    time.sleep(0.1)
    srv.jobs.cancel(jid)
    assert _wait(lambda: srv.jobs.status(jid)["state"] == "cancelled")


def test_pipeline_progress_cb_plumbing():
    """The REAL tiny pipeline fires progress after each denoise step
    (generate -> generate_from_cond -> denoise plumbing)."""
    from tests.test_torch_serve import _port_pipe

    pipe = _port_pipe()
    seen = []
    pipe.generate(np.zeros((1, 3, 9, 32, 32), np.float32), "x",
                  num_inference_steps=3, guidance_scale=1.0,
                  progress_cb=lambda d, t: seen.append((d, t)))
    assert seen == [(1, 3), (2, 3), (3, 3)]


def test_pipeline_abort_via_progress_cb():
    from tests.test_torch_serve import _port_pipe

    pipe = _port_pipe()
    pipe.steps_per_launch = 1

    def abort(done, total):
        raise JobCancelled()

    try:
        pipe.generate(np.zeros((1, 3, 9, 32, 32), np.float32), "x",
                      num_inference_steps=3, guidance_scale=1.0,
                      progress_cb=abort)
        raise AssertionError("should have aborted")
    except JobCancelled:
        pass


def test_http_round_trip():
    """The HTTP front end on 127.0.0.1, driven as a remote client drives it:
    /health, /submit, /status until done, /result, an unknown job's 409 and
    the UI page; then the server shuts down."""
    import http.client
    import json

    srv = GenerationServer(SteppingPipe(steps=3, delay=0.02))
    th = threading.Thread(target=srv.serve, kwargs=dict(port=0,
                                                        host="127.0.0.1"),
                          daemon=True)
    th.start()
    assert _wait(lambda: srv.httpd is not None)
    port = srv.httpd.server_address[1]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request(method, path, json.dumps(body) if body else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    try:
        code, data = call("GET", "/health")
        assert code == 200 and json.loads(data)["ok"]
        code, data = call("POST", "/submit", _payload())
        jid = json.loads(data)["job_id"]
        assert _wait(lambda: json.loads(call("GET", f"/status/{jid}")[1])
                     ["state"] == "done")
        st = json.loads(call("GET", f"/status/{jid}")[1])
        assert st["progress"] == {"step": 3, "total": 3}
        code, data = call("GET", f"/result/{jid}")
        assert code == 200
        assert _decode_array(json.loads(data)["video"]).shape == \
            (1, 3, 2, 8, 8)
        assert call("GET", "/result/nope")[0] == 409
        code, data = call("GET", "/")
        assert code == 200 and b"/submit" in data
    finally:
        srv.httpd.shutdown()
        th.join(10)
    assert not th.is_alive()
