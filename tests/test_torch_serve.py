"""The port's serving API (`flexam_tpu_torch.serve`) on the CPU: the cases of
`tests/test_serve.py` through the port's handler, then parity with JAX's
`GenerationServer`: the wire format read both ways, the same payloads
reaching each package's pipeline with equal arguments, and the decoded
videos of both servers within one uint8 level when the port's pipeline
draws JAX's noise.

The tiny pipelines carry JAX's `_tiny_pipe` weights (PRNGKey(0), fp32)
through `from_jax_params`. The server-side tracker (`track_method`) runs
on the pipeline's device (`tests/test_torch_video_tracking.py` holds it to
JAX's server)."""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu import serve as jserve
from flexam_tpu_torch import serve as tserve
from flexam_tpu_torch.serve import (GenerationServer, _decode_array,
                                    _encode_array)


def _jax_tiny_params(cfg):
    from flexam_tpu.models.dit import init_dit_params
    from flexam_tpu.models.t5 import init_t5_params
    from flexam_tpu.models.vae import init_vae_params
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    return (init_dit_params(k1, cfg.dit, dtype=jnp.float32),
            init_vae_params(k2, cfg.vae), init_t5_params(k3, cfg.t5))


def _port_pipe(cfg=None, pipe_cls=None):
    """The port's tiny pipeline on JAX's `_tiny_pipe` weights (or those of
    `cfg`, a port config with JAX's twin of the same fields)."""
    import dataclasses

    from flexam_tpu.config import tiny_test_config as jax_tiny
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.io.convert import from_jax_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    cfg = cfg or tiny_test_config()
    jcfg = dataclasses.replace(jax_tiny(), dit=dataclasses.replace(
        jax_tiny().dit, **{f.name: getattr(cfg.dit, f.name)
                           for f in dataclasses.fields(cfg.dit)}))
    conv = [from_jax_params(jax.tree_util.tree_map(np.asarray, p),
                            device="cpu") for p in _jax_tiny_params(jcfg)]
    return (pipe_cls or FlexAMGenerationPipeline)(FlexAMModels(
        cfg=cfg, dit_params=conv[0], vae_params=conv[1], t5_params=conv[2]),
        device="cpu")


# ---------------------------------------------------------------------------
# `tests/test_serve.py`'s cases
# ---------------------------------------------------------------------------

def test_array_codec_roundtrip():
    a = np.random.RandomState(0).randn(2, 3, 4).astype(np.float32)
    out = _decode_array(_encode_array(a))
    np.testing.assert_array_equal(out, a)


def test_handler_runs_pipeline():
    class FakePipe:
        def generate(self, prompt, **kw):
            assert prompt == "hi"
            assert kw["video"].shape == (1, 3, 2, 8, 8)
            assert kw["num_inference_steps"] == 2
            return np.zeros((1, 3, 2, 8, 8), np.float32)

    srv = GenerationServer(FakePipe())
    out = srv.handle({"prompt": "hi",
                      "video": _encode_array(np.zeros((1, 3, 2, 8, 8))),
                      "num_inference_steps": 2})
    assert _decode_array(out["video"]).shape == (1, 3, 2, 8, 8)
    assert out["fps"] == 16


def test_serve_long_video_two_windows():
    """13 frames as two 9-frame windows with a 4-frame overlap, through the
    real tiny pipeline."""
    srv = GenerationServer(_port_pipe())
    rng = np.random.RandomState(0)
    t, h, w = 13, 32, 32
    out = srv.handle({
        "prompt": "long",
        "control_video": _encode_array(rng.rand(1, 3, t, h, w)),
        "video_length": t, "partial_video_length": 9,
        "overlap_video_length": 4, "num_inference_steps": 1,
        "density": 0.1,
    })
    video = _decode_array(out["video"])
    assert video.shape == (1, 3, t, h, w) and video.dtype == np.uint8


def _pose_rows(n=9, seed=0):
    from tests.test_camera_adapter_path import _pose_rows as rows
    return rows(n, seed)


def _camera_cfg():
    import dataclasses

    from flexam_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config()
    return dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, add_control_adapter=True, in_dim_control_adapter=24,
        downscale_factor_control_adapter=16))


def test_serve_camera_conditions():
    """A camera_conditions trajectory drives generation through the JSON
    API; a model without the adapter ends the request with JAX's
    refusal."""
    traj = json.dumps([[float(x) for x in r] for r in _pose_rows(9)])
    payload = {"prompt": "cam", "camera_conditions": traj,
               "video_length": 9, "height": 32, "width": 32,
               "num_inference_steps": 1, "guidance_scale": 1.0}
    out = GenerationServer(_port_pipe(_camera_cfg())).handle(dict(payload))
    assert _decode_array(out["video"]).shape == (1, 3, 9, 32, 32)
    with pytest.raises(ValueError, match="Control-Camera"):
        GenerationServer(_port_pipe()).handle(dict(payload))


def test_serve_riflex_and_scheduler_forwarding():
    pipe = _port_pipe()
    srv = GenerationServer(pipe)
    rng = np.random.RandomState(1)
    t, h, w = 9, 32, 32
    base_tables = pipe.rope_tables.clone()
    out = srv.handle({
        "prompt": "riflex",
        "video": _encode_array(rng.rand(1, 3, t, h, w)),
        "mask_video": _encode_array(np.ones((1, 1, t, h, w))),
        "num_inference_steps": 1, "scheduler_type": "flow_unipc",
        "cfg_skip_ratio": 0.5, "riflex_k": 2, "density": 0.1,
    })
    assert _decode_array(out["video"]).shape == (1, 3, t, h, w)
    # RIFLEx is off again after the request
    assert torch.equal(pipe.rope_tables, base_tables)


def _tracks_payload(seed=2, t=9, n=30, h=32, w=32):
    rng = np.random.RandomState(seed)
    tracks = np.stack([rng.uniform(0, w, (t, n)), rng.uniform(0, h, (t, n)),
                       rng.uniform(0.5, 3, (t, n))], -1).astype(np.float32)
    return {"prompt": "tracks", "tracks": _encode_array(tracks),
            "visibility": _encode_array(np.ones((t, n), bool)),
            "first_frame": _encode_array(rng.rand(1, 3, 1, h, w)),
            "height": h, "width": w, "num_inference_steps": 1,
            "density": 0.1}


def test_serve_tracks_path():
    """Tracks and a first frame cross the wire instead of rasterized
    control videos."""
    out = GenerationServer(_port_pipe()).handle(_tracks_payload())
    assert _decode_array(out["video"]).shape == (1, 3, 9, 32, 32)


def test_serve_ui_form_request():
    """The web UI's form payload: the reply's "mp4" holds the file
    `save_video` wrote (an mp4, or without imageio its .npz frame dump,
    which decodes back to the frames)."""
    srv = GenerationServer(_port_pipe())
    out = srv.handle_ui_payload({
        "prompt": "ui", "num_inference_steps": 1, "guidance_scale": 6.0,
        "video_length": 9, "height": 32, "width": 32, "density": 0.1})
    assert "mp4" in out and len(out["mp4"]) > 100
    raw = base64.b64decode(out["mp4"])
    assert len(raw) >= 12
    if raw[:2] == b"PK":                          # the .npz frame dump
        import io
        frames = np.load(io.BytesIO(raw))["video"]
        assert frames.shape == (9, 32, 32, 3)


def test_serve_ui_html_served():
    assert "/submit" in GenerationServer.UI_HTML
    assert "/status/" in GenerationServer.UI_HTML
    assert "Prompt" in GenerationServer.UI_HTML
    assert GenerationServer.UI_HTML == jserve.GenerationServer.UI_HTML


def test_serve_server_side_tracking():
    """`track_method` with a posted video: the server tracks the clip (the
    flow tracker, no checkpoint) and returns the generated video; without
    a video it refuses, as JAX's server does."""
    srv = GenerationServer(_port_pipe())
    video = np.random.RandomState(3).rand(1, 3, 9, 32, 32)
    out = srv.handle({"prompt": "server-side tracking",
                      "video": _encode_array(video), "track_method": "flow",
                      "track_density": 8, "num_inference_steps": 1,
                      "density": 0.1})
    assert _decode_array(out["video"]).shape == (1, 3, 9, 32, 32)
    with pytest.raises(ValueError, match="posted video"):
        srv.handle({"prompt": "no clip", "track_method": "flow",
                    "num_inference_steps": 1})


# ---------------------------------------------------------------------------
# Parity with JAX's GenerationServer
# ---------------------------------------------------------------------------

def test_wire_format_crosses_packages():
    """Each package's `_decode_array` reads the other's `_encode_array`,
    bit for bit, for every dtype the protocol carries."""
    rng = np.random.RandomState(4)
    for a in (rng.rand(1, 3, 2, 4, 4).astype(np.float32), rng.rand(3, 5),
              rng.randint(0, 256, (2, 3, 4), dtype=np.uint8),
              rng.rand(4, 6) > 0.5):
        for enc, dec in ((jserve._encode_array, tserve._decode_array),
                         (tserve._encode_array, jserve._decode_array)):
            out = dec(enc(a))
            assert out.dtype == a.dtype
            np.testing.assert_array_equal(out, a)
        assert tserve._encode_array(a) == jserve._encode_array(a)


class _Recorder:
    """A pipeline that records what each call receives and returns zeros
    of the asked geometry."""

    class _Vae:
        temporal_compression_ratio = 4

    class _Cfg:
        pass

    def __init__(self):
        self.calls = []
        self.cfg = self._Cfg()
        self.cfg.vae = self._Vae()

    def _shape(self, kw):
        for k in ("video", "control_video"):
            if kw.get(k) is not None:
                return kw[k].shape[2:]
        return (9, 8, 8)

    def generate(self, video=None, prompt=None, **kw):
        self.calls.append(("generate", dict(kw, video=video, prompt=prompt)))
        t, h, w = self._shape(dict(kw, video=video))
        return np.zeros((1, 3, t, h, w), np.float32)

    def prepare_conditioning_from_tracks(self, tracks, vis, h, w, **kw):
        self.calls.append(("prepare_from_tracks",
                           dict(kw, tracks=tracks, vis=vis, h=h, w=w)))
        return {"frames": tracks.shape[0], "h": h, "w": w}

    def encode_prompt(self, prompt, negative_prompt=None, do_cfg=True):
        self.calls.append(("encode_prompt", dict(prompt=prompt,
                                                 neg=negative_prompt,
                                                 do_cfg=do_cfg)))
        return "context"

    def generate_from_cond(self, cond, context, **kw):
        self.calls.append(("generate_from_cond",
                           dict(kw, cond=cond, context=context)))
        return np.zeros((1, 3, cond["frames"], cond["h"], cond["w"]),
                        np.float32)

    def enable_riflex(self, k, L_test):
        self.calls.append(("enable_riflex", dict(k=k, L_test=L_test)))

    def disable_riflex(self):
        self.calls.append(("disable_riflex", {}))


def _same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif callable(a):
        assert callable(b), where
    else:
        assert a == b, (where, a, b)


def _payloads():
    rng = np.random.RandomState(5)
    t, h, w = 9, 8, 8
    long_t = 13
    return {
        "control_video": {
            "prompt": "ctrl", "video": _encode_array(rng.rand(1, 3, t, h, w)),
            "mask_video": _encode_array(np.ones((1, 1, t, h, w))),
            "control_video": _encode_array(rng.rand(1, 3, t, h, w)),
            "cos_videos": [_encode_array(rng.rand(1, 3, t, h, w))],
            "num_inference_steps": 2, "guidance_scale": 6.0, "seed": 3,
            "density": 0.1, "negative_prompt": "neg"},
        "tracks": dict(_tracks_payload(6, t=t, h=h, w=w),
                       guidance_scale=5.0, negative_prompt="neg",
                       point_wise=3, generate_type="full_edit", seed=4),
        "long_video": {
            "prompt": "long",
            "control_video": _encode_array(rng.rand(1, 3, long_t, h, w)),
            "depth_video": _encode_array(rng.rand(1, 3, long_t, h, w)),
            "video_length": long_t, "partial_video_length": 9,
            "overlap_video_length": 4, "num_inference_steps": 1,
            "teacache_thresh": 0.1, "teacache_skip_start": 2},
        "riflex_scheduler": {
            "prompt": "riflex", "video": _encode_array(rng.rand(1, 3, t, h, w)),
            "num_inference_steps": 1, "scheduler_type": "flow_unipc",
            "cfg_skip_ratio": 0.5, "riflex_k": 2, "riflex_L_test": 5,
            "density": 0.1},
    }


@pytest.mark.parametrize("name", ["control_video", "tracks", "long_video",
                                  "riflex_scheduler"])
def test_payload_reaches_pipeline_as_in_jax(name):
    """The same payload reaches each package's pipeline through the same
    calls with equal arguments (arrays bit for bit), and both replies
    decode to the same video."""
    payload = _payloads()[name]
    jp, tp = _Recorder(), _Recorder()
    jout = jserve.GenerationServer(jp).handle(json.loads(json.dumps(payload)))
    tout = GenerationServer(tp).handle(json.loads(json.dumps(payload)))
    assert [c for c, _ in tp.calls] == [c for c, _ in jp.calls]
    for (c, jkw), (_, tkw) in zip(jp.calls, tp.calls):
        _same(jkw, tkw, c)
    np.testing.assert_array_equal(_decode_array(tout["video"]),
                                  jserve._decode_array(jout["video"]))
    assert tout["fps"] == jout["fps"]


def _jax_noise_pipe_cls():
    """The port's pipeline drawing JAX's initial noise (PRNGKey(seed)) where
    the caller passes no latents: a thin wrapper over `denoise`."""
    from flexam_tpu_torch.pipeline import FlexAMGenerationPipeline

    class JaxNoise(FlexAMGenerationPipeline):
        def denoise(self, cond, context, *a, seed=1245644, latents=None,
                    **kw):
            if latents is None:
                latents = np.asarray(jax.random.normal(
                    jax.random.PRNGKey(seed), (1,) + tuple(
                        cond["latent_shape"]), jnp.float32))
            return super().denoise(cond, context, *a, seed=seed,
                                   latents=latents, **kw)
    return JaxNoise


def _jax_pipe():
    from flexam_tpu.config import tiny_test_config as jax_tiny
    from flexam_tpu.pipeline import FlexAMGenerationPipeline, FlexAMModels
    cfg = jax_tiny()
    p = _jax_tiny_params(cfg)
    return FlexAMGenerationPipeline(FlexAMModels(
        cfg=cfg, dit_params=p[0], vae_params=p[1], t5_params=p[2]),
        compute_dtype=jnp.float32)


@pytest.mark.parametrize("name", ["control_video", "tracks"])
def test_decoded_video_matches_jax_server(name):
    """Both servers on the tiny pipelines (JAX's weights, JAX's noise): the
    uint8 videos they return agree within one level."""
    rng = np.random.RandomState(7)
    t, h, w = 9, 32, 32
    payload = (_tracks_payload(8) if name == "tracks" else {
        "prompt": "ctrl", "video": _encode_array(rng.rand(1, 3, t, h, w)),
        "mask_video": _encode_array(np.ones((1, 1, t, h, w))),
        "control_video": _encode_array(rng.rand(1, 3, t, h, w)),
        "num_inference_steps": 2, "guidance_scale": 6.0, "seed": 5,
        "density": 0.1})
    jout = jserve.GenerationServer(_jax_pipe()).handle(dict(payload))
    tout = GenerationServer(_port_pipe(
        pipe_cls=_jax_noise_pipe_cls())).handle(dict(payload))
    jv = jserve._decode_array(jout["video"]).astype(np.int16)
    tv = _decode_array(tout["video"]).astype(np.int16)
    assert tv.shape == jv.shape == (1, 3, t, h, w)
    assert np.abs(tv - jv).max() <= 1
