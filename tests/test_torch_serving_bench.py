"""`flexam_tpu_torch/tools/serving_bench.py`, the serving-session benchmark,
through its whole loop on the CPU at tiny size, as
`tests/test_serving_bench.py` drives JAX's: build -> quantize -> N x
(prepare from tracks -> denoise -> decode), one JSON record a run and a
summary of warm medians. `--platform cpu --tiny` throughout (the tiny
config has no kernel on the card). The port's default mode is the resident
bf16 DiT; `bf16-offload` is the 16 GB TPU chip's workaround and raises
naming ROADMAP A15.

Times on the CPU are not the card's: these tests check the records' keys,
shapes and counts, not their values.
"""

import argparse
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from flexam_tpu.tools.serving_bench import synthetic_inputs as jax_inputs
from flexam_tpu_torch.tools import serving_bench

TINY = ["--platform", "cpu", "--tiny", "--steps", "1", "--size", "32", "32",
        "--frames", "9"]
KEYS = ("run", "mode", "prepare_s", "denoise_s", "decode_s", "e2e_s",
        "steps_per_s", "video_shape")


def _run(mode, runs=1, extra=()):
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = serving_bench.main(TINY + ["--mode", mode, "--runs", str(runs),
                                         *extra])
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line]
    assert (lines[:-1], lines[-1]) == (list(got[0]), got[1])
    return lines[:-1], lines[-1]


def _check(recs, summary, mode, runs):
    assert len(recs) == runs
    for i, r in enumerate(recs):
        assert r["run"] == i and r["mode"] == mode
        for k in KEYS:
            assert k in r, k
        assert "probe_rtt_ms" not in r and "restore_dit_s" not in r
        assert r["video_shape"] == [1, 3, 9, 32, 32]
        assert r["e2e_s"] >= r["denoise_s"] > 0
    assert summary["summary"] and summary["mode"] == mode
    assert summary["runs"] == runs
    assert set(summary["warm_medians"]) == {"prepare_s", "denoise_s",
                                            "decode_s", "e2e_s",
                                            "steps_per_s"}
    assert summary["run0_e2e_s"] == recs[0]["e2e_s"]
    assert summary["init_s"] >= 0 and "peak_alloc_gb" not in summary


def test_int8_resident_session():
    recs, summary = _run("int8", runs=2)
    _check(recs, summary, "int8", 2)
    assert summary["warm_medians"]["e2e_s"] == recs[1]["e2e_s"]
    assert summary["dit_dtypes"]["int8"] == 10 * 2     # 10 linears a block
    bf16 = _run("bf16")[1]
    assert summary["dit_bytes"] < bf16["dit_bytes"]


def test_accelerated_int8_sparse_session(monkeypatch):
    """--attention sparse stacks block-sparse video attention on the int8
    mode; the records carry the attention and window fields, and the
    process's FLEXAM_ATTENTION is restored afterwards."""
    monkeypatch.setenv("FLEXAM_ATTENTION", "pallas")
    recs, summary = _run("int8", extra=("--attention", "sparse",
                                        "--sparse-window", "1",
                                        "--cfg-skip", "0.0"))
    _check(recs, summary, "int8", 1)
    assert recs[0]["attention"] == "sparse"
    assert recs[0]["sparse_window"] == 1
    assert summary["attention"] == "sparse" and "cfg_skip" not in summary
    import os
    assert os.environ["FLEXAM_ATTENTION"] == "pallas"


def test_build_models_without_quant_attr():
    """A serve-style caller hands `demo._build_models` a bare Namespace;
    it must not require the CLI-only quant attributes."""
    from flexam_tpu_torch.demo import _build_models

    pipe = _build_models(argparse.Namespace(
        checkpoint_path=None, random_init="tiny", platform="cpu"))
    assert pipe.models.dit_params is not None and pipe.quant is None


def test_fp8_session():
    """--mode fp8 stores the eligible DiT weights as e4m3 (modulation
    tables, norms and biases stay wide) through the pipeline's quant knob,
    and the session runs on the stored tree."""
    recs, summary = _run("fp8", extra=("--cfg-skip", "0.5", "--riflex", "2"))
    _check(recs, summary, "fp8", 1)
    assert summary["dit_dtypes"]["float8_e4m3fn"] > 0
    assert recs[0]["cfg_skip"] == 0.5 and recs[0]["riflex_k"] == 2
    assert recs[0]["frames"] == 9
    from flexam_tpu_torch.config import tiny_test_config
    from flexam_tpu_torch.models.dit import init_dit_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    cfg = tiny_test_config()
    pipe = FlexAMGenerationPipeline(FlexAMModels(
        cfg=cfg, dit_params=init_dit_params(cfg.dit, device="cpu"),
        vae_params=init_vae_params(cfg.vae, device="cpu")),
        device="cpu", quant="fp8")
    blk = pipe.models.dit_params["blocks"][0]
    assert blk["self_attn"]["q"]["weight"].dtype == torch.float8_e4m3fn
    assert blk["modulation"].dtype != torch.float8_e4m3fn
    assert pipe.compute_dtype == torch.bfloat16


def test_bf16_session_is_the_default():
    buf = io.StringIO()
    with redirect_stdout(buf):
        recs, summary = serving_bench.main(TINY + ["--runs", "1"])
    _check(recs, summary, "bf16", 1)
    assert set(summary["dit_dtypes"]) == {"bfloat16", "float32"}


def test_bf16_offload_and_synthetic_inputs():
    """bf16-offload is the 16 GB chip's workaround: it raises, naming A15.
    The synthetic inputs are JAX's, value for value."""
    with pytest.raises(NotImplementedError, match="A15"):
        serving_bench.main(TINY + ["--mode", "bf16-offload"])
    for got, ref in zip(serving_bench.synthetic_inputs(32, 48, 9),
                        jax_inputs(32, 48, 9)):
        np.testing.assert_array_equal(got, ref)
