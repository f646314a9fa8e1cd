"""The port's hashed-id refusal against the JAX pipeline's, on the CPU.

Mirrors `tests/test_pipeline.py::test_hashed_ids_refused_with_checkpoint_t5`
case for case: with T5 weights from a checkpoint and no tokenizer,
`tokenize` refuses (RuntimeError naming the tokenizer) unless
FLEXAM_ALLOW_HASHED_IDS=1; the default provenance keeps the hashed ids.
Each case runs both pipelines and holds the port's ids to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flexam_tpu import pipeline as jpipe
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.config import tiny_test_config

PROMPTS = ["a prompt", "x" * 40]


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline), both without a tokenizer. tokenize()
    reads no weights, so each side gets an empty parameter bundle with a
    patch-embedding weight only where its constructor reads one."""
    jp = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=jax_tiny(), dit_params={}, vae_params={}),
        compute_dtype=jnp.float32)
    import torch
    dit = {"patch_embedding": {"weight": torch.zeros(1)}}
    tp = tpipe.FlexAMGenerationPipeline(
        tpipe.FlexAMModels(cfg=tiny_test_config(), dit_params=dit,
                           vae_params={}), device="cpu")
    return jp, tp


def _set_provenance(pipes, monkeypatch, from_checkpoint):
    for p in pipes:
        monkeypatch.setattr(p.models, "t5_from_checkpoint", from_checkpoint)


def test_models_take_provenance_field():
    cfg = tiny_test_config()
    assert not tpipe.FlexAMModels(cfg=cfg, dit_params={},
                                  vae_params={}).t5_from_checkpoint
    assert tpipe.FlexAMModels(cfg=cfg, dit_params={}, vae_params={},
                              t5_from_checkpoint=True).t5_from_checkpoint


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_hashed_ids_refused_with_checkpoint_t5(pipes, monkeypatch, side):
    monkeypatch.delenv("FLEXAM_ALLOW_HASHED_IDS", raising=False)
    _set_provenance(pipes, monkeypatch, True)
    assert pipes[side].tokenizer is None
    with pytest.raises(RuntimeError, match="tokenizer"):
        pipes[side].tokenize(PROMPTS)


@pytest.mark.parametrize("from_checkpoint,env", [(True, "1"), (False, None)],
                         ids=["override", "default"])
def test_hashed_ids_match_jax(pipes, monkeypatch, from_checkpoint, env):
    """FLEXAM_ALLOW_HASHED_IDS=1 lets checkpoint weights through; the
    random-init default needs no override. Both give JAX's ids."""
    if env is None:
        monkeypatch.delenv("FLEXAM_ALLOW_HASHED_IDS", raising=False)
    else:
        monkeypatch.setenv("FLEXAM_ALLOW_HASHED_IDS", env)
    _set_provenance(pipes, monkeypatch, from_checkpoint)
    jp, tp = pipes
    ids, mask = tp.tokenize(PROMPTS)
    assert ids.shape == (len(PROMPTS), tp.cfg.t5.text_length)
    ref_ids, ref_mask = jp.tokenize(PROMPTS)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def test_override_and_default_give_the_same_ids(pipes, monkeypatch):
    """As the JAX test's last step: the ids under the override equal the
    default provenance's."""
    tp = pipes[1]
    monkeypatch.setenv("FLEXAM_ALLOW_HASHED_IDS", "1")
    monkeypatch.setattr(tp.models, "t5_from_checkpoint", True)
    ids, _ = tp.tokenize(PROMPTS)
    monkeypatch.delenv("FLEXAM_ALLOW_HASHED_IDS")
    monkeypatch.setattr(tp.models, "t5_from_checkpoint", False)
    ids2, _ = tp.tokenize(PROMPTS)
    assert np.array_equal(ids, ids2)
