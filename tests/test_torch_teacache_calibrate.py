"""The port's TeaCache calibration (`flexam_tpu_torch/tools/
teacache_calibrate.py`) against the JAX package's, on the CPU at the JAX
test's config (`tests/test_teacache_trained.py`), fp32.

`collect_signals` on one trajectory and `collect_signals_trajectory` from
JAX's initial noise (crossed as `latents=`) give JAX's rel-L1 pairs at
rtol 2e-4; `fit_coefficients` is JAX's fit on the same pairs. Then the
property JAX's test holds, on the port alone: `train_to_smooth` lowers
the loss, and with the coefficients calibrated for the trained weights
`dit_forward_teacache` skips steps while the result stays within JAX's
bound (relative error 0.5) of the uncached denoise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexam_tpu.config import DiTConfig as JDiTConfig
from flexam_tpu.tools import teacache_calibrate as J
from flexam_tpu_torch.config import DiTConfig
from flexam_tpu_torch.io.convert import from_jax_params, stack_blocks
from flexam_tpu_torch.models.dit import (dit_forward, dit_forward_teacache,
                                         init_dit_params, init_teacache_state)
from flexam_tpu_torch.sampling import (build_schedule, sampler_init_state,
                                       sampler_step, schedule_arrays)
from flexam_tpu_torch.tools import teacache_calibrate as T

KW = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2, in_dim=4,
          out_dim=4, text_dim=16, text_len=4, freq_dim=16,
          add_ref_conv=False, add_cnn_block=False)
CFG, JCFG = DiTConfig(**KW), JDiTConfig(**KW)
SHAPE = (1, 4, 2, 4, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    port = init_dit_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    np_tree = jax.tree_util.tree_map(lambda t: t.numpy().copy(),
                                     stack_blocks(port),
                                     is_leaf=torch.is_tensor)
    ctx = np.random.RandomState(1).randn(1, 4, 16).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, np_tree),
            from_jax_params(np_tree, "cpu"), ctx)


def test_collect_signals_matches_jax(trees):
    jparams, port, ctx = trees
    rs = np.random.RandomState(2)
    xs = rs.randn(5, *SHAPE).astype(np.float32)
    ts = np.linspace(990, 100, 5).astype(np.float32)[:, None]
    jr, jo = J.collect_signals(jparams, JCFG, xs, ts, jnp.asarray(ctx))
    tr, to = T.collect_signals(port, CFG, xs, ts, torch.from_numpy(ctx))
    assert tr.shape == (4,)
    np.testing.assert_allclose(tr, jr, rtol=2e-4)
    np.testing.assert_allclose(to, jo, rtol=2e-4)


def test_trajectory_and_fit_match_jax(trees):
    jparams, port, ctx = trees
    jr, jo = J.collect_signals_trajectory(jparams, JCFG, SHAPE,
                                          jnp.asarray(ctx), num_steps=6)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), SHAPE,
                                         jnp.float32))
    tr, to = T.collect_signals_trajectory(
        port, CFG, SHAPE, torch.from_numpy(ctx), num_steps=6,
        latents=torch.from_numpy(noise))
    np.testing.assert_allclose(tr, jr, rtol=2e-4)
    np.testing.assert_allclose(to, jo, rtol=2e-4)
    for n in (len(jr), 3):            # the degree-4 fit and the short one
        np.testing.assert_allclose(
            T.fit_coefficients(tr[:n], to[:n]),
            J.fit_coefficients(np.asarray(jr[:n]), np.asarray(jo[:n])),
            rtol=1e-3, atol=1e-6 * np.abs(J.fit_coefficients(
                np.asarray(jr[:n]), np.asarray(jo[:n]))).max())


def test_trained_weights_make_teacache_skip():
    out = T.train_to_smooth(CFG, num_steps=30, latent_shape=(2, 4, 4),
                            lr=3e-4, device="cpu")
    losses = out["losses"]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    params, ctx = out["params"], out["context"]
    rels, outs = T.collect_signals_trajectory(params, CFG, SHAPE, ctx,
                                              num_steps=10)
    assert rels.shape == (9,) and np.all(np.isfinite(rels))
    coeffs = T.fit_coefficients(rels, outs)
    assert len(coeffs) == 5
    n = 10
    tables = build_schedule("euler", n, shift=5.0)
    sched = schedule_arrays(tables)
    est = np.polyval(np.asarray(coeffs), rels)
    thresh = float(np.median(np.abs(est)) * 2.0 + 1e-6)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))

    @torch.no_grad()
    def run(use_tea):
        state = sampler_init_state(x, tables.order)
        tea = init_teacache_state(1, 8, CFG.dim, torch.float32, "cpu")
        for i in range(n):
            t = torch.full((1,), float(tables.timesteps[i]))
            if use_tea:
                v, tea = dit_forward_teacache(
                    params, CFG, state[0], t, ctx, tea, i,
                    coefficients=coeffs, rel_l1_thresh=thresh,
                    num_skip_start_steps=2)
            else:
                v = dit_forward(params, CFG, state[0], t, ctx)
            state, _ = sampler_step(sched, tables.convert, state, v, i)
        return state[0].numpy(), (float(tea["computed"]) if use_tea else n)

    ref, _ = run(False)
    got, computed = run(True)
    assert n - computed >= 1, "calibrated TeaCache never skipped"
    assert computed >= 2
    rel_err = np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-9)
    assert rel_err < 0.5, rel_err
