"""The port's training steps (`flexam_tpu_torch/train.py`) against the JAX
package's `flexam_tpu/train.py`, on the CPU at `tiny_test_config()` in fp32.

One tree crosses both ways: the port's init, stacked into JAX's layout
(`io.convert.stack_blocks`) for JAX and kept as it is for the port. JAX's
noise (sigma and eps from the key split its step makes) crosses as
explicit tensors. Held at rtol 2e-4: the loss; every gradient leaf
against `jax.grad`'s with an atol of 1e-5 of the leaf's largest value (the
two sum the same products in another order, so an element near zero moves
by ~1e-6 of the leaf's scale); after one AdamW step, the first moment
against optax's (the same bound) and every leaf with an atol of lr / 100
where JAX's gradient is at least 1e-4 of the leaf's largest: the first
step moves an element by lr g / (|g| + eps), about lr sign(g), so where the
gradient lies within the summation noise of zero its sign is not
determined and the element may move up to 2 lr otherwise. The loss, the
gradients and the step are held so for batches of 1 (an image), 2 and 3
latent frames. AdamW's decay against optax's at a decay of 10, where it
outweighs that bound (at 1e-2 it does not). Also: five steps lower the
loss, the LoRA step (against JAX, base bit-identical, loss falling), the
LoRA export / merge in both layouts, `param_shardings` (the moments
shaped like the leaves given; the multi-rank steps are
`tests/test_torch_parallel.py`'s), the kernels' refusal of autograd (`ops.build.refuse_autograd`),
FLEXAM_FUSED as JAX reads it, and FLEXAM_ATTENTION=xla as the exact
branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexam_tpu import train as jtrain
from flexam_tpu.config import tiny_test_config as jtiny
from flexam_tpu.utils import lora as jlora
from flexam_tpu_torch import train as T
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import (from_jax_params, map_leaves,
                                         stack_blocks, tree_leaves)
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.ops import build
from flexam_tpu_torch.utils import lora as tlora

RTOL = 2e-4
ATOL = 1e-5      # of each leaf's largest value
CFG = tiny_test_config()
JCFG = jtiny()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread beside the other test
    workers (see tests/test_torch_moge.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, lt=2):
    c = CFG.dit.out_dim
    return {
        "latents": rng.randn(2, c, lt, 4, 4).astype(np.float32),
        "context": rng.randn(2, CFG.dit.text_len,
                             CFG.dit.text_dim).astype(np.float32) * 0.1,
        "density": np.array([0.1, 0.1], np.float32),
        "y": rng.randn(2, c + 4 + c, lt, 4, 4).astype(np.float32),
        "additional_control": rng.randn(2, 5 * c, lt, 4, 4
                                        ).astype(np.float32),
        "full_ref": rng.randn(2, c, 4, 4).astype(np.float32),
    }


def _np_tree(port):
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().copy(), stack_blocks(port),
        is_leaf=torch.is_tensor)


def _jax_tree(port):
    return jax.tree_util.tree_map(jnp.asarray, _np_tree(port))


def _port_tree(np_tree):
    return from_jax_params(np_tree, "cpu")


def _jax_noise(key, shape):
    """sigma, eps as JAX's `train_step` draws them from `key`."""
    k_sig, k_eps = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), jnp.float32, 1e-4, 1.0)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    sigma, eps = np.array(sigma), np.array(eps)
    return sigma, eps, torch.from_numpy(sigma), torch.from_numpy(eps)


def _leaves(tree):
    return [t.detach().numpy() for t in tree_leaves(stack_blocks(tree))]


def _leaves_close(got_tree, want_np_tree, atol_frac=0.0):
    got = _leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_np_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=RTOL,
            atol=atol_frac * max(float(np.abs(w).max()), 1e-30))


def _step_close(opt, got_tree, jnew, jstate, lr):
    """One AdamW step against optax's: the first moments, and each leaf
    where the sign of JAX's gradient is determined (see the docstring)."""
    mu = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jstate[0].mu))
    exp_avg = _leaves(map_leaves(
        got_tree, lambda k, t, b: opt.opt.state[t]["exp_avg"]))
    assert len(exp_avg) == len(mu)
    for a, m in zip(exp_avg, mu):
        np.testing.assert_allclose(
            a, m, rtol=RTOL, atol=ATOL * max(float(np.abs(m).max()), 1e-30))
    got = _leaves(got_tree)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            jnew))
    assert len(got) == len(want) == len(mu)
    for g, w, m in zip(got, want, mu):
        sure = np.abs(m) >= 1e-4 * np.abs(m).max()
        np.testing.assert_allclose(g[sure], w[sure], rtol=RTOL,
                                   atol=lr / 100)
        assert (np.abs(g - w)[~sure] <= 2 * lr + lr / 100).all()


@pytest.fixture(scope="module")
def setup():
    port = init_dit_params(CFG.dit, seed=0, dtype=torch.float32,
                           device="cpu")
    np_tree = _np_tree(port)
    batch = _batch(np.random.RandomState(0))
    key = jax.random.PRNGKey(1)
    noise = _jax_noise(key, batch["latents"].shape)
    return np_tree, batch, key, noise


def _loss_and_grads_match(np_tree, batch, noise):
    """The port's loss and every gradient leaf against `jax.grad`'s."""
    js, je, ts, te = noise
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)

    def loss_fn(p):
        return jtrain.flow_match_loss(p, JCFG.dit, batch, jnp.asarray(js),
                                      jnp.asarray(je))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    port = _port_tree(np_tree)
    T.trainable(port)
    loss = T.flow_match_loss(port, CFG.dit, T.batch_to(batch, "cpu"), ts, te)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    grads = jax.tree_util.tree_map(lambda t: t.grad, port,
                                   is_leaf=torch.is_tensor)
    _leaves_close(grads, jax.tree_util.tree_map(np.asarray, jgrads), ATOL)


def test_flow_match_loss_and_gradients_match_jax(setup):
    np_tree, batch, _, noise = setup
    _loss_and_grads_match(np_tree, batch, noise)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's `train_step` with the optimizer JAX's `make_train_state`
    builds, its learning rate and decay traced so one compilation serves
    every case of a batch shape."""
    def step(p, o, b, k, lr, wd):
        tx, _ = jtrain.make_train_state(p, learning_rate=lr, weight_decay=wd)
        return jtrain.train_step(p, o, tx, JCFG.dit, b, k)

    tx, _ = jtrain.make_train_state({"w": jnp.zeros(1)})
    return tx, jax.jit(step)


def _train_step_matches(np_tree, batch, key, noise, jax_step, lr=1e-3,
                        weight_decay=1e-2):
    """One `train_step` against JAX's: the loss, the first moments and the
    updated leaves (`_step_close`)."""
    tx, step = jax_step
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jnew, jstate, jloss = step(jparams, tx.init(jparams), batch, key,
                               jnp.float32(lr), jnp.float32(weight_decay))
    port = _port_tree(np_tree)
    opt = T.make_train_state(port, learning_rate=lr,
                             weight_decay=weight_decay)
    port, loss = T.train_step(port, opt, CFG.dit, T.batch_to(batch, "cpu"),
                              sigma=noise[2], eps=noise[3])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _step_close(opt, port, jnew, jstate, lr)


def test_train_step_matches_jax(setup, jax_step):
    np_tree, batch, key, noise = setup
    _train_step_matches(np_tree, batch, key, noise, jax_step)


def test_five_steps_lower_the_loss(setup):
    np_tree, batch, _, (_, _, ts, te) = setup
    port = _port_tree(np_tree)
    opt = T.make_train_state(port, learning_rate=1e-3)
    tb = T.batch_to(batch, "cpu")
    losses = []
    for _ in range(5):
        port, loss = T.train_step(port, opt, CFG.dit, tb, sigma=ts, eps=te)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("lt", [1, 3], ids=["image", "video"])
def test_mixed_image_video_batches(setup, jax_step, lt):
    """The joint dataset's batch types held to JAX as the two-frame batch
    is: an image is one latent frame (the causal DiT on a RoPE grid of one
    frame), a video three. The loss, every gradient against `jax.grad`'s,
    and one `train_step` against JAX's, with JAX's noise for the batch."""
    np_tree = setup[0]
    batch = _batch(np.random.RandomState(lt), lt)
    key = jax.random.PRNGKey(10 + lt)
    noise = _jax_noise(key, batch["latents"].shape)
    _loss_and_grads_match(np_tree, batch, noise)
    _train_step_matches(np_tree, batch, key, noise, jax_step)


def _lora(np_tree, seed, rank=2):
    """JAX's factors (normal / rank A, zero B) for the tree, and the port's
    copy of them."""
    jl = jlora.init_lora_params(jax.random.PRNGKey(seed),
                                jax.tree_util.tree_map(jnp.asarray, np_tree),
                                rank=rank)
    blocks = jax.tree_util.tree_map(np.asarray, jl["blocks"])
    port = {"blocks": from_jax_params({"blocks": blocks}, "cpu")["blocks"],
            "rank": jl["rank"], "alpha": jl["alpha"]}
    return jl, port


@pytest.fixture(scope="module")
def jax_lora_step():
    """JAX's `lora_train_step` under `optax.adamw(1e-2)`, the decay traced
    (optax's default 1e-4 unless a case passes its own)."""
    return jax.jit(lambda bp, lp, os, b, k, wd: jtrain.lora_train_step(
        bp, lp, os, optax.adamw(1e-2, weight_decay=wd), JCFG.dit, b, k))


def _lora_step(np_tree, batch, key, noise, jax_lora_step,
               weight_decay=T.OPTAX_ADAMW_DECAY):
    """One `lora_train_step` on both sides from the same factors, held to
    JAX's (loss, first moments, factors): (port's base, JAX's factors
    before the step, the port's after, the optimizer, JAX's after, the
    port's loss)."""
    jl, tl = _lora(np_tree, 8)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jnew, jstate, jloss = jax_lora_step(
        jparams, jl, optax.adamw(1e-2).init(jl["blocks"]), batch, key,
        jnp.float32(weight_decay))
    base = _port_tree(np_tree)
    opt = T.adamw(T.trainable(tl["blocks"]), 1e-2, weight_decay)
    tl, loss = T.lora_train_step(base, tl, opt, CFG.dit,
                                 T.batch_to(batch, "cpu"), sigma=noise[2],
                                 eps=noise[3])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _step_close(opt, {"blocks": tl["blocks"]}, {"blocks": jnew["blocks"]},
                (jstate[0]._replace(mu={"blocks": jstate[0].mu}),), 1e-2)
    return base, jl, tl, opt, jnew, float(loss)


def test_lora_train_step_matches_jax_and_freezes_base(setup, jax_lora_step):
    np_tree, batch, key, noise = setup
    before = [t.clone() for t in tree_leaves(_port_tree(np_tree))]
    base, _, tl, opt, _, loss = _lora_step(np_tree, batch, key, noise,
                                           jax_lora_step)
    tb = T.batch_to(batch, "cpu")
    losses = [loss]
    for _ in range(5):
        tl, loss = T.lora_train_step(base, tl, opt, CFG.dit, tb,
                                     sigma=noise[2], eps=noise[3])
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    for a, b in zip(before, tree_leaves(base)):
        assert torch.equal(a, b) and not b.requires_grad


WD = 10.0   # lr wd |w| outweighs a step's bound (lr / 100 + rtol |w|)


@pytest.mark.parametrize("which", ["train_step", "lora_train_step"])
def test_adamw_weight_decay_matches_optax(setup, jax_step, jax_lora_step,
                                          which):
    """AdamW's decoupled decay as optax applies it, at a decay large enough
    to show in one step: a port that dropped it, or added it to the
    gradient as L2, fails. The LoRA factors A have a zero gradient (B
    starts at zero), where Adam's step is 0: they must come out as
    A (1 - lr wd), here and in JAX, to rtol 1e-6."""
    np_tree, batch, key, noise = setup
    if which == "train_step":
        _train_step_matches(np_tree, batch, key, noise, jax_step,
                            weight_decay=WD)
        return
    jl, tl, _, jnew, _ = _lora_step(np_tree, batch, key, noise,
                                    jax_lora_step, WD)[1:]
    keep = 1 - 1e-2 * WD
    n_a = 0
    for lb, lb0 in zip(tl["blocks"], _lora(np_tree, 8)[1]["blocks"]):
        for mod, projs in lb.items():
            for proj, ab in projs.items():
                n_a += 1
                np.testing.assert_allclose(
                    ab["a"].detach().numpy(),
                    lb0[mod][proj]["a"].numpy() * keep, rtol=1e-6)
    for path, a in jax.tree_util.tree_leaves_with_path(jnew["blocks"]):
        if path[-1].key == "a":
            a0 = _get(jl["blocks"], path)
            np.testing.assert_allclose(np.asarray(a), np.asarray(a0) * keep,
                                       rtol=1e-6)
    assert n_a > 0


def _get(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


@pytest.mark.parametrize("layout", ["kohya", "diffusers"])
def test_lora_export_merge_equivalence(setup, layout):
    """apply_lora(base, lora) == merge_lora(base, lora_to_state_dict(lora))
    within JAX's 1e-5, for trained-looking (non-zero B) factors."""
    np_tree, _, _, _ = setup
    _, tl = _lora(np_tree, 7)
    for lb in tl["blocks"]:
        for projs in lb.values():
            for ab in projs.values():
                ab["b"] += 0.1
    base = _port_tree(np_tree)
    direct = tlora.apply_lora(base, tl)
    merged = tlora.merge_lora(base, tlora.lora_to_state_dict(tl, layout))
    for i, lb in enumerate(tl["blocks"]):
        for mod, projs in lb.items():
            for proj in projs:
                np.testing.assert_allclose(
                    merged["blocks"][i][mod][proj]["weight"].numpy(),
                    direct["blocks"][i][mod][proj]["weight"].numpy(),
                    rtol=1e-5, atol=1e-6, err_msg=f"{layout} {mod}.{proj}")


def test_make_train_state_param_shardings(setup):
    """With `param_shardings` the optimizer keeps each leaf's sharding
    (for the steps' gradient sums) and AdamW's moments take the shape of
    the leaves it was given; off a mesh a step with it equals the step
    without it (every leaf replicated, nothing to sum)."""
    from flexam_tpu_torch.parallel import replicated_shardings
    np_tree, batch, key, noise = setup
    port = _port_tree(np_tree)
    specs = replicated_shardings(None, port)
    opt = T.make_train_state(port, param_shardings=specs)
    assert [t for t, _ in opt.shardings] == opt.params
    assert all(s.axis is None for _, s in opt.shardings)
    plain = _port_tree(np_tree)
    popt = T.make_train_state(plain)
    tb = T.batch_to(batch, "cpu")
    _, loss = T.train_step(port, opt, CFG.dit, tb, sigma=noise[2],
                           eps=noise[3])
    _, ploss = T.train_step(plain, popt, CFG.dit, tb, sigma=noise[2],
                            eps=noise[3])
    assert float(loss) == float(ploss)
    for a, b in zip(tree_leaves(port), tree_leaves(plain)):
        assert torch.equal(a, b)
        assert opt.opt.state[a]["exp_avg"].shape == a.shape


def test_refuse_autograd():
    """The kernels' shared refusal: a tensor that requires grad under grad
    mode raises, naming the kernel and the way to train; under no_grad and
    inference_mode, and for tensors that need no grad, nothing happens."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match="B_test.*FLEXAM_FUSED=0 FLEXAM_ATTENTION=xla"):
        build.refuse_autograd("B_test", torch.zeros(3), None, x)
    build.refuse_autograd("B_test", torch.zeros(3), None)
    with torch.no_grad():
        build.refuse_autograd("B_test", x)
    with torch.inference_mode():
        build.refuse_autograd("B_test", torch.zeros(3, requires_grad=True))


def test_flexam_fused_as_jax_reads_it(monkeypatch):
    from flexam_tpu_torch.models.dit import use_kernels
    monkeypatch.delenv("FLEXAM_FUSED", raising=False)
    assert use_kernels(128) and not use_kernels(24)
    for value, on in (("0", False), ("false", False), ("1", True),
                      ("interpret", True)):
        monkeypatch.setenv("FLEXAM_FUSED", value)
        assert use_kernels(128) is on


def test_xla_backend_is_the_exact_branch(monkeypatch):
    """FLEXAM_ATTENTION=xla / torch_sdpa take `exact_attention` (JAX's
    `xla_attention`), counted, on every head dim."""
    from flexam_tpu_torch.core import attention as A
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 6, 2, 128).astype(np.float32))
               for _ in range(3))
    for env in ("xla", "torch_sdpa"):
        monkeypatch.setenv("FLEXAM_ATTENTION", env)
        A._default_backend.cache_clear()
        before = A.exact_calls["exact_attention"]
        out = A.attention(q, k, v)
        assert A.exact_calls["exact_attention"] == before + 1
        torch.testing.assert_close(out, A.attention_plain(q, k, v))
    A._default_backend.cache_clear()
