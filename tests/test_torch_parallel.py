"""The port's multi-GPU package (`flexam_tpu_torch/parallel/`) against the
JAX package's, on the CPU.

JAX runs on the suite's 8-device virtual mesh (dp 2 x sp 2 x tp 2, and the
USP mesh dp 2 x ring 2 x sp 2). The port runs 8 ranks over gloo through
`parallel.launch` (`tests/torch_parallel_ranks.py`): the same numpy
inputs, the same weights (JAX trees carried across by `from_jax_params`,
then `shard_pytree`), each rank on its share, the result gathered. All the
cases run in one spawned group (a module-scoped fixture, each rank on one
thread), so the file costs one start-up of 8 ranks.

Mirrored: every case of `tests/test_parallel.py`, the five mesh cases of
`tests/test_fused_ops.py` and `tests/test_train.py`'s two sharded steps.
Held at rtol 2e-4, atol 1e-5 in fp32 (`TOL`), except the int8 forward,
held as JAX holds its own (a per-token int8 rounding can flip one step
where another order of summation moves its input by an ulp). The sharded
training step is held more tightly than JAX holds its own (a finite loss
and the moments' shapes): to JAX's unsharded step, the loss at rtol 2e-4
and the parameters and first moments as `tests/test_torch_train.py` holds
a step. The port's own cases: the vocabulary-split umT5, TeaCache's
decision across ranks, the layout of all_to_all's output, each new
refusal, and the gradients of ring and USP attention against jax.grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexam_tpu import train as jtrain
from flexam_tpu.config import DiTConfig as JDiTConfig
from flexam_tpu.config import VAEConfig as JVAEConfig
from flexam_tpu.config import tiny_test_config as jtiny
from flexam_tpu.core.attention import xla_attention
from flexam_tpu.core.rope import build_video_rope, make_rope_tables
from flexam_tpu.models import t5 as jt5
from flexam_tpu.models.dit import dit_forward
from flexam_tpu.ops.fused import ln_modulation, rmsnorm_rope
from flexam_tpu.ops.qlinear import convert_dit_to_int8
from flexam_tpu.ops.sparse_attention import (make_sparse_attn_fn,
                                             masked_dense_attention,
                                             video_sparse_policy)
from flexam_tpu.parallel import (activation_sharding, dit_param_shardings,
                                 make_mesh, shard_pytree)
from flexam_tpu.parallel.ring import make_ring_attention
from flexam_tpu.parallel.ulysses import make_ulysses_attention
from flexam_tpu.parallel.usp import make_usp_attention
from flexam_tpu.parallel.vae_parallel import (vae_decode_sharded,
                                               vae_encode_sharded)
from flexam_tpu.utils import lora as jlora
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.io.convert import stack_blocks
from flexam_tpu_torch.models.dit import init_dit_params
from flexam_tpu_torch.models.t5 import init_t5_params
from flexam_tpu_torch.models.vae import init_vae_params
from flexam_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

TOL = dict(rtol=2e-4, atol=1e-5)
CFG = tiny_test_config()
JCFG = jtiny()
FUSED = JDiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                   in_dim=8, out_dim=4, text_dim=32, text_len=6, freq_dim=32,
                   add_ref_conv=False, add_cnn_block=False)
VAE = JVAEConfig(latent_channels=8, c_dim=16, dec_dim=16,
                 dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                 temporal_downsample=(False, True, True))
TEA_T = (900.0, 880.0, 860.0, 200.0, 190.0)
TEA_THRESH = 1.5


def _np_tree(port):
    """A port tree as JAX's (stacked blocks), numpy."""
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().copy(), stack_blocks(port),
        is_leaf=torch.is_tensor)


def _qkv(seed, b, lq, lk, h, d, scale=1.0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32) * scale
    k = rng.randn(b, lk, h, d).astype(np.float32) * scale
    v = rng.randn(b, lk, h, d).astype(np.float32)
    return q, k, v


def _noise(key, shape):
    k_sig, k_eps = jax.random.split(key)
    sigma = jax.random.uniform(k_sig, (shape[0],), jnp.float32, 1e-4, 1.0)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    return np.array(sigma), np.array(eps)


def _train_batch(rng):
    c = CFG.dit.out_dim
    return {
        "latents": rng.randn(2, c, 2, 4, 4).astype(np.float32),
        "context": rng.randn(2, CFG.dit.text_len,
                             CFG.dit.text_dim).astype(np.float32) * 0.1,
        "density": np.array([0.1, 0.1], np.float32),
        "y": rng.randn(2, c + 4 + c, 2, 4, 4).astype(np.float32),
        "additional_control": rng.randn(2, 5 * c, 2, 4, 4
                                        ).astype(np.float32),
        "full_ref": rng.randn(2, c, 4, 4).astype(np.float32),
    }


def _inputs():
    """Every case's numpy inputs and weights."""
    rng = np.random.RandomState(2)
    dit_inputs = {
        "x": rng.randn(2, CFG.dit.in_dim, 2, 4, 4).astype(np.float32),
        "t": np.array([500.0, 500.0], np.float32),
        "ctx": rng.randn(2, CFG.dit.text_len,
                         CFG.dit.text_dim).astype(np.float32) * 0.1}
    rng = np.random.RandomState(0)
    c = CFG.dit.out_dim
    usp_dit = {
        "x": rng.randn(2, c, 2, 4, 4).astype(np.float32),
        "y": rng.randn(2, 2 * c + 4, 2, 4, 4).astype(np.float32),
        "add": rng.randn(2, 5 * c, 2, 4, 4).astype(np.float32),
        "ref": rng.randn(2, c, 4, 4).astype(np.float32),
        "t": np.full((2,), 500.0, np.float32),
        "ctx": rng.randn(2, CFG.dit.text_len,
                         CFG.dit.text_dim).astype(np.float32) * .1,
        "dens": np.full((2,), 0.1, np.float32)}
    pol8 = video_sparse_policy(7, 16, ref_tokens=16, window=1, group=1)
    q8, k8, v8 = _qkv(8, 2, pol8["video_len"], pol8["video_len"], 2, 32, .3)
    rng8 = np.random.RandomState(80)
    pol7 = video_sparse_policy(4, 16, ref_tokens=16, window=2, group=1)

    frng = np.random.RandomState(11)

    def rope(dh, max_seq, grid):
        cos, sin = build_video_rope(jnp.asarray(make_rope_tables(dh, max_seq)),
                                    grid, dh)
        return np.asarray(cos), np.asarray(sin)

    def normal(*shape):
        return frng.randn(*shape).astype(np.float32)

    cos48, sin48 = rope(128, 64, (2, 4, 5))
    cos15, sin15 = rope(128, 16, (1, 2, 4))
    fused = {
        "rmsnorm_rope": {
            "mesh": (normal(2, 48, 384), 1.0 + 0.1 * normal(384), cos48,
                     sin48, 3),
            "indivisible": (normal(1, 15, 256),
                            np.ones(256, np.float32), cos15, sin15, 2)},
        "ln_modulation": {
            "binary": (normal(2, 40, 256), normal(2, 2, 256),
                       normal(2, 2, 256),
                       (frng.rand(2, 40) > 0.5).astype(np.float32)),
            "bcast": (normal(2, 24, 256), normal(2, 1, 256),
                      normal(2, 1, 256), None),
            "ln_indivisible": (normal(1, 15, 256), normal(1, 2, 256),
                               normal(1, 2, 256),
                               (frng.rand(1, 15) > 0.5).astype(np.float32))},
        "dit_tree": _np_tree(init_dit_params(
            ranks.FUSED_CFG, seed=1, dtype=torch.float32, device="cpu")),
        "dit_inputs": {"x": normal(2, 8, 2, 4, 4),
                       "t": np.array([500.0, 500.0], np.float32),
                       "ctx": normal(2, 6, 32),
                       "dens": np.array([0.1, 0.1], np.float32)},
    }
    # the Wan VAE's tree is the same in both packages, leaf for leaf
    vae_tree = jax.tree_util.tree_map(
        lambda t: t.numpy(), init_vae_params(ranks.VAE_CFG, seed=0,
                                             dtype=torch.float32,
                                             device="cpu"),
        is_leaf=torch.is_tensor)
    vae_z = (np.random.RandomState(1).randn(1, 8, 3, 2, 4) * 0.5).astype(
        np.float32)
    vae_x = np.random.RandomState(3).uniform(-1, 1, (1, 3, 5, 16, 64)
                                             ).astype(np.float32)
    prng = np.random.RandomState(7)
    t, h, w = 9, 32, 32
    mask = np.ones((1, 1, t, h, w), np.float32)
    mask[:, :, 0] = 0.0
    pipeline = {"videos": (prng.rand(1, 3, t, h, w).astype(np.float32), mask,
                           prng.rand(1, 3, t, h, w).astype(np.float32)),
                "noise": prng.randn(1, 8, 3, 2, 2).astype(np.float32)}
    dit_tree = _np_tree(init_dit_params(CFG.dit, seed=0, dtype=torch.float32,
                                        device="cpu"))
    batch = _train_batch(np.random.RandomState(1))
    sigma, eps = _noise(jax.random.PRNGKey(2), batch["latents"].shape)
    jl = jlora.init_lora_params(jax.random.PRNGKey(9),
                                jax.tree_util.tree_map(jnp.asarray, dit_tree),
                                rank=2)
    lsigma, leps = _noise(jax.random.PRNGKey(3), batch["latents"].shape)
    t5_tree = _np_tree(init_t5_params(CFG.t5, seed=0, dtype=torch.float32,
                                      device="cpu"))
    trng = np.random.RandomState(5)
    t5_ids = trng.randint(0, CFG.t5.vocab, (2, CFG.t5.text_length))
    t5_mask = np.ones((2, CFG.t5.text_length), np.int32)
    t5_mask[1, 11:] = 0
    return {
        "self_qkv": _qkv(0, 2, 64, 64, 4, 32),
        "cross_qkv": _qkv(1, 2, 64, 16, 4, 32),
        "batch1_qkv": _qkv(9, 1, 64, 64, 4, 32),
        "ring_qkv": _qkv(3, 2, 64, 64, 4, 32),
        "ring_cross_qkv": _qkv(4, 2, 64, 16, 4, 32),
        "sparse_ulysses": {"geometry": (4, 16),
                           "qkv": _qkv(7, 2, pol7["video_len"],
                                       pol7["video_len"], 2, 128, .3)},
        "usp_qkv": _qkv(3, 2, 64, 64, 4, 32),
        "usp_cross_qkv": _qkv(2, 2, 64, 16, 4, 32),
        "usp_sparse": {"policy": pol8, "qkv": (q8, k8, v8),
                       "cross_qkv": (q8, rng8.randn(2, 16, 2, 32).astype(
                           np.float32), rng8.randn(2, 16, 2, 32).astype(
                           np.float32))},
        "usp_mismatch": pol7,
        "cotangents": {name: np.random.RandomState(11 + i).randn(
            2, 64, 4, 32).astype(np.float32) for i, name in enumerate(
                ("ring_qkv", "ring_cross_qkv", "usp_qkv", "usp_ring4_qkv"))},
        "dit_tree": dit_tree,
        "dit_inputs": dit_inputs,
        "usp_dit_inputs": usp_dit,
        "fused": fused,
        "vae_tree": vae_tree,
        "vae_z": vae_z,
        "vae_x": vae_x,
        "pipeline": pipeline,
        "train": {"batch": batch, "sigma": sigma, "eps": eps},
        "lora": {"blocks": jax.tree_util.tree_map(np.asarray, jl["blocks"]),
                 "rank": int(jl["rank"]), "alpha": float(jl["alpha"]),
                 "sigma": lsigma, "eps": leps, "init": jl},
        "t5_tree": t5_tree, "t5_ids": t5_ids, "t5_mask": t5_mask,
        "teacache": {"t": TEA_T, "thresh": TEA_THRESH, "tokens": 8},
    }


@pytest.fixture(scope="module")
def run():
    """(inputs, the ranks' results): every port case in one group of 8."""
    inp = _inputs()
    jl = inp["lora"].pop("init")
    res = launch.run(ranks.run_cases, 8, inp, timeout=300, run_timeout=600)
    inp["lora"]["init"] = jl
    return inp, res


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"dp": 2, "sp": 2, "tp": 2}, devices=jax.devices()[:8])


@pytest.fixture(scope="module")
def usp_mesh():
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "ring", "sp"))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def _jit(fn, *args):
    return np.asarray(jax.jit(fn)(*args))


def _jtree(np_tree):
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


# ---------------------------------------------------------------------------
# tests/test_parallel.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,qkv", [("ulysses_self", "self_qkv"),
                                      ("ulysses_cross", "cross_qkv"),
                                      ("ulysses_batch1", "batch1_qkv")])
def test_ulysses_matches_jax(run, mesh, case, qkv):
    """Self- and cross-attention, and the CFG-skip tail's batch of 1 under
    dp = 2 (the batch stays whole)."""
    inp, res = run
    want = _jit(make_ulysses_attention(mesh, inner=xla_attention),
                *inp[qkv])
    _close(res[case], want)


@pytest.mark.parametrize("case,qkv", [("ring_self", "ring_qkv"),
                                      ("ring_cross", "ring_cross_qkv")])
def test_ring_matches_jax(run, mesh, case, qkv):
    inp, res = run
    _close(res[case], _jit(make_ring_attention(mesh), *inp[qkv]))


def _jax_grads(attn, qkv, cot):
    """jax.grad of sum(attn(q, k, v) * cot) in q, k and v."""
    def loss(q, k, v):
        return jnp.sum(attn(q, k, v) * cot)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in qkv))


@pytest.mark.parametrize("name", ["ring_qkv", "ring_cross_qkv", "usp_qkv",
                                  "usp_ring4_qkv"])
def test_ring_and_usp_gradients_match_jax(run, mesh, usp_mesh, name):
    """The ring's hops carry gradients: q, k and v's gradients of ring
    self- and cross-attention and of USP self-attention (on the USP mesh,
    and on a ring of 4, where a hop's gradient must go back the other way),
    for a fixed random cotangent, against jax.grad of JAX's schedules."""
    from jax.sharding import Mesh
    inp, res = run
    if name == "ring_qkv" or name == "ring_cross_qkv":
        attn = make_ring_attention(mesh)
    else:
        m = usp_mesh if name == "usp_qkv" else Mesh(
            np.asarray(jax.devices()[:8]).reshape(2, 4, 1),
            ("dp", "ring", "sp"))
        attn = make_usp_attention(m, inner=xla_attention)
    qkv = inp["usp_qkv" if name.startswith("usp") else name]
    want = _jax_grads(attn, qkv, inp["cotangents"][name])
    for arg, got, w in zip("qkv", res[f"{name}_grad"], want):
        _close(got, w, err_msg=f"{name}: d{arg}")


def test_dit_params_tp_sharding(run):
    """Column-split q / fc1 hold out/2 rows, row-split o / fc2 in/2
    columns (JAX's [L, out, in] shards without the L)."""
    _, res = run
    d, f = CFG.dit.dim, CFG.dit.ffn_dim
    assert res["tp_shapes"] == {"q": (d // 2, d), "o": (d, d // 2),
                                "fc1": (f // 2, d), "fc2": (d, f // 2)}


def test_dit_params_int8_tp_sharding(run):
    """weight_q follows weight; w_scale follows the out split of q / fc1
    and stays whole for o / fc2."""
    _, res = run
    d, f = CFG.dit.dim, CFG.dit.ffn_dim
    assert res["int8_shapes"] == {
        "self_attn.q.weight_q": (d // 2, d), "self_attn.q.w_scale": (d // 2,),
        "self_attn.o.weight_q": (d, d // 2), "self_attn.o.w_scale": (d,),
        "ffn.fc1.weight_q": (f // 2, d), "ffn.fc1.w_scale": (f // 2,),
        "ffn.fc2.weight_q": (d, f // 2), "ffn.fc2.w_scale": (d,)}


def test_ulysses_inside_dit_forward(run, mesh):
    inp, res = run
    d = inp["dit_inputs"]
    attn = make_ulysses_attention(mesh, inner=xla_attention)
    with activation_sharding(mesh):
        want = _jit(lambda p, *a: dit_forward(p, JCFG.dit, *a, attn_fn=attn),
                    _jtree(inp["dit_tree"]), d["x"], d["t"], d["ctx"])
    _close(res["dit_ulysses"], want)


def test_dit_forward_int8_under_mesh(run, mesh):
    """The tp-split int8 tree under the mesh, against JAX's under its mesh,
    with JAX's own bounds for this case."""
    inp, res = run
    d = inp["dit_inputs"]
    params = convert_dit_to_int8(_jtree(inp["dit_tree"]))
    sharded = shard_pytree(params, dit_param_shardings(mesh, params))
    attn = make_ulysses_attention(mesh, inner=xla_attention)
    with activation_sharding(mesh):
        want = np.asarray(jax.jit(
            lambda p, *a: dit_forward(p, JCFG.dit, *a, attn_fn=attn)
        )(sharded, d["x"], d["t"], d["ctx"]))
    got = res["dit_int8"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2)
    tight = np.mean(np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want))
    assert tight > 0.95, tight


def test_sharded_vae_decode_parity(run, mesh):
    inp, res = run
    want = np.asarray(vae_decode_sharded(_jtree(inp["vae_tree"]), VAE,
                                         jnp.asarray(inp["vae_z"]), mesh))
    _close(res["vae_decode"], want)


def test_sharded_vae_encode_parity(run, mesh):
    """The width-split encode (each rank a 32-pixel slice: patchify and the
    three stride-2 downsamples stay aligned) against JAX's."""
    inp, res = run
    want = np.asarray(vae_encode_sharded(_jtree(inp["vae_tree"]), VAE,
                                         jnp.asarray(inp["vae_x"]), mesh))
    _close(res["vae_encode"], want)


def test_pipeline_under_the_mesh(run):
    """The tiny pipeline on 8 ranks equals itself on one: the conditioning
    through the width-split encode (`vae_mesh`), a 2-step CFG denoise with
    Ulysses over sp (its all_to_alls counted: q, k and v in and the output
    back per self-attention, none on one rank), and the width-split decode
    (uint8, within one level)."""
    _, res = run
    one, mesh = res["pipeline"]["single"], res["pipeline"]["mesh"]
    assert one["exchanges"] == 0
    assert mesh["exchanges"] > 0 and mesh["exchanges"] % 4 == 0
    _close(mesh["cond"], one["cond"])
    _close(mesh["latents"], one["latents"])
    assert np.abs(mesh["video"].astype(int) - one["video"].astype(int)
                  ).max() <= 1


def test_usp_self_and_cross_attention(run, usp_mesh):
    inp, res = run
    attn = make_usp_attention(usp_mesh, inner=xla_attention)
    _close(res["usp_self"], _jit(attn, *inp["usp_qkv"]))
    _close(res["usp_cross"], _jit(attn, *inp["usp_cross_qkv"]))


def test_usp_degenerate_axes_match_pure_schedules(run):
    """ring = 1 is Ulysses over sp = 4, ulysses = 1 the ring over 4."""
    from jax.sharding import Mesh
    inp, res = run
    dev = np.asarray(jax.devices()[:8])
    for name, shape in (("usp_ring1", (2, 1, 4)), ("usp_ulysses1", (2, 4, 1))):
        m = Mesh(dev.reshape(shape), ("dp", "ring", "sp"))
        _close(res[name], _jit(make_usp_attention(m, inner=xla_attention),
                               *inp["usp_qkv"]), err_msg=name)


def test_usp_inside_dit_forward(run, usp_mesh):
    inp, res = run
    u = inp["usp_dit_inputs"]
    attn = make_usp_attention(usp_mesh, inner=xla_attention)
    want = _jit(lambda p, *a: dit_forward(
        p, JCFG.dit, *a[:3], density=a[3], y=a[4], additional_control=a[5],
        full_ref=a[6], attn_fn=attn), _jtree(inp["dit_tree"]), u["x"],
        u["t"], u["ctx"], u["dens"], u["y"], u["add"], u["ref"])
    _close(res["dit_usp"], want)


def test_sparse_inner_through_ulysses(run, mesh):
    inp, res = run
    frames, spatial = inp["sparse_ulysses"]["geometry"]
    inner = make_sparse_attn_fn(frames, spatial, ref_tokens=spatial,
                                window=2, group=1)
    want = _jit(make_ulysses_attention(mesh, inner=inner),
                *inp["sparse_ulysses"]["qkv"])
    _close(res["sparse_ulysses"], want)
    pol = video_sparse_policy(frames, spatial, ref_tokens=spatial, window=2,
                              group=1)
    q, k, v = (jnp.asarray(a) for a in inp["sparse_ulysses"]["qkv"])
    _close(res["sparse_ulysses"], masked_dense_attention(
        q, k, v, pol["rows"], pol["blk"]))


def test_sparse_ring_through_usp(run, usp_mesh):
    inp, res = run
    sp = inp["usp_sparse"]
    attn = make_usp_attention(usp_mesh, inner=xla_attention,
                              sparse=sp["policy"])
    _close(res["usp_sparse"], _jit(attn, *sp["qkv"]))
    _close(res["usp_sparse_cross"], _jit(attn, *sp["cross_qkv"]))


def test_usp_sparse_policy_ring_mismatch_raises(run, usp_mesh):
    """80 tokens in blocks of 16 do not tile a ring of 2: both refuse."""
    inp, res = run
    with pytest.raises(ValueError, match="ring") as e:
        make_usp_attention(usp_mesh, sparse=inp["usp_mismatch"])
    assert res["usp_mismatch"] == str(e.value)


# ---------------------------------------------------------------------------
# tests/test_fused_ops.py, the mesh cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mesh", "indivisible"])
def test_rmsnorm_rope_per_shard(run, mesh, name):
    """B3's function on each rank's share with the tables at its token
    offset; shapes the mesh does not divide stay whole."""
    inp, res = run
    x, gamma, cos, sin, heads = inp["fused"]["rmsnorm_rope"][name]
    with activation_sharding(mesh):
        want = np.asarray(rmsnorm_rope(jnp.asarray(x), jnp.asarray(gamma),
                                       jnp.asarray(cos), jnp.asarray(sin),
                                       heads, interpret=True))
    _close(res[f"fused_{name}"], want)


@pytest.mark.parametrize("name", ["binary", "bcast", "ln_indivisible"])
def test_ln_modulation_per_shard(run, mesh, name):
    inp, res = run
    x, sh, sc, mask = inp["fused"]["ln_modulation"][name]
    with activation_sharding(mesh):
        want = np.asarray(ln_modulation(
            jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc),
            mask=None if mask is None else jnp.asarray(mask),
            interpret=True))
    _close(res[f"fused_{name}"], want)


def test_dit_forward_fused_under_mesh(run, mesh, monkeypatch):
    """head_dim 128: B3 / B4 per shard (their plain versions here), the
    block linears split over tp, against JAX's fused forward on the
    tp-sharded tree under its mesh."""
    inp, res = run
    f = inp["fused"]
    params = _jtree(f["dit_tree"])
    d = {k: jnp.asarray(v) for k, v in f["dit_inputs"].items()}
    monkeypatch.setenv("FLEXAM_FUSED", "interpret")
    sharded = shard_pytree(params, dit_param_shardings(mesh, params))
    with activation_sharding(mesh):
        want = np.asarray(jax.jit(
            lambda p, *a: dit_forward(p, FUSED, *a, density=d["dens"])
        )(sharded, d["x"], d["t"], d["ctx"]))
    _close(res["fused_dit"], want)


# ---------------------------------------------------------------------------
# tests/test_train.py, the sharded steps
# ---------------------------------------------------------------------------

def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, tree))


def _port_leaves(tree):
    return jax.tree_util.tree_leaves(stack_blocks(jax.tree_util.tree_map(
        torch.from_numpy, tree)), is_leaf=torch.is_tensor)


def _step_close(got_params, got_mu, want_params, want_mu, lr):
    """One AdamW step as tests/test_torch_train.py holds it: the first
    moments, and each element whose gradient sign is determined."""
    gp = [t.numpy() for t in _port_leaves(got_params)]
    gm = [t.numpy() for t in _port_leaves(got_mu)]
    wp, wm = _leaves(want_params), _leaves(want_mu)
    assert len(gp) == len(wp) == len(gm) == len(wm)
    for g, w, a, m in zip(gp, wp, gm, wm):
        assert g.shape == w.shape and a.shape == m.shape
        np.testing.assert_allclose(
            a, m, rtol=2e-4, atol=1e-5 * max(float(np.abs(m).max()), 1e-30))
        sure = np.abs(m) >= 1e-4 * np.abs(m).max()
        np.testing.assert_allclose(g[sure], w[sure], rtol=2e-4,
                                   atol=lr / 100)
        assert (np.abs(g - w)[~sure] <= 2 * lr + lr / 100).all()


def test_train_step_sharded(run):
    """What JAX's sharded step checks of itself (tests/test_train.py: a
    finite loss, the moments split like their parameters), here for the
    port's step, which must also equal JAX's unsharded step (loss, first
    moments, parameters)."""
    inp, res = run
    params = _jtree(inp["dit_tree"])
    tx, state = jtrain.make_train_state(params)
    new, state, loss = jax.jit(
        lambda p, o, b, k: jtrain.train_step(p, o, tx, JCFG.dit, b, k)
    )(params, state, inp["train"]["batch"], jax.random.PRNGKey(2))
    got = res["train"]
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-4)
    assert got["mu_q_local"] == (CFG.dit.dim // 2, CFG.dit.dim)
    _step_close(got["params"], got["mu"], new, state[0].mu, 1e-5)


def _lora_step_close(inp, got):
    """A port LoRA step under the mesh against JAX's unsharded step: loss,
    factors and first moments (B starts at zero, so A does not move)."""
    lo = inp["lora"]
    tx = optax.adamw(1e-3)
    jl = lo["init"]
    new, state, loss = jax.jit(lambda bp, lp, os, b, k: jtrain.lora_train_step(
        bp, lp, os, tx, JCFG.dit, b, k))(
        _jtree(inp["dit_tree"]), jl, tx.init(jl["blocks"]),
        inp["train"]["batch"], jax.random.PRNGKey(3))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=2e-4)
    gb = [t.numpy() for t in _port_leaves({"blocks": got["blocks"]})]
    gm = [t.numpy() for t in _port_leaves({"blocks": got["mu"]})]
    wb, mu = _leaves(new["blocks"]), _leaves(state[0].mu)
    assert len(gb) == len(gm) == len(wb) == len(mu)
    moved = 0.0
    for g, a, w, m, w0 in zip(gb, gm, wb, mu, _leaves(jl["blocks"])):
        np.testing.assert_allclose(
            a, m, rtol=2e-4, atol=1e-5 * max(float(np.abs(m).max()), 1e-30))
        sure = np.abs(m) >= 1e-4 * max(np.abs(m).max(), 1e-30)
        np.testing.assert_allclose(g[sure], w[sure], rtol=2e-4, atol=1e-5)
        assert (np.abs(g - w) <= 2e-3 + 1e-5).all()
        moved = max(moved, float(np.abs(g - w0).max()))
    assert moved > 0.0


def test_lora_train_step_sharded(run):
    """The LoRA step on the tp-split base, against JAX's unsharded step."""
    inp, res = run
    _lora_step_close(inp, res["lora"])


def test_lora_train_step_unsplit_base_under_tp(run):
    """The LoRA step on a whole base under tp = 2: every tp rank applies the
    whole B@A and holds the factors' whole gradient, which is not summed
    over tp again (the moments would double), against JAX's step."""
    inp, res = run
    _lora_step_close(inp, res["lora_unsplit"])


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------

def test_t5_vocab_split_matches_jax(run):
    """umT5 with heads and ffn split over tp and the token embedding over
    vocabulary rows (ids outside a rank's rows look up zeros, the ranks'
    rows summed), against JAX's unsplit encoder."""
    inp, res = run
    want = np.asarray(jt5.t5_encode(_jtree(inp["t5_tree"]), JCFG.t5,
                                    jnp.asarray(inp["t5_ids"]),
                                    jnp.asarray(inp["t5_mask"])))
    _close(res["t5"], want)
    assert res["t5_embedding_rows"] == (CFG.t5.vocab // 2, CFG.t5.dim)


def test_teacache_decides_alike_on_every_rank(run):
    """TeaCache under the mesh: every rank takes the same skip decisions,
    the same as one device's, with steps both computed and skipped, and
    the same velocity."""
    _, res = run
    tea = res["teacache"]
    outs, flags = tea["single"]
    mouts, mflags = tea["mesh"]
    assert flags == mflags
    assert all(f == flags for f in tea["flags_every_rank"])
    steps = np.diff([0.0] + flags)
    assert 0 < steps.sum() < len(TEA_T), flags
    for a, b in zip(mouts, outs):
        _close(a, b)


def test_all_to_all_output_is_kernel_ready(run):
    """all_to_all of a strided view hands on a contiguous, 16-byte aligned
    [B, L, H/sp, D] tensor, as the kernels' input checks require."""
    _, res = run
    contiguous, misalign, shape = res["a2a_layout"]
    assert contiguous and misalign == 0 and shape == (2, 16, 2, 64)


def test_make_mesh_defaults_to_cuda():
    """`make_mesh` runs on the card unless asked for the CPU: without CUDA
    it raises before it touches any process group."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from flexam_tpu_torch.parallel import make_mesh as tmake_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake_mesh({"sp": 2})


def test_launch_raises_any_ranks_failure():
    """A rank's exception stops the group and is raised by `launch.run`
    with every rank's exit and error: rank 0, waiting for rank 1 at a
    barrier, may be seen to fail first (its peer closed the connection),
    so the report must name rank 1's own error."""
    with pytest.raises(RuntimeError, match=r"rank 1: exit code -?\d+ "
                                           r"ValueError: rank one fails"):
        launch.run(ranks.fail_on_rank_one, 2, timeout=60, run_timeout=120)


@pytest.mark.parametrize("name,match", [
    ("mesh_size", "needs 6 ranks"),
    ("shard_leaf", "does not split over tp=2"),
    ("all_to_all", "does not split over sp=2"),
    ("vae_width", "does not split into 2 slices"),
    ("halo", "cannot lend a halo"),
    ("tp_heads", "3 heads do not split over tp=2"),
])
def test_refusals(run, name, match):
    """Each refusal of the parallel package raises, naming its reason."""
    _, res = run
    assert res["errors"][name] is not None and match in res["errors"][name], \
        res["errors"][name]
