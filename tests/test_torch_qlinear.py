"""The port's int8 linears (`flexam_tpu_torch/ops/qlinear.py`) against the
JAX package's (`flexam_tpu/ops/qlinear.py`), on the CPU: the nine cases of
`tests/test_qlinear.py`, each holding the port to JAX.

Tolerances:
  * weight quantization is exact: `weight_q` and `w_scale` equal JAX's host
    quantization (numpy) bit for bit, per block of JAX's stacked tree, on
    the host path and on the torch path the card takes;
  * `qlinear`: the activations are quantized per token from the float32
    input; where the two packages' int8 activations differ (a value on a
    rounding tie lands one step apart: JAX under `jit` divides by 127 as a
    multiply by its reciprocal, one ulp off), each differing value may move
    an output by one int8 step times its weight, |w_q| * s_x * s_w. The
    flipped values are counted, and the error is bounded by that sum plus
    float32 rounding (2e-6 of the output's size); with no flip the outputs
    agree to float32 rounding;
  * the int8 DiT forward is within JAX's own bound of the float32 forward
    (relative L2 0.02, measured 0.0054), and within 1e-5 relative of JAX's
    int8 forward when no activation flips between the packages (each linear
    call's int8 activations are counted); a flip allows one int8 step
    (1/127 of the row's largest) more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexam_tpu.ops.qlinear as JQ
import flexam_tpu_torch.ops.qlinear as TQ
from flexam_tpu import pipeline as jpipe
from flexam_tpu.config import tiny_test_config as jax_tiny
from flexam_tpu.core.layers import linear as jlinear
from flexam_tpu.core.layers import linear_init as jlinear_init
from flexam_tpu.models.dit import dit_forward as jdit_forward
from flexam_tpu.models.dit import init_dit_params as jinit_dit
from flexam_tpu.models.vae import init_vae_params as jinit_vae
from flexam_tpu_torch import pipeline as tpipe
from flexam_tpu_torch.config import tiny_test_config
from flexam_tpu_torch.core.layers import linear as tlinear
from flexam_tpu_torch.io.convert import from_jax_params
from flexam_tpu_torch.models.dit import dit_forward as tdit_forward

LINEARS = [(g, n) for g, ns in (("self_attn", "qkvo"), ("cross_attn", "qkvo"),
                                ("ffn", ("fc1", "fc2"))) for n in ns]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_tiny_dit(seed=0):
    return _np_tree(jinit_dit(jax.random.PRNGKey(seed), jax_tiny().dit,
                              jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_act_q(x, jit):
    """JAX's activation quantization (the first lines of its `qlinear`),
    eagerly or under jit as the pipeline runs it."""
    def f(x):
        xf = x.astype(jnp.float32)
        amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        s_x = jnp.maximum(amax, 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8), s_x
    q, s = (jax.jit(f) if jit else f)(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _port_act_q(x):
    xf = torch.from_numpy(x).float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s_x = TQ._div(torch.clamp_min(amax, 1e-8), 127.0)
    return (torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
            .numpy(), s_x.numpy())


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_qlinear_matches_jax_and_fp32(jit):
    """The port's qlinear against JAX's on the same float32 input and
    weights, flips counted; and within JAX's 0.02 of the float32 linear."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 256).astype(np.float32)
    p = _np_tree(jlinear_init(jax.random.PRNGKey(0), 256, 128,
                              dtype=jnp.float32))
    qp_j = JQ.quantize_linear_params(p)
    fn = jax.jit(JQ.qlinear) if jit else JQ.qlinear
    y_j = np.asarray(fn(jnp.asarray(x), qp_j))
    qp_t = TQ.quantize_linear_params({k: torch.from_numpy(v)
                                      for k, v in p.items()})
    y_t = TQ.qlinear(torch.from_numpy(x), qp_t).numpy()

    q_j, _ = _jax_act_q(x, jit)
    q_t, s_x = _port_act_q(x)
    flips = (q_j != q_t).reshape(-1, 256)
    w_q = np.abs(qp_t["weight_q"].numpy().astype(np.float32))
    s_w = qp_t["w_scale"].numpy()
    xr = x.reshape(-1, 256)
    # one int8 step per flipped activation, times its weights
    step = (flips.astype(np.float32) @ w_q.T) * s_x.reshape(-1, 1) * s_w
    err = np.abs(y_t - y_j).reshape(-1, 128)
    assert (err <= step + 2e-6 * (np.abs(y_j.reshape(-1, 128)) + 1)).all(), \
        (int(flips.sum()), float(err.max()))
    if not jit:
        assert flips.sum() == 0      # the same formula, the same division
    y = np.asarray(jlinear(jnp.asarray(x), p))
    assert _rel(y_t, y) < 0.02
    assert np.abs(xr).max() > 0


def test_linear_dispatches_on_quantized_params():
    """`linear` takes the int8 path for {"weight_q", "w_scale"} params and
    returns x's dtype, as JAX's does."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 32).astype(np.float32)).bfloat16()
    p = _np_tree(jlinear_init(jax.random.PRNGKey(1), 32, 16,
                              dtype=jnp.float32))
    qp = TQ.quantize_linear_params({k: torch.from_numpy(v)
                                    for k, v in p.items()})
    out = tlinear(x, qp)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, TQ.qlinear(x, qp))
    ref = np.asarray(JQ.qlinear(jnp.asarray(x.float().numpy(),
                                            jnp.bfloat16),
                                JQ.quantize_linear_params(p)),
                     np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=8e-3,
                               atol=8e-3)   # one bf16 ulp


def test_quantize_stacked_weights_match_jax():
    """A stacked [L, out, in] weight quantizes per (layer, out-channel),
    equal to JAX's; layer 1's weights are 3x layer 0's, so its scales are
    3x too."""
    w1 = _np_tree(jlinear_init(jax.random.PRNGKey(2), 64, 48,
                               dtype=jnp.float32))
    ws = {"weight": np.stack([w1["weight"], w1["weight"] * 3.0]),
          "bias": np.stack([w1["bias"], w1["bias"]])}
    qj = JQ.quantize_linear_params(ws)
    qt = TQ.quantize_linear_params({k: torch.from_numpy(v)
                                    for k, v in ws.items()})
    assert tuple(qt["weight_q"].shape) == (2, 48, 64)
    assert tuple(qt["w_scale"].shape) == (2, 48)
    np.testing.assert_array_equal(qt["weight_q"].numpy(), qj["weight_q"])
    np.testing.assert_array_equal(qt["w_scale"].numpy(), qj["w_scale"])
    np.testing.assert_allclose(qt["w_scale"][1].numpy(),
                               qt["w_scale"][0].numpy() * 3.0, rtol=1e-6)


def test_convert_dit_quantizes_blocks_only():
    """In place, the block linears only, and each block's weight_q / w_scale
    equal to JAX's stacked [l] bit for bit."""
    jp = _jax_tiny_dit()
    jq = JQ.convert_dit_to_int8(jax.tree_util.tree_map(lambda a: a, jp))
    tp = from_jax_params(jp, "cpu")
    norm_before = tp["blocks"][0]["self_attn"]["norm_q"]
    patch_before = tp["patch_embedding"]["weight"]
    q = TQ.convert_dit_to_int8(tp)
    assert q is tp and TQ.is_quantized(q)
    for l, bp in enumerate(q["blocks"]):
        for g, n in LINEARS:
            lin = bp[g][n]
            assert "weight" not in lin and lin["weight_q"].dtype == torch.int8
            np.testing.assert_array_equal(
                lin["weight_q"].numpy(), jq["blocks"][g][n]["weight_q"][l])
            np.testing.assert_array_equal(
                lin["w_scale"].numpy(), jq["blocks"][g][n]["w_scale"][l])
            np.testing.assert_array_equal(
                lin["bias"].numpy(), jq["blocks"][g][n]["bias"][l])
        assert bp["modulation"].dtype == torch.float32
    assert q["blocks"][0]["self_attn"]["norm_q"] is norm_before
    assert q["patch_embedding"]["weight"] is patch_before
    assert not TQ.is_quantized(from_jax_params(jp, "cpu"))


def _forward_inputs(cfg):
    rs = np.random.RandomState(0)
    b = 2
    return dict(x=rs.randn(b, 8, 2, 4, 4).astype(np.float32),
                t=np.full((b,), 500.0, np.float32),
                context=rs.randn(b, 4, cfg.text_dim).astype(np.float32),
                y=rs.randn(b, 20, 2, 4, 4).astype(np.float32),
                additional_control=rs.randn(b, 40, 2, 4, 4).astype(
                    np.float32),
                full_ref=rs.randn(b, 8, 4, 4).astype(np.float32))


def _recording(monkeypatch, module, store, record):
    orig = module.qlinear

    def rec(x, p):
        record(store, x)
        return orig(x, p)
    monkeypatch.setattr(module, "qlinear", rec)


def _record_jax(store, x):
    # the block stack runs under `lax.scan`: take the value on the host
    jax.debug.callback(lambda a: store.append(np.asarray(a)), x,
                       ordered=True)


def _record_port(store, x):
    store.append(x.detach().numpy().copy())


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_dit_forward_int8_matches_jax(monkeypatch, jit):
    """The tiny DiT forward through the int8 linears: within 0.02 of the
    float32 forward (JAX's bound), and held to JAX's int8 forward with the
    int8 activations of every linear call counted (JAX's block stack is a
    compiled `lax.scan` either way, so its activations are quantized with
    the reciprocal of 127)."""
    jcfg = jax_tiny().dit
    jp = _jax_tiny_dit()
    jq = JQ.convert_dit_to_int8(jax.tree_util.tree_map(lambda a: a, jp))
    tq = TQ.convert_dit_to_int8(from_jax_params(jp, "cpu"))
    inp = _forward_inputs(jcfg)

    def jfwd(p, **a):
        return jdit_forward(p, jcfg, a["x"], a["t"], a["context"],
                            y=a["y"], additional_control=a[
                                "additional_control"], full_ref=a["full_ref"])
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    v0 = np.asarray(jfwd(jp, **jin))
    jx, tx = [], []
    _recording(monkeypatch, JQ, jx, _record_jax)
    _recording(monkeypatch, TQ, tx, _record_port)
    v_j = np.asarray((jax.jit(jfwd) if jit else jfwd)(jq, **jin))
    jax.effects_barrier()
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    v_t = tdit_forward(tq, tiny_test_config().dit, tin["x"], tin["t"],
                       tin["context"], y=tin["y"],
                       additional_control=tin["additional_control"],
                       full_ref=tin["full_ref"]).numpy()
    assert _rel(v_t, v0) < 0.02
    assert _rel(v_j, v0) < 0.02
    assert len(tx) == len(jx) == 10 * jcfg.num_layers
    flips = sum(int((_jax_act_q(a, True)[0] != _port_act_q(b)[0]).sum())
                for a, b in zip(jx, tx))
    assert _rel(v_t, v_j) < 1e-5 + flips / 127.0, (flips, _rel(v_t, v_j))


def test_pipeline_quant_flag(monkeypatch):
    """quant="int8" (or FLEXAM_QUANT=int8) converts both DiT experts when
    the pipeline is built, as JAX's does, and a tree swapped in through
    `set_dit_params` too; unknown modes refuse."""
    cfg = jax_tiny()
    k = jax.random.PRNGKey(0)
    dit = _np_tree(jinit_dit(k, cfg.dit))
    vae = _np_tree(jinit_vae(k, cfg.vae))

    def models():
        return tpipe.FlexAMModels(
            cfg=tiny_test_config(), dit_params=from_jax_params(dit, "cpu"),
            vae_params=from_jax_params(vae, "cpu"),
            dit2_params=from_jax_params(dit, "cpu"))
    pipe = tpipe.FlexAMGenerationPipeline(models(), device="cpu",
                                          quant="int8",
                                          compute_dtype=torch.float32)
    assert pipe.quant == "int8" and pipe.compute_dtype == torch.float32
    assert TQ.is_quantized(pipe.models.dit_params)
    assert TQ.is_quantized(pipe.models.dit2_params)
    pipe.set_dit_params(from_jax_params(dit, "cpu"))   # a swap, quantized
    assert TQ.is_quantized(pipe.models.dit_params)
    jpipe_q = jpipe.FlexAMGenerationPipeline(
        jpipe.FlexAMModels(cfg=cfg, dit_params=jax.tree_util.tree_map(
            lambda a: a, dit), vae_params=vae, dit2_params=None),
        compute_dtype=jnp.float32, quant="int8")
    np.testing.assert_array_equal(
        pipe.models.dit_params["blocks"][1]["ffn"]["fc2"]["weight_q"].numpy(),
        np.asarray(jpipe_q.models.dit_params["blocks"]["ffn"]["fc2"]
                   ["weight_q"][1]))
    monkeypatch.setenv("FLEXAM_QUANT", "int8")
    pipe = tpipe.FlexAMGenerationPipeline(models(), device="cpu")
    assert pipe.quant == "int8" and TQ.is_quantized(pipe.models.dit2_params)
    monkeypatch.setenv("FLEXAM_QUANT", "none")
    assert tpipe.FlexAMGenerationPipeline(models(), device="cpu").quant is None
    with pytest.raises(ValueError, match="quant"):
        tpipe.FlexAMGenerationPipeline(models(), device="cpu", quant="int4")


def test_host_quantize_matches_device():
    """A host weight quantizes with numpy, a device weight with torch ops
    (here on the CPU, the card's code path): both equal JAX's host
    quantization bit for bit, weight_q and w_scale. (JAX's own jitted
    quantization divides by 127 as a multiply by the reciprocal, so its
    scales may sit an ulp off its host ones; the port matches the host.)"""
    rs = np.random.RandomState(0)
    w = rs.randn(3, 48, 64).astype(np.float32) * 0.3
    b = rs.randn(3, 48).astype(np.float32)
    jh = JQ.quantize_linear_params({"weight": w, "bias": b})
    host = TQ.quantize_linear_params({"weight": torch.from_numpy(w),
                                      "bias": torch.from_numpy(b)})
    dev_q, dev_s = TQ._quantize_weight(torch.from_numpy(w))
    assert host["weight_q"].dtype == torch.int8
    for q, s in ((host["weight_q"], host["w_scale"]), (dev_q, dev_s)):
        np.testing.assert_array_equal(q.numpy(), jh["weight_q"])
        np.testing.assert_array_equal(s.numpy(), jh["w_scale"])
    jd = JQ.quantize_linear_params({"weight": jnp.asarray(w)})
    np.testing.assert_array_equal(np.asarray(jd["weight_q"]), jh["weight_q"])
    np.testing.assert_allclose(np.asarray(jd["w_scale"]), jh["w_scale"],
                               rtol=1e-7)


def test_convert_dit_host_tree_and_upload():
    """A host DiT tree quantizes on the host; `_put_quantized` takes it to
    the device by JAX's rule: int8 leaves at storage width, float32 leaves
    of two or more dims (in JAX's stacked layout) as bf16, the scales
    float32. Leaf for leaf against JAX's `_put_quantized` of the same
    tree, in value and dtype; a tree already on the device passes through."""
    jp = _jax_tiny_dit()
    jdev = jpipe._put_quantized(JQ.convert_dit_to_int8(
        jax.tree_util.tree_map(lambda a: a, jp)))
    host = TQ.convert_dit_to_int8(from_jax_params(jp, "cpu"))
    for dev in (torch.device("meta"), torch.device("cpu")):
        tree = host if dev.type == "meta" else _as_numpy(host)
        up = tpipe._put_quantized(tree, dev)
        _check_leaves(up, jdev)
    same = tpipe._put_quantized(host, torch.device("cpu"))
    assert same["blocks"][0]["ffn"]["fc1"]["weight_q"] is \
        host["blocks"][0]["ffn"]["fc1"]["weight_q"]
    assert same["patch_embedding"]["weight"].dtype == torch.float32


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_numpy(v) for v in tree]
    return tree.numpy()


def _check_leaves(port, jax_tree, layer=None):
    """Port tree (per-block list) against JAX's (stacked): equal dtypes,
    and equal values unless the port's leaf is a meta tensor."""
    if isinstance(port, dict):
        for k, v in port.items():
            _check_leaves(v, jax_tree[k], layer)
        return
    if isinstance(port, list):
        for i, v in enumerate(port):
            _check_leaves(v, jax_tree, i)
        return
    j = jax_tree if layer is None else jax_tree[layer]
    j = np.asarray(j)
    assert str(port.dtype).replace("torch.", "") == str(j.dtype), \
        (port.dtype, j.dtype)
    if port.device.type != "meta":
        np.testing.assert_array_equal(port.float().numpy(),
                                      j.astype(np.float32))


def test_host_fp8_tree_uploads_narrow():
    """fp8 conversion of a host tree; `_put_quantized` ships the e4m3 bytes
    as they are and keeps 1-D leaves float32, as JAX's does, with bytes
    equal to JAX's."""
    from flexam_tpu.utils.fp8 import convert_weights_to_fp8 as jfp8

    from flexam_tpu_torch.utils.fp8 import FP8, convert_weights_to_fp8

    rng = np.random.RandomState(1)
    tree = {"ffn": {"fc1": {"weight": rng.randn(16, 8).astype(np.float32),
                            "bias": rng.randn(16).astype(np.float32)}},
            "norm": rng.randn(8).astype(np.float32)}
    jt = jfp8(jax.tree_util.tree_map(lambda a: a, tree))
    tt = convert_weights_to_fp8(
        jax.tree_util.tree_map(torch.from_numpy, tree))
    w = tt["ffn"]["fc1"]["weight"]
    assert w.dtype == FP8
    np.testing.assert_array_equal(w.view(torch.uint8).numpy(),
                                  jt["ffn"]["fc1"]["weight"].view(np.uint8))
    dev = tpipe._put_quantized(tt, torch.device("meta"))
    assert dev["ffn"]["fc1"]["weight"].dtype == FP8
    assert dev["ffn"]["fc1"]["bias"].dtype == torch.float32
    assert dev["norm"].dtype == torch.float32            # 1-D stays wide
    jdev = jpipe._put_quantized(jt)
    assert str(jdev["ffn"]["fc1"]["weight"].dtype) == "float8_e4m3fn"
    assert jdev["norm"].dtype == jnp.float32
