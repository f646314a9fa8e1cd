"""The rank side of `tests/test_torch_parallel.py`: every case the port
runs on a mesh of CPU ranks over gloo, in one spawned group
(`flexam_tpu_torch.parallel.launch.run(run_cases, 8, inputs)`). Imports
torch and the port only, so that the ranks start without jax.

Each case takes the test's numpy inputs and weights (JAX trees carried
across by `from_jax_params`, then `shard_pytree`), runs the port on this
rank's share, and returns the whole result (gathered) as numpy, keyed by
case. Every rank runs every case in the same order: the collectives of
one case meet across the ranks.
"""

import time
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from flexam_tpu_torch import train as T
from flexam_tpu_torch.config import DiTConfig, VAEConfig, tiny_test_config
from flexam_tpu_torch.core.attention import exact_attention
from flexam_tpu_torch.io.convert import from_jax_params, map_leaves
from flexam_tpu_torch.models import dit as tdit
from flexam_tpu_torch.models import t5 as tt5
from flexam_tpu_torch.ops import fused, qlinear
from flexam_tpu_torch.ops.sparse_attention import make_sparse_attn_fn
from flexam_tpu_torch.parallel import (activation_sharding,
                                       dit_param_shardings, make_mesh,
                                       shard_pytree, t5_param_shardings,
                                       token_layout)
from flexam_tpu_torch.parallel import comm
from flexam_tpu_torch.parallel.ring import make_ring_attention
from flexam_tpu_torch.parallel.sharding import (Shard, gather_pytree,
                                                shard_leaf)
from flexam_tpu_torch.parallel.ulysses import make_ulysses_attention
from flexam_tpu_torch.parallel.usp import make_usp_attention
from flexam_tpu_torch.parallel.vae_parallel import (WidthSplit,
                                                    vae_decode_sharded,
                                                    vae_encode_sharded)

CFG = tiny_test_config()
FUSED_CFG = DiTConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                      in_dim=8, out_dim=4, text_dim=32, text_len=6,
                      freq_dim=32, add_ref_conv=False, add_cnn_block=False)
VAE_CFG = VAEConfig(latent_channels=8, c_dim=16, dec_dim=16,
                    dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                    temporal_downsample=(False, True, True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _sharded_attention(mesh, attn, q, k, v, token_axes=("sp",)):
    """attn on this rank's share of q (and of k, v for self-attention);
    the whole output."""
    q, k, v = _t(q), _t(k), _t(v)
    lay = token_layout(mesh, q.shape[0], q.shape[1], token_axes)
    self_attn = q.shape[1] == k.shape[1]
    ql = lay.shard(q, 0, 1)
    kl, vl = (lay.shard(t, 0, 1 if self_attn else None) for t in (k, v))
    return _np(lay.gather(attn(ql, kl, vl), 0, 1))


def _sharded_attention_grads(mesh, attn, q, k, v, cot,
                             token_axes=("sp",)):
    """The gradients of sum(attn(q, k, v) * cot) in q, k and v, whole on
    every rank: each rank differentiates its share of the output, the
    collectives carry the gradient across ranks, and the whole leaves'
    gradients are summed over every data axis (tp holds copies)."""
    q, k, v = (_t(a).requires_grad_() for a in (q, k, v))
    lay = token_layout(mesh, q.shape[0], q.shape[1], token_axes)
    self_attn = q.shape[1] == k.shape[1]
    ql = lay.shard(q, 0, 1)
    kl, vl = (lay.shard(t, 0, 1 if self_attn else None) for t in (k, v))
    out = lay.gather(attn(ql, kl, vl), 0, 1)
    (out * _t(cot)).sum().backward()
    grads = []
    for g in (q.grad, k.grad, v.grad):
        for a in mesh.shape:
            if a != "tp":
                g = comm.all_reduce_raw(g, mesh, a)
        grads.append(_np(g))
    return grads


def _dit_inputs(inp):
    return {k: _t(v) for k, v in inp.items()}


def _whole_leaves(opt, local, shard, mesh):
    """The updated leaves and AdamW's first moments, gathered whole."""
    mu = map_leaves(local, lambda k, t, b: opt.opt.state[t]["exp_avg"]
                    if t in opt.opt.state else torch.zeros_like(t))
    return (gather_pytree(local, shard, mesh),
            gather_pytree(mu, shard, mesh))


def _lora_step(mesh, base, lo, batch) -> dict:
    """One LoRA step under the mesh: loss, factors and first moments."""
    tl = {"blocks": from_jax_params({"blocks": lo["blocks"]}, "cpu")
          ["blocks"], "rank": lo["rank"], "alpha": lo["alpha"]}
    opt = T.adamw(T.trainable(tl["blocks"]), 1e-3)
    with activation_sharding(mesh):
        tl, loss = T.lora_train_step(base, tl, opt, CFG.dit, batch,
                                     sigma=_t(lo["sigma"]), eps=_t(lo["eps"]))
    return {"loss": float(loss),
            "blocks": map_leaves(tl["blocks"], lambda k, t, b: _np(t)),
            "mu": map_leaves(tl["blocks"], lambda k, t, b: _np(
                opt.opt.state[t]["exp_avg"] if t in opt.opt.state
                else torch.zeros_like(t)))}


def _errors(mesh) -> dict:
    """The port's refusals, each as its message."""
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"

    catch("mesh_size", lambda: make_mesh({"dp": 3, "sp": 2}, device="cpu"))
    catch("shard_leaf", lambda: shard_leaf(torch.zeros(3, 4),
                                           Shard(0, "tp"), mesh))
    catch("all_to_all", lambda: comm.all_to_all(torch.zeros(1, 4, 3, 2),
                                                mesh, "sp", 2, 1))
    catch("vae_width", lambda: vae_decode_sharded(
        {}, VAE_CFG, torch.zeros(1, 8, 1, 2, 3), mesh))
    catch("halo", lambda: WidthSplit(mesh, "sp").halo(
        torch.zeros(1, 1, 1, 1, 1), 2, 2))
    catch("tp_heads", lambda: tdit._tp_split(
        {"blocks": [{"self_attn": {"q": {"weight": torch.zeros(48, 96)}}}]},
        DiTConfig(dim=96, num_heads=3, num_layers=1), mesh))
    return out


def _pipeline(mesh, inp) -> dict:
    """The tiny pipeline on one rank and under the mesh: conditioning
    (width-split encode under `vae_mesh`), a 2-step CFG denoise (under
    activation_sharding: `dit_forward` runs the attention as Ulysses' inner)
    and the decode. `exchanges` counts Ulysses' all_to_alls in the
    denoise: the CPU's trace that the mesh path ran (no kernel launches
    here)."""
    from flexam_tpu_torch.models.t5 import init_t5_params
    from flexam_tpu_torch.models.vae import init_vae_params
    from flexam_tpu_torch.pipeline import (FlexAMGenerationPipeline,
                                           FlexAMModels)
    kw = dict(dtype=torch.float32, device="cpu")
    models = FlexAMModels(CFG, tdit.init_dit_params(CFG.dit, seed=3, **kw),
                          init_vae_params(CFG.vae, seed=4, **kw),
                          init_t5_params(CFG.t5, seed=5, **kw))
    pipe = FlexAMGenerationPipeline(models, device="cpu")
    ids = np.arange(16, dtype=np.int32)[None] % 64
    ctx = pipe.encode_prompt_ids(ids, np.ones((1, 16), np.int32))
    context = torch.cat([ctx, ctx], dim=0)
    out = {}
    exchanges = [0]
    all_to_all = comm.all_to_all

    def counted(*a, **kw):
        exchanges[0] += 1
        return all_to_all(*a, **kw)
    for name in ("single", "mesh"):
        pipe.vae_mesh = mesh if name == "mesh" else None
        cond = pipe.prepare_conditioning(*(_t(a) if a is not None else None
                                           for a in inp["videos"]))
        with (activation_sharding(mesh) if name == "mesh"
              else nullcontext()):
            exchanges[0] = 0
            comm.all_to_all = counted
            try:
                lat = pipe.denoise(cond, context, num_inference_steps=2,
                                   guidance_scale=6.0, density=0.1,
                                   latents=_t(inp["noise"]))
            finally:
                comm.all_to_all = all_to_all
        out[name] = {"cond": _np(cond["control_latents"]),
                     "latents": _np(lat), "exchanges": exchanges[0],
                     "video": _np(pipe.decode_u8(lat))}
    return out


def run_cases(inp: dict) -> dict:
    """Every case on this rank (see the module docstring)."""
    torch.manual_seed(0)
    res = {"seconds": {}}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = now - mark[0]
        mark[0] = now

    mesh = make_mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu")

    # --- attention schedules (tests/test_parallel.py)
    uly = make_ulysses_attention(mesh, inner=exact_attention)
    res["ulysses_self"] = _sharded_attention(mesh, uly, *inp["self_qkv"])
    res["ulysses_cross"] = _sharded_attention(mesh, uly, *inp["cross_qkv"])
    res["ulysses_batch1"] = _sharded_attention(mesh, uly, *inp["batch1_qkv"])
    ring = make_ring_attention(mesh)
    res["ring_self"] = _sharded_attention(mesh, ring, *inp["ring_qkv"])
    res["ring_cross"] = _sharded_attention(mesh, ring, *inp["ring_cross_qkv"])
    for name in ("ring_qkv", "ring_cross_qkv"):
        res[f"{name}_grad"] = _sharded_attention_grads(
            mesh, ring, *inp[name], inp["cotangents"][name])
    sp_pol = inp["sparse_ulysses"]
    sparse_inner = make_sparse_attn_fn(*sp_pol["geometry"], window=2,
                                       group=1, ref_tokens=sp_pol["geometry"]
                                       [1])
    res["sparse_ulysses"] = _sharded_attention(
        mesh, make_ulysses_attention(mesh, inner=sparse_inner),
        *sp_pol["qkv"])
    # all_to_all hands the kernels contiguous, 16-byte aligned tensors
    x = torch.arange(2 * 8 * 4 * 128, dtype=torch.float32).reshape(
        2, 8, 4, 128)[:, :, :, :64]
    y = comm.all_to_all(x, mesh, "sp", 2, 1)
    res["a2a_layout"] = (y.is_contiguous(), y.data_ptr() % 16,
                         tuple(y.shape))

    lap("attention")
    usp_mesh = make_mesh({"dp": 2, "ring": 2, "sp": 2}, device="cpu")
    usp_axes = ("ring", "sp")
    usp = make_usp_attention(usp_mesh, inner=exact_attention)
    res["usp_self"] = _sharded_attention(usp_mesh, usp, *inp["usp_qkv"],
                                         token_axes=usp_axes)
    res["usp_cross"] = _sharded_attention(usp_mesh, usp,
                                          *inp["usp_cross_qkv"],
                                          token_axes=usp_axes)
    res["usp_qkv_grad"] = _sharded_attention_grads(
        usp_mesh, usp, *inp["usp_qkv"], inp["cotangents"]["usp_qkv"],
        token_axes=usp_axes)
    pol = inp["usp_sparse"]["policy"]
    usp_sp = make_usp_attention(usp_mesh, inner=exact_attention, sparse=pol)
    res["usp_sparse"] = _sharded_attention(usp_mesh, usp_sp,
                                           *inp["usp_sparse"]["qkv"],
                                           token_axes=usp_axes)
    res["usp_sparse_cross"] = _sharded_attention(
        usp_mesh, usp_sp, *inp["usp_sparse"]["cross_qkv"],
        token_axes=usp_axes)
    try:
        make_usp_attention(usp_mesh, sparse=inp["usp_mismatch"])
        res["usp_mismatch"] = None
    except ValueError as e:
        res["usp_mismatch"] = str(e)
    for name, axes in (("usp_ring1", {"dp": 2, "ring": 1, "sp": 4}),
                       ("usp_ulysses1", {"dp": 2, "ring": 4, "sp": 1})):
        m = make_mesh(axes, device="cpu")
        res[name] = _sharded_attention(
            m, make_usp_attention(m, inner=exact_attention),
            *inp["usp_qkv"], token_axes=usp_axes)
    # a ring of 4, where a hop's gradient must go the other way round
    m = make_mesh({"dp": 2, "ring": 4, "sp": 1}, device="cpu")
    res["usp_ring4_qkv_grad"] = _sharded_attention_grads(
        m, make_usp_attention(m, inner=exact_attention), *inp["usp_qkv"],
        inp["cotangents"]["usp_ring4_qkv"], token_axes=usp_axes)

    lap("usp")
    # --- parameter shardings
    port = from_jax_params(inp["dit_tree"], "cpu")
    local = shard_pytree(port, dit_param_shardings(mesh, port), mesh)
    b0 = local["blocks"][0]
    res["tp_shapes"] = {k: tuple(b0[m][p]["weight"].shape) for k, (m, p) in
                        {"q": ("self_attn", "q"), "o": ("self_attn", "o"),
                         "fc1": ("ffn", "fc1"), "fc2": ("ffn", "fc2")}.items()}
    q8 = qlinear.convert_dit_to_int8(from_jax_params(inp["dit_tree"], "cpu"))
    local8 = shard_pytree(q8, dit_param_shardings(mesh, q8), mesh)
    b8 = local8["blocks"][0]
    res["int8_shapes"] = {f"{m}.{p}.{leaf}": tuple(b8[m][p][leaf].shape)
                          for m, p in (("self_attn", "q"), ("self_attn", "o"),
                                       ("ffn", "fc1"), ("ffn", "fc2"))
                          for leaf in ("weight_q", "w_scale")}

    lap("shardings")
    # --- the DiT under the mesh
    d = _dit_inputs(inp["dit_inputs"])
    with activation_sharding(mesh):
        res["dit_ulysses"] = _np(tdit.dit_forward(
            port, CFG.dit, d["x"], d["t"], d["ctx"],
            attn_fn=make_ulysses_attention(mesh, inner=exact_attention)))
        res["dit_int8"] = _np(tdit.dit_forward(
            local8, CFG.dit, d["x"], d["t"], d["ctx"],
            attn_fn=make_ulysses_attention(mesh, inner=exact_attention)))
    u = _dit_inputs(inp["usp_dit_inputs"])
    with activation_sharding(usp_mesh):
        res["dit_usp"] = _np(tdit.dit_forward(
            port, CFG.dit, u["x"], u["t"], u["ctx"], density=u["dens"],
            y=u["y"], additional_control=u["add"], full_ref=u["ref"],
            attn_fn=usp))

    lap("dit")
    # --- the fused ops on each rank's share (tests/test_fused_ops.py)
    f = inp["fused"]
    for name, (x, gamma, cos, sin, heads) in f["rmsnorm_rope"].items():
        x = _t(x)
        lay = token_layout(mesh, x.shape[0], x.shape[1])
        start, n = (lay.token_range(x.shape[1]) if lay.token_axes
                    else (0, x.shape[1]))
        cos_l = tdit._rope_rows(_t(cos), start, n, 1.0)
        sin_l = tdit._rope_rows(_t(sin), start, n, 0.0)
        out = fused.rmsnorm_rope(lay.shard(x, 0, 1).contiguous(), _t(gamma),
                                 cos_l, sin_l, heads)
        res[f"fused_{name}"] = _np(lay.gather(out, 0, 1))
    for name, (x, sh, sc, mask) in f["ln_modulation"].items():
        x = _t(x)
        lay = token_layout(mesh, x.shape[0], x.shape[1])
        m = lay.shard(_t(mask), 0, 1) if mask is not None else None
        out = fused.ln_modulation(lay.shard(x, 0, 1).contiguous(),
                                  lay.shard(_t(sh), 0), lay.shard(_t(sc), 0),
                                  mask=m)
        res[f"fused_{name}"] = _np(lay.gather(out, 0, 1))
    fport = from_jax_params(f["dit_tree"], "cpu")
    flocal = shard_pytree(fport, dit_param_shardings(mesh, fport), mesh)
    fd = _dit_inputs(f["dit_inputs"])
    with activation_sharding(mesh):
        res["fused_dit"] = _np(tdit.dit_forward(
            flocal, FUSED_CFG, fd["x"], fd["t"], fd["ctx"],
            density=fd["dens"]))

    lap("fused")
    # --- the width-split VAE decode
    vae = from_jax_params(inp["vae_tree"], "cpu")
    res["vae_decode"] = _np(vae_decode_sharded(vae, VAE_CFG,
                                               _t(inp["vae_z"]), mesh))
    res["vae_encode"] = _np(vae_encode_sharded(vae, VAE_CFG,
                                               _t(inp["vae_x"]), mesh))
    lap("vae")
    res["pipeline"] = _pipeline(mesh, inp["pipeline"])

    lap("pipeline")
    # --- sharded training (tests/test_train.py)
    tr = inp["train"]
    shard = dit_param_shardings(mesh, port)
    tlocal = shard_pytree(from_jax_params(inp["dit_tree"], "cpu"), shard,
                          mesh)
    opt = T.make_train_state(tlocal, param_shardings=shard)
    batch = T.batch_to(tr["batch"], "cpu")
    with activation_sharding(mesh):
        tlocal, loss = T.train_step(tlocal, opt, CFG.dit, batch,
                                    sigma=_t(tr["sigma"]), eps=_t(tr["eps"]))
    whole, mu = _whole_leaves(opt, tlocal, shard, mesh)
    res["train"] = {"loss": float(loss), "params": map_leaves(
        whole, lambda k, t, b: _np(t)), "mu": map_leaves(
        mu, lambda k, t, b: _np(t)),
        "mu_q_local": tuple(opt.opt.state[
            tlocal["blocks"][0]["self_attn"]["q"]["weight"]]["exp_avg"]
            .shape)}
    # the LoRA step on the tp-split base, and on the whole base (every tp
    # rank applies the whole B@A: the factors' gradients are whole there)
    whole_base = from_jax_params(inp["dit_tree"], "cpu")
    for name, base in (("lora", shard_pytree(whole_base, shard, mesh)),
                       ("lora_unsplit", whole_base)):
        res[name] = _lora_step(mesh, base, inp["lora"], batch)

    lap("train")
    # --- the port's own: umT5 split over tp, TeaCache across ranks, errors
    t5 = from_jax_params(inp["t5_tree"], "cpu")
    t5_local = shard_pytree(t5, t5_param_shardings(mesh, t5), mesh)
    ids, mask = _t(inp["t5_ids"]).long(), _t(inp["t5_mask"])
    with activation_sharding(mesh):
        res["t5"] = _np(tt5.t5_encode(t5_local, CFG.t5, ids, mask))
    res["t5_embedding_rows"] = tuple(t5_local["token_embedding"].shape)

    lap("t5")
    tea = inp["teacache"]
    single, mesh_runs = [], []
    for use_mesh in (False, True):
        state = tdit.init_teacache_state(2, tea["tokens"], CFG.dit.dim,
                                         torch.float32, "cpu")
        outs, flags = [], []
        for i, tv in enumerate(tea["t"]):
            kw = dict(coefficients=(0.0, 0.0, 0.0, 1.0, 0.0),
                      rel_l1_thresh=tea["thresh"], num_skip_start_steps=1,
                      density=d.get("dens"))
            t_in = torch.full((2,), float(tv))
            with (activation_sharding(mesh) if use_mesh else nullcontext()):
                o, state = tdit.dit_forward_teacache(
                    port, CFG.dit, d["x"], t_in, d["ctx"], state, i, **kw)
            outs.append(_np(o))
            flags.append(float(state["computed"]))
        (mesh_runs if use_mesh else single).append((outs, flags))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mesh_runs[0][1])
    res["teacache"] = {"single": single[0], "mesh": mesh_runs[0],
                       "flags_every_rank": every}
    lap("teacache")
    res["errors"] = _errors(mesh)
    lap("errors")
    return res


def ulysses_on_card(shape) -> dict:
    """Ulysses over sp = 2 on ranks that share cuda:0 (gloo through the
    host): the gathered output beside one rank's B1 on the whole q, k, v,
    and this rank's B1 launches in the sharded call
    (`tests/test_torch_cuda.py`)."""
    from flexam_tpu_torch.core.attention import attention
    from flexam_tpu_torch.ops import launch_counts, reset_launch_counts
    dev = torch.device("cuda", 0)
    mesh = make_mesh({"sp": 2}, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    lay = token_layout(mesh, shape[0], shape[1])
    reset_launch_counts()
    out = lay.gather(make_ulysses_attention(mesh)(
        *(lay.shard(t, 0, 1).contiguous() for t in (q, k, v))))
    n = launch_counts()["flash_attention"]
    return {"out": out.float().cpu(), "ref": attention(q, k, v).float().cpu(),
            "launches": n}


def fail_on_rank_one() -> None:
    """Rank 1 raises while rank 0 waits for it at a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()
