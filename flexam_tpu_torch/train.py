"""Flow-matching training steps for the FlexAM DiT.

Port of `flexam_tpu/train.py`:

  * `flow_match_loss`: x_sigma = (1 - sigma) x0 + sigma eps, target
    velocity v* = eps - x0, MSE against the DiT's prediction at t =
    1000 sigma;
  * `make_train_state`: `optax.adamw` becomes `torch.optim.AdamW` with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8, moments in the
    parameter's dtype); the two apply the same update (the decay of the
    old parameter scaled by the learning rate, then the bias-corrected
    Adam step);
  * `train_step` / `lora_train_step`: one update. `sigma` and `eps` cross
    as explicit tensors (torch cannot replay `jax.random`); without them
    `generator` draws them, sigma ~ U(1e-4, 1) and eps ~ N(0, 1) as JAX
    draws. The LoRA step trains only the factors through
    `utils.lora.apply_lora`; the base stays bit-identical.

JAX returns a new parameter tree and optimizer state; torch updates the
leaves in place, so `make_train_state` returns the optimizer (which holds
the moments) and the steps return (params, loss).

On the card the DiT's kernels (B1-B6) have no backward, as JAX's Pallas
kernels have none, and refuse autograd (`ops.build.refuse_autograd`):
train with FLEXAM_FUSED=0 FLEXAM_ATTENTION=xla, JAX's own training path
(its unfused composition and `xla_attention`), here torch ops that are
differentiable.

Under `parallel.activation_sharding(mesh)` the steps run each rank's share
(`dit_forward` under a mesh; its collectives are differentiable), then sum
the gradients over the data axes (dp, sp: each rank's gradient covers its
own tokens) and, for the leaves applied per tp share, over tp, before the
update: the step equals the one-device step. `make_train_state(
param_shardings=...)` takes this rank's shards (`parallel.shard_pytree`),
so AdamW's moments are shaped like them, ZeRO-style, as JAX places its
moments with the parameters' shardings.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from flexam_tpu_torch.config import DiTConfig
from flexam_tpu_torch.io.convert import tree_leaves
from flexam_tpu_torch.models.dit import dit_forward

# optax's defaults for adam / adamw
ADAM_DEFAULTS = dict(betas=(0.9, 0.999), eps=1e-8)
# `optax.adamw`'s own default decay (JAX's `make_train_state` passes 1e-2)
OPTAX_ADAMW_DECAY = 1e-4

LearningRate = Union[float, Callable[[int], float]]


def trainable(tree) -> List[torch.Tensor]:
    """The floating-point leaves of a tree, set to require grad."""
    leaves = [t for t in tree_leaves(tree)
              if torch.is_tensor(t) and t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


class Optimizer:
    """A torch optimizer with optax's learning-rate schedule semantics: a
    schedule is called with the count of updates made so far, before each
    update (optax's `scale_by_schedule`). On CUDA the optimizer is
    capturable, its learning rate a device tensor, so that `run_steps`
    can replay a step as a CUDA graph."""

    def __init__(self, opt: torch.optim.Optimizer, lr: LearningRate,
                 shardings: Optional[list] = None):
        self.opt = opt
        self.lr = lr
        self.count = 0
        # [(leaf, parallel.Shard)] of a sharded state (None: replicated)
        self.shardings = shardings

    def sync_grads(self, tp_partial=()) -> None:
        """Under an active mesh, sum the gradients over the mesh (see the
        module docstring; `tp_partial`: leaves whose gradient is a partial
        sum over tp); nothing on one device."""
        from flexam_tpu_torch.parallel.sharding import (REPLICATED,
                                                        active_mesh,
                                                        sync_grads)
        mesh = active_mesh()
        if mesh is not None:
            pairs = self.shardings or [(t, REPLICATED) for t in self.params]
            sync_grads(pairs, mesh, tp_partial=tp_partial)

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]

    def set_lr(self) -> None:
        """The schedule's value for this update."""
        if not callable(self.lr):
            return
        v = float(self.lr(self.count))
        for g in self.opt.param_groups:
            if torch.is_tensor(g["lr"]):
                g["lr"].fill_(v)
            else:
                g["lr"] = v

    def step(self) -> None:
        self.set_lr()
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1


def _torch_opt(cls, params, learning_rate: LearningRate, **kw) -> Optimizer:
    params = list(params)
    lr = float(learning_rate(0)) if callable(learning_rate) \
        else float(learning_rate)
    if params and params[0].is_cuda:
        kw.update(capturable=True, foreach=True)
        lr = torch.tensor(lr, device=params[0].device)
    return Optimizer(cls(params, lr=lr, **ADAM_DEFAULTS, **kw),
                     learning_rate)


def adamw(params: Iterable[torch.Tensor], learning_rate: LearningRate,
          weight_decay: float = OPTAX_ADAMW_DECAY) -> Optimizer:
    """`optax.adamw(learning_rate, weight_decay=...)` over `params`."""
    return _torch_opt(torch.optim.AdamW, params, learning_rate,
                      weight_decay=weight_decay)


def adam(params: Iterable[torch.Tensor],
         learning_rate: LearningRate) -> Optimizer:
    """`optax.adam(learning_rate)` over `params`."""
    return _torch_opt(torch.optim.Adam, params, learning_rate)


def run_steps(opt: Optimizer, num_steps: int, load: Callable[[int], None],
              loss_fn: Callable[[], torch.Tensor],
              warmup: int = 3) -> List[float]:
    """`num_steps` updates of the parameters `opt` holds: `load(i)` writes
    step i's inputs in place into the tensors that `loss_fn()` reads, and
    `loss_fn()` returns the loss. On CUDA the first `warmup` steps run
    eagerly on a side stream, then one step (forward, backward, update) is
    captured as a CUDA graph and replayed for the rest, the counterpart of
    the `jax.jit`-compiled step JAX's trainers run: at small widths a
    step's kernels take less time than launching them one by one from
    Python (control_follow's 3000 DiT steps on an H100 take 111 s eagerly
    and 8 s replayed). The eager branch serves the CPU, where there is no
    graph to capture. Returns the losses, read from the device once at the
    end."""
    losses = []

    def eager(i):
        load(i)
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    if not opt.params[0].is_cuda or num_steps <= warmup:
        for i in range(num_steps):
            eager(i)
        return _floats(losses)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            eager(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    load(warmup)
    opt.set_lr()
    with torch.cuda.graph(graph):
        static_loss = loss_fn()
        static_loss.backward()
        opt.opt.step()
    for i in range(warmup, num_steps):
        if i > warmup:
            load(i)
            opt.set_lr()
        graph.replay()
        opt.count += 1
        losses.append(static_loss.detach().clone())
    return _floats(losses)


def _floats(losses: List[torch.Tensor]) -> List[float]:
    return torch.stack(losses).float().cpu().tolist() if losses else []


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """`optax.cosine_decay_schedule` in closed form: init * ((1 - alpha)
    * (1 + cos(pi * min(n, steps) / steps)) / 2 + alpha)."""
    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                             + alpha)
    return schedule


def flow_match_loss(params, cfg: DiTConfig, batch: Dict, sigma: torch.Tensor,
                    eps: torch.Tensor, rope_tables=None) -> torch.Tensor:
    """batch: {latents [B, C, F, H, W], context, density?, y?,
    additional_control?, full_ref?} as tensors; sigma [B] in (0, 1]."""
    x0 = batch["latents"].float()
    s = sigma.float()[:, None, None, None, None]
    x_sigma = (1.0 - s) * x0 + s * eps
    v_pred = dit_forward(
        params, cfg, x_sigma.to(batch["context"].dtype), sigma * 1000.0,
        batch["context"], density=batch.get("density"), y=batch.get("y"),
        additional_control=batch.get("additional_control"),
        full_ref=batch.get("full_ref"), rope_tables=rope_tables)
    return (v_pred.float() - (eps - x0)).pow(2).mean()


def make_train_state(params, learning_rate: LearningRate = 1e-5,
                     weight_decay: float = 1e-2,
                     param_shardings=None) -> Optimizer:
    """AdamW over every floating-point leaf of `params` (set to require
    grad), JAX's `make_train_state` defaults. With `param_shardings` (the
    tree of `parallel.Shard`s `params` was cut by) `params` are this rank's
    shards: the moments take their shapes, and the steps sum each
    gradient over the mesh by its leaf's sharding."""
    opt = adamw(trainable(params), learning_rate, weight_decay)
    if param_shardings is not None:
        from flexam_tpu_torch.parallel.sharding import spec_leaves
        opt.shardings = [(t, sp) for t, sp in
                         spec_leaves(params, param_shardings)
                         if t.is_floating_point()]
    return opt


def draw_noise(latents: torch.Tensor,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma [B] ~ U(1e-4, 1), eps ~ N(0, 1) of the latents' shape),
    float32 on the latents' device, drawn from `generator`."""
    b = latents.shape[0]
    dev = latents.device
    sigma = 1e-4 + (1.0 - 1e-4) * torch.rand((b,), generator=generator,
                                             device=dev)
    eps = torch.randn(latents.shape, generator=generator, device=dev)
    return sigma, eps


def _noise(batch, sigma, eps, generator):
    if sigma is None or eps is None:
        ds, de = draw_noise(batch["latents"], generator)
        sigma = ds if sigma is None else sigma
        eps = de if eps is None else eps
    return sigma, eps


def train_step(params, opt: Optimizer, cfg: DiTConfig, batch: Dict,
               sigma: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               rope_tables=None) -> Tuple[dict, torch.Tensor]:
    """One flow-matching update of every leaf `opt` holds; returns
    (params, the loss before the update)."""
    sigma, eps = _noise(batch, sigma, eps, generator)
    loss = flow_match_loss(params, cfg, batch, sigma, eps, rope_tables)
    loss.backward()
    opt.sync_grads()
    opt.step()
    return params, loss.detach()


def lora_train_step(base_params, lora_params, opt: Optimizer,
                    cfg: DiTConfig, batch: Dict,
                    sigma: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    rope_tables=None, multiplier: float = 1.0
                    ) -> Tuple[dict, torch.Tensor]:
    """LoRA update: the base DiT stays frozen, gradients flow only through
    the low-rank factors via `utils.lora.apply_lora` (the train-side
    `LoRANetwork`, reference `lora_utils.py:158-370`). Build `opt` over
    the factors: `adamw(trainable(lora_params["blocks"]), lr)`. Returns
    (lora_params, loss)."""
    from flexam_tpu_torch.utils.lora import apply_lora, tp_split_factors

    sigma, eps = _noise(batch, sigma, eps, generator)
    p = apply_lora(base_params, lora_params, multiplier=multiplier)
    loss = flow_match_loss(p, cfg, batch, sigma, eps, rope_tables)
    del p
    loss.backward()
    # where the base weight is split, each tp rank applies its slice of the
    # factors' product: those factors' gradients are summed over tp too
    opt.sync_grads(tp_partial=tp_split_factors(base_params, lora_params))
    opt.step()
    return lora_params, loss.detach()


def batch_to(batch: Dict, device, dtype=torch.float32) -> Dict:
    """A batch of numpy arrays or tensors as float tensors on `device`
    (`dtype` for every float leaf)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v).to(device)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out
