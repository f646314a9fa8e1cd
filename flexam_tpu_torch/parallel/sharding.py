"""The mesh, the token layout and the parameter shardings.

Port of `flexam_tpu/parallel/sharding.py`. JAX's mesh is one object over
global arrays; here a `Mesh` is this rank's view of a process grid: the
axis sizes (("dp", "sp", "tp") by default, any names in order), this
rank's coordinate on each axis and one process group an axis (the ranks
that differ only along it). Ranks are laid out row-major over the axes,
as `np.reshape` lays JAX's devices.

  * `make_mesh` builds it over an initialised process group (or initialises
    one from torchrun's environment); NCCL on CUDA, gloo on the CPU. Ranks
    that share one card run gloo (NCCL refuses two ranks on one device),
    and then every collective goes through the host (`comm.py`).
  * `activation_sharding(mesh)` installs the mesh that `dit_forward`,
    `t5_encode` and the training steps consult, as JAX's installs the mesh
    of its `token_constraint`.
  * `Layout` is `token_constraint`'s counterpart: which axis splits the
    batch and which split the tokens (contiguous slices, the first axis
    major), the slicing of a rank's share and the gather back.
  * `dit_param_shardings` / `t5_param_shardings` / `replicated_shardings`
    give a `Shard` a leaf with JAX's rules, and `shard_pytree` takes this
    rank's slice of each leaf. The port keeps the DiT blocks as a list of
    per-block dicts, so a spec's `dim` counts a block leaf's own dims (JAX's
    stacked [L, out, in] weight split on out is `Shard(0, "tp")` here).
  * `tp_row` is the row-split linear (int8 linears included; a
    column-split linear is a plain linear on the slice, its input through
    `comm.copy_to`), and `sync_grads` sums the gradients of a sharded
    step.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.parallel import comm

DEFAULT_AXES = ("dp", "sp", "tp")

_ACTIVE_MESH: Optional["Mesh"] = None


class Mesh:
    """This rank's view of the process grid (see the module docstring).
    `shape` maps axis -> size as JAX's `mesh.shape` does."""

    def __init__(self, sizes: Dict[str, int], device: torch.device,
                 backend: str):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.size = math.prod(sizes.values())
        self.rank = dist.get_rank()
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, the "
                             f"process group has {dist.get_world_size()}")
        self.device = device
        self.backend = backend
        self.host_staging = backend == "gloo" and device.type == "cuda"
        coords, r = {}, self.rank
        for name in reversed(self.axis_names):
            coords[name] = r % sizes[name]
            r //= sizes[name]
        self.coords = {n: coords[n] for n in self.axis_names}
        self._groups, self._ranks = {}, {}
        for axis in self.axis_names:
            if sizes[axis] == 1:
                continue
            lists = self._enumerate(axis)
            groups = [dist.new_group(ranks) for ranks in lists]
            for ranks, g in zip(lists, groups):
                if self.rank in ranks:
                    self._groups[axis], self._ranks[axis] = g, ranks

    def _enumerate(self, axis: str):
        """The rank lists of the axis's groups, each in axis order."""
        names = self.axis_names
        strides, s = {}, 1
        for n in reversed(names):
            strides[n] = s
            s *= self.shape[n]
        out = []
        for r in range(self.size):
            if (r // strides[axis]) % self.shape[axis] == 0:
                out.append([r + i * strides[axis]
                            for i in range(self.shape[axis])])
        return out

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_ranks(self, axis: str):
        """Global ranks of this rank's group on the axis, in axis order."""
        return self._ranks.get(axis, [self.rank])

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, {self.backend})"


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """A `Mesh` over the process group. Default: every rank on sp. A dict
    of only dp / sp / tp takes JAX's axis order ("dp", "sp", "tp"), missing
    axes of size 1; any other dict keeps its own order (the USP mesh
    {"dp", "ring", "sp"}). Without an initialised process group one is
    initialised from torchrun's environment (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE). `backend`: NCCL on CUDA and gloo on the CPU unless
    given; with gloo on CUDA every collective goes through the host.
    Raises where the device is CUDA and there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://", timeout=timedelta(minutes=10))
    backend = dist.get_backend()
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"dp": 1, "sp": n, "tp": 1}
    if set(axis_sizes) <= set(DEFAULT_AXES):
        axis_sizes = {a: int(axis_sizes.get(a, 1)) for a in DEFAULT_AXES}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dict(axis_sizes), dev, backend)


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install the mesh that the model code consults."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def clear_mesh() -> None:
    set_mesh(None)


def active_mesh() -> Optional[Mesh]:
    """The installed mesh if it spans more than one rank, else None."""
    m = _ACTIVE_MESH
    return m if m is not None and m.size > 1 else None


@contextlib.contextmanager
def activation_sharding(mesh: Mesh):
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        clear_mesh()


# ---------------------------------------------------------------------------
# Token layout
# ---------------------------------------------------------------------------

class Layout:
    """How a [B, L, ...] activation is split on the mesh: the batch over
    `batch_axis` (None: every rank holds the whole batch) and the tokens
    over `token_axes` jointly, the first axis major (() : whole). A rank
    holds one contiguous token slice. Axes that split neither (tp aside)
    hold copies; `gather` scales the gradient it hands back by 1 / their
    size, so that summing the gradients over every data axis
    (`sync_grads`) counts each copy once."""

    def __init__(self, mesh: Mesh, batch_axis: Optional[str],
                 token_axes: Tuple[str, ...]):
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.token_axes = tuple(token_axes)
        self.token_ways = math.prod(mesh.shape[a] for a in self.token_axes)
        self.batch_ways = mesh.shape[batch_axis] if batch_axis else 1
        used = set(self.token_axes) | {batch_axis}
        self.copies = math.prod(s for a, s in mesh.shape.items()
                                if a not in used and a != "tp")

    def token_index(self) -> int:
        i = 0
        for a in self.token_axes:
            i = i * self.mesh.shape[a] + self.mesh.index(a)
        return i

    def token_range(self, n: int) -> Tuple[int, int]:
        """(start, count) of this rank's tokens of n."""
        size = n // self.token_ways
        return self.token_index() * size, size

    def batch_range(self, b: int) -> Tuple[int, int]:
        size = b // self.batch_ways
        return (self.mesh.index(self.batch_axis) * size if self.batch_axis
                else 0), size

    def shard(self, x: torch.Tensor, batch_dim: Optional[int] = 0,
              token_dim: Optional[int] = None) -> torch.Tensor:
        """This rank's slice of x (a view)."""
        if batch_dim is not None and self.batch_axis:
            s, n = self.batch_range(x.shape[batch_dim])
            x = x.narrow(batch_dim, s, n)
        if token_dim is not None and self.token_axes:
            s, n = self.token_range(x.shape[token_dim])
            x = x.narrow(token_dim, s, n)
        return x

    def gather(self, x: torch.Tensor, batch_dim: int = 0,
               token_dim: int = 1) -> torch.Tensor:
        """The whole tensor on every rank, for a consumer every rank runs
        alike (differentiable: see the class docstring)."""
        x = comm.scale_grad(x, 1.0 / self.copies)
        for a in reversed(self.token_axes):
            x = comm.gather_replicated(x, self.mesh, a, token_dim)
        if self.batch_axis:
            x = comm.gather_replicated(x, self.mesh, self.batch_axis,
                                       batch_dim)
        return x


def token_layout(mesh: Mesh, batch: int, seq_len: int,
                 token_axes: Sequence[str] = ("sp",)) -> Layout:
    """The layout JAX's token_constraint(("dp", "sp", None)) asks for, where
    the shapes divide: the batch over dp if dp divides it (the CFG-skip
    tail's batch of 1 under dp = 2 stays whole), the tokens over
    `token_axes` if their product divides seq_len, else whole."""
    dp = mesh.shape.get("dp", 1)
    baxis = "dp" if dp > 1 and batch % dp == 0 else None
    axes = tuple(a for a in token_axes if mesh.shape.get(a, 1) > 1)
    if seq_len % math.prod(mesh.shape[a] for a in axes):
        axes = ()
    return Layout(mesh, baxis, axes)


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Shard:
    """Where one leaf lives: split along `dim` over `axis`, or replicated
    (axis None). `tp_partial`: a replicated leaf that each tp rank applies
    to its own share of the heads, so its gradient is a partial sum over
    tp (the q / k RMSNorm gains after the gather over tp)."""
    dim: Optional[int] = None
    axis: Optional[str] = None
    tp_partial: bool = False


REPLICATED = Shard()
_COL_SPLIT = ("q", "k", "v", "fc1")      # tp splits the out dim
_ROW_SPLIT = ("o", "fc2")                # tp splits the in (contraction)


def _map_with_path(fn, tree):
    def visit(path, node):
        if isinstance(node, dict):
            return {k: visit(f"{path}/{k}" if path else k, v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [visit(f"{path}/{i}", v) for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        return fn(path, node)
    return visit("", tree)


def dit_param_shardings(mesh: Mesh, params) -> dict:
    """Megatron-style tp over the DiT block weights (JAX's rules): q / k /
    v / fc1 split the out dim, o / fc2 the in dim. int8 trees: `weight_q`
    follows `weight`; `w_scale` follows the out dim of a column-split
    linear and is replicated for a row-split one (every tp rank needs every
    output channel's scale to dequantize its partial sums). Everything else
    is replicated."""
    def rule(path: str, leaf):
        if re.search(r"blocks.*(self_attn|cross_attn|ffn)", path):
            parts = path.split("/")
            parent, name = (parts[-2], parts[-1]) if len(parts) >= 2 \
                else ("", parts[-1])
            if name in ("weight", "weight_q"):
                if parent in _COL_SPLIT:
                    return Shard(0, "tp")
                if parent in _ROW_SPLIT:
                    return Shard(1, "tp")
            if name in ("w_scale", "bias") and parent in _COL_SPLIT:
                return Shard(0, "tp")
            if name in ("norm_q", "norm_k"):
                return Shard(tp_partial=True)
        return REPLICATED

    return _map_with_path(rule, params)


def t5_param_shardings(mesh: Mesh, params) -> dict:
    """umT5: tp over the attention heads and the ffn, the token embedding
    split over vocabulary rows (JAX's rules)."""
    def rule(path: str, leaf):
        if path.endswith(("attn/q", "attn/k", "attn/v", "ffn/gate",
                          "ffn/fc1")):
            return Shard(0, "tp")
        if path.endswith(("attn/o", "ffn/fc2")):
            return Shard(1, "tp")
        if path.endswith("token_embedding"):
            return Shard(0, "tp")
        return REPLICATED

    return _map_with_path(rule, params)


def replicated_shardings(mesh: Mesh, params) -> dict:
    return _map_with_path(lambda p, l: REPLICATED, params)


def shard_leaf(t, spec: Shard, mesh: Mesh):
    """This rank's slice of one leaf (contiguous), on the mesh's device."""
    if torch.is_tensor(t):
        if spec.axis is not None and mesh.shape.get(spec.axis, 1) > 1:
            n = mesh.shape[spec.axis]
            if t.shape[spec.dim] % n:
                raise ValueError(f"a leaf of shape {tuple(t.shape)} does "
                                 f"not split over {spec.axis}={n} along "
                                 f"dim {spec.dim}")
            size = t.shape[spec.dim] // n
            t = t.narrow(spec.dim, mesh.index(spec.axis) * size, size)
        return t.to(mesh.device).contiguous()
    return t


def shard_pytree(params, shardings, mesh: Optional[Mesh] = None):
    """This rank's slice of every leaf of `params` under the matching tree
    of `Shard`s (JAX's device_put of a NamedSharding tree)."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        raise ValueError("shard_pytree needs a mesh (pass one or install it "
                         "with activation_sharding)")

    def visit(node, spec):
        if isinstance(node, dict):
            return {k: visit(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [visit(v, s) for v, s in zip(node, spec)]
            return type(node)(out) if isinstance(node, tuple) else out
        return shard_leaf(node, spec, mesh)
    return visit(params, shardings)


def spec_leaves(params, shardings) -> list:
    """[(leaf, Shard)] in the tree's order, for the tensor leaves."""
    out = []

    def visit(node, spec):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, spec[k])
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                visit(v, s)
        elif torch.is_tensor(node):
            out.append((node, spec))
    visit(params, shardings)
    return out


# ---------------------------------------------------------------------------
# tp linears
# ---------------------------------------------------------------------------

def tp_row(x: torch.Tensor, p: dict, mesh: Mesh) -> torch.Tensor:
    """A row-split linear: this rank's input columns, the partial products
    summed over tp, then the (replicated) bias. An int8 linear quantizes
    its input with the amax over the whole input width (the maximum over
    tp), as one device would, and dequantizes its int32 partial sums
    before the sum."""
    if "weight_q" in p:
        from flexam_tpu_torch.ops.qlinear import qlinear_partial
        amax = x.reshape(-1, x.shape[-1]).float().abs().amax(dim=-1,
                                                             keepdim=True)
        amax = comm.all_reduce_raw(amax, mesh, "tp", dist.ReduceOp.MAX)
        y = qlinear_partial(x, p, amax)
    else:
        y = torch.matmul(x, p["weight"].to(x.dtype).t())
    y = comm.reduce_from(y, mesh, "tp")
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y.to(x.dtype)


def tp_heads(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """This tp rank's share of the heads (dim `dim`) of a whole-width
    tensor, contiguous."""
    n = mesh.shape.get("tp", 1)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index("tp") * size, size).contiguous()


def tp_slice_like(full: torch.Tensor, shard: torch.Tensor,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """This tp rank's slice of a whole [out, in] weight-shaped tensor, cut
    where `shard` is cut (rows for a column split, columns for a row
    split); `full` itself where the shapes agree."""
    if full.shape == shard.shape:
        return full
    if mesh is None:
        raise ValueError(f"a whole {tuple(full.shape)} tensor against a "
                         f"{tuple(shard.shape)} shard needs an active mesh")
    for dim in range(full.dim()):
        if full.shape[dim] != shard.shape[dim]:
            size = shard.shape[dim]
            return full.narrow(dim, mesh.index("tp") * size, size)
    return full


# ---------------------------------------------------------------------------
# Gradients of a sharded step
# ---------------------------------------------------------------------------

def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The axes that split the data (every axis but tp)."""
    return tuple(a for a in mesh.axis_names
                 if a != "tp" and mesh.shape[a] > 1)


def sync_grads(pairs, mesh: Mesh, tp_partial=()) -> None:
    """Sum each leaf's gradient over the data axes, and over tp for the
    leaves whose gradient is a partial sum there (`Shard.tp_partial`, or
    a leaf in `tp_partial`: a LoRA factor that each tp rank applies to its
    own slice of a split weight). `pairs`: [(leaf, Shard)]."""
    extra = {id(t) for t in tp_partial}
    grads = [(t.grad, s.tp_partial or id(t) in extra) for t, s in pairs
             if t.grad is not None]
    for axis in data_axes(mesh):
        comm.all_reduce_into([g for g, _ in grads], mesh, axis)
    if mesh.shape.get("tp", 1) > 1:
        comm.all_reduce_into([g for g, partial in grads if partial], mesh,
                             "tp")


def gather_pytree(params, shardings, mesh: Mesh):
    """The whole leaves of a sharded tree on every rank (the inverse of
    `shard_pytree`): each split leaf gathered over its axis."""
    def visit(node, spec):
        if isinstance(node, dict):
            return {k: visit(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [visit(v, s) for v, s in zip(node, spec)]
            return type(node)(out) if isinstance(node, tuple) else out
        if torch.is_tensor(node) and spec.axis is not None:
            return comm.all_gather_raw(node.detach(), mesh, spec.axis,
                                       spec.dim)
        return node
    return visit(params, shardings)
