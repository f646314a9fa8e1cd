"""The collectives of the mesh, raw and differentiable.

Every collective takes a mesh axis (`Mesh.group(axis)`); an axis of size 1
is no collective at all. Where the mesh runs gloo over CUDA tensors (ranks
that share one card, where NCCL refuses two ranks on one device), the data
is staged through the host: gloo moves CPU tensors only. Data movement
(all_gather, all_to_all, the ring hop) moves bf16 as its bytes;
sums of bf16 run in float32 and are rounded once, as one device's matmul
would round its float32 accumulator.

The autograd functions are the pairs that training needs (Megatron's f
and g, and the gathers): a plain `dist` call carries no gradient.

  copy_to(x, axis)        identity; backward sums the gradient over axis
  reduce_from(x, axis)    sum over axis; backward identity
  gather(x, axis, dim)    all_gather along dim; backward sums the gradient
                          over axis and keeps this rank's chunk (the
                          consumer runs on every rank of the axis and each
                          uses a different part of the result)
  gather_replicated(...)  all_gather along dim; backward keeps this rank's
                          chunk of the gradient (the consumer is the same
                          computation on every rank)
  scale_grad(x, s)        identity; backward scales the gradient by s
  all_to_all(x, axis, split_dim, concat_dim)
                          the tiled all_to_all; backward is the reverse
  ring_shift(x, axis)     x of the previous rank (i sends to i + 1 mod n);
                          backward sends the gradient the other way
                          (i to i - 1 mod n), the transpose of ppermute
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _host(mesh, t: torch.Tensor) -> torch.Tensor:
    """t where the backend can move it (the host under gloo + CUDA)."""
    return t.cpu() if (mesh.host_staging and t.is_cuda) else t


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit float as its bytes (a contiguous tensor, the last dim twice
    as long): gloo moves bytes in every version (torch 2.11's gloo refuses
    int16 in all_to_all); reductions never see it."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def _unbits(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------

def all_gather_raw(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Concatenate every rank's x of the axis along `dim`, in axis order."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    xs = _bits(_host(mesh, x.contiguous()))
    parts = [torch.empty_like(xs) for _ in range(n)]
    dist.all_gather(parts, xs, group=mesh.group(axis))
    out = torch.cat([_unbits(p, x.dtype) for p in parts], dim=dim)
    return out.to(x.device)


def all_reduce_raw(x: torch.Tensor, mesh, axis: str,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or `op`) of x over the axis, a new tensor of x's dtype."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    # a new buffer (float32 for 16-bit floats), never x itself
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = _host(mesh, x.float() if wide else x)
    if buf.data_ptr() == x.data_ptr() or not buf.is_contiguous():
        buf = buf.contiguous().clone()
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return buf.to(device=x.device, dtype=x.dtype)


def all_reduce_into(tensors: List[torch.Tensor], mesh, axis: str) -> None:
    """Sum each tensor over the axis in place, one flat buffer per dtype."""
    if mesh.shape.get(axis, 1) == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).float() for t in ts])
        flat = _host(mesh, flat)
        dist.all_reduce(flat, group=mesh.group(axis))
        flat = flat.to(ts[0].device)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_to_all_raw(x: torch.Tensor, mesh, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """The tiled all_to_all of `jax.lax.all_to_all(..., tiled=True)`: x is
    cut into n chunks along split_dim, chunk j goes to rank j of the axis,
    and the n received chunks are concatenated along concat_dim in rank
    order. The result is contiguous."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {axis}={n}")
    # the chunks as a leading dim [n, ...] (split_dim cut to 1/n), chunk j
    # for rank j
    xs = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    send = _bits(_host(mesh, xs.movedim(split_dim, 0).contiguous()))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    recv = _unbits(recv, x.dtype).to(x.device)
    # chunk i came from rank i: it goes i-th along concat_dim
    out = recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)
    return out.contiguous()


def ring_shift_raw(x: torch.Tensor, mesh, axis: str,
                   step: int = 1) -> torch.Tensor:
    """x of the rank `step` places back on the axis (rank i sends to
    i + step mod n): `lax.ppermute` with the permutation
    [(i, i + step mod n)]. One `batch_isend_irecv` a hop."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    me = mesh.index(axis)
    ranks = mesh.axis_ranks(axis)
    send = _bits(_host(mesh, x.contiguous()))
    recv = torch.empty_like(send)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, send, ranks[(me + step) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(me - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unbits(recv, x.dtype).to(x.device)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

def _chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.shape.get(axis, 1)
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, grad_sum):
        ctx.mesh, ctx.axis, ctx.dim, ctx.grad_sum = mesh, axis, dim, grad_sum
        return all_gather_raw(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = all_reduce_raw(g, ctx.mesh, ctx.axis)
        g = _chunk(g, ctx.mesh, ctx.axis, ctx.dim)
        return g.contiguous(), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all_raw(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (all_to_all_raw(g, mesh, axis, concat_dim, split_dim),
                None, None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return ring_shift_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return ring_shift_raw(g, ctx.mesh, ctx.axis, step=-1), None, None


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh.shape.get(axis, 1) == 1


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's f: identity forward, gradient summed over the axis."""
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's g: the sum over the axis, gradient passed through."""
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """all_gather along dim; the backward sums over the axis and keeps this
    rank's chunk (reduce-scatter)."""
    if _trivial(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), True)


def gather_replicated(x: torch.Tensor, mesh, axis: str,
                      dim: int) -> torch.Tensor:
    """all_gather along dim for a consumer that every rank of the axis runs
    alike (the loss on the gathered output): the backward keeps this rank's
    chunk of the gradient."""
    if _trivial(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), False)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """x, whose gradient is scaled by s on the way back."""
    return x if s == 1.0 else _Scale.apply(x, s)


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all_to_all, differentiable; the result is contiguous."""
    if _trivial(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x of the previous rank of the axis, differentiable: the gradient
    goes back to the rank that sent x."""
    if _trivial(mesh, axis):
        return x
    return _RingShift.apply(x, mesh, axis)
