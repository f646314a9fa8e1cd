"""Ulysses sequence-parallel attention.

Port of `flexam_tpu/parallel/ulysses.py`: the reference's xDiT design
(`xFuserLongContextAttention`, `wan_transformer3d_FlexAM.py:22-24,
801-815`). Each rank holds its token slice [B, L/sp, H, D]; two tiled
`all_to_all`s over sp swap sequence for heads, so that the inner attention
sees the full sequence with H/sp heads ([B, L, H/sp, D], contiguous, as the
kernels B1 / B5 / B6 take it), and swap back.

Cross-attention (keys of another length: the text tokens, replicated) runs
locally against the whole keys. Heads that sp does not divide gather the
sequence instead (all_gather over sp, the inner attention on every head,
this rank's queries kept). All of it is differentiable (`comm.py`).

A mesh attention takes and returns this rank's LOCAL token slice: a call
with as many keys as local queries is self-attention. `token_axes` names
the axes its token slices run over (the DiT lays its tokens out so).
"""

from __future__ import annotations

from typing import Callable, Optional

from flexam_tpu_torch.core.attention import attention as default_attention
from flexam_tpu_torch.parallel import comm


class MeshAttention:
    """An attention over local token slices of a mesh. `inner` is the
    single-rank attention it runs on each rank's share."""

    token_axes = ("sp",)

    def __init__(self, mesh, inner: Callable, batch_axis: Optional[str]):
        self.mesh = mesh
        self.inner = inner
        self.batch_axis = batch_axis

    def __call__(self, q, k, v, k_len=None, scale=None):
        raise NotImplementedError


class UlyssesAttention(MeshAttention):
    def __init__(self, mesh, seq_axis: str = "sp",
                 batch_axis: Optional[str] = "dp",
                 inner: Callable = default_attention):
        super().__init__(mesh, inner, batch_axis)
        self.seq_axis = seq_axis
        self.token_axes = (seq_axis,)
        self.sp = mesh.shape.get(seq_axis, 1)

    def __call__(self, q, k, v, k_len=None, scale=None):
        sp, ax, mesh = self.sp, self.seq_axis, self.mesh
        if sp == 1 or q.shape[1] != k.shape[1]:
            # one rank on the axis, or cross-attention: local
            return self.inner(q, k, v, k_len=k_len, scale=scale)
        h = q.shape[2]
        if h % sp == 0:
            # [B, L/sp, H, D] -> [B, L, H/sp, D]
            qh, kh, vh = (comm.all_to_all(t, mesh, ax, 2, 1)
                          for t in (q, k, v))
            o = self.inner(qh, kh, vh, k_len=k_len, scale=scale)
            # back: [B, L, H/sp, D] -> [B, L/sp, H, D]
            return comm.all_to_all(o, mesh, ax, 1, 2)
        # heads sp does not divide: the whole sequence on every rank
        qf, kf, vf = (comm.gather(t, mesh, ax, 1) for t in (q, k, v))
        o = self.inner(qf, kf, vf, k_len=k_len, scale=scale)
        n = q.shape[1]
        return o.narrow(1, mesh.index(ax) * n, n).contiguous()


def make_ulysses_attention(mesh, seq_axis: str = "sp",
                           batch_axis: Optional[str] = "dp",
                           inner: Callable = default_attention
                           ) -> UlyssesAttention:
    """attn_fn(q, k, v, k_len=None, scale=None) over local token slices
    [B/dp, L/sp, H, D] (see the module docstring). `inner` may be the
    block-sparse closure (`make_sparse_attn_fn`): it sees the full sequence,
    so B5 runs unchanged on each rank's heads; its non-video calls go to
    the dense dispatch."""
    return UlyssesAttention(mesh, seq_axis, batch_axis, inner)


def mesh_attention(mesh, attn_fn: Callable) -> MeshAttention:
    """attn_fn as a mesh attention: a `MeshAttention` as it is, any other
    attention as the inner of Ulysses over sp (cached per mesh and
    function)."""
    if isinstance(attn_fn, MeshAttention):
        return attn_fn
    cache = mesh.__dict__.setdefault("_ulysses_cache", {})
    key = id(attn_fn)
    if key not in cache:
        cache[key] = (attn_fn, make_ulysses_attention(mesh, inner=attn_fn))
    return cache[key][1]

