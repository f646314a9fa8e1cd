"""USP: Ulysses x ring hybrid sequence parallelism.

Port of `flexam_tpu/parallel/usp.py` (the reference's `ulysses_degree x
ring_degree`, `ui/controller.py:63,89-95`). Tokens are split over the ring
and Ulysses axes jointly, ring-major: rank (r, u) holds the slice
r * L/R + u * L/(R U), so the U ranks of one ring position hold one
contiguous L/R slice between them. Self-attention:

  [B, L/(R U), H, D]
    -- all_to_all over ulysses (heads <-> sequence) --> [B, L/R, H/U, D]
    -- ring_accumulate over the ring (key/value hops, online softmax) -->
    -- all_to_all back --> [B, L/(R U), H, D]

With a ring of 1 the inner attention runs where the ring would (B1, or
B6 from 23,296 tokens). `sparse`: a `video_sparse_policy` dict; video
self-attention then applies the block mask through the ring, each hop the
sub-mask between this rank's queries and the hop's keys (masked torch
ops, as JAX's is XLA code). The hops carry gradients (`comm.ring_shift`).
"""

from __future__ import annotations

from typing import Callable, Optional

from flexam_tpu_torch.core.attention import attention as default_attention
from flexam_tpu_torch.ops.sparse_attention import rows_to_block_mask
from flexam_tpu_torch.parallel import comm
from flexam_tpu_torch.parallel.ring import ring_accumulate
from flexam_tpu_torch.parallel.ulysses import MeshAttention


class USPAttention(MeshAttention):
    def __init__(self, mesh, ulysses_axis: str = "sp",
                 ring_axis: str = "ring", batch_axis: Optional[str] = "dp",
                 inner: Callable = default_attention,
                 sparse: Optional[dict] = None):
        super().__init__(mesh, inner, batch_axis)
        self.u_axis, self.r_axis = ulysses_axis, ring_axis
        self.u = mesh.shape.get(ulysses_axis, 1)
        self.r = mesh.shape.get(ring_axis, 1)
        self.token_axes = (ring_axis, ulysses_axis)
        self.sparse = sparse
        self.block_mask = None
        if sparse is not None:
            if (sparse["video_len"] % (self.r * sparse["blk"]) != 0
                    or len(sparse["rows"]) % self.r != 0):
                raise ValueError(
                    f"sparse policy does not tile the ring: video_len="
                    f"{sparse['video_len']}, blk={sparse['blk']}, "
                    f"nb={len(sparse['rows'])}, ring={self.r}")
            self.block_mask = rows_to_block_mask(sparse["rows"])

    def __call__(self, q, k, v, k_len=None, scale=None):
        s = float(scale) if scale is not None else q.shape[-1] ** -0.5
        if q.shape[1] != k.shape[1]:
            # cross-attention: the keys are replicated, the queries local
            return self.inner(q, k, v, k_len=k_len, scale=s)
        h = q.shape[2]
        assert h % self.u == 0, (h, self.u)
        sparse_here = (self.block_mask is not None and k_len is None and
                       q.shape[1] * self.r * self.u == self.sparse["video_len"])
        mesh, ua = self.mesh, self.u_axis
        if self.u > 1:
            q, k, v = (comm.all_to_all(t, mesh, ua, 2, 1) for t in (q, k, v))
        if self.r > 1:
            o = ring_accumulate(
                q, k, v, mesh, self.r_axis, s,
                block_mask=self.block_mask if sparse_here else None,
                blk=self.sparse["blk"] if sparse_here else 0)
        else:
            o = self.inner(q, k, v, k_len=k_len, scale=s)
        if self.u > 1:
            o = comm.all_to_all(o, mesh, ua, 1, 2)
        return o


def make_usp_attention(mesh, ulysses_axis: str = "sp",
                       ring_axis: str = "ring",
                       batch_axis: Optional[str] = "dp",
                       inner: Callable = default_attention,
                       sparse: Optional[dict] = None) -> USPAttention:
    """attn_fn(q, k, v, k_len=None, scale=None) over local token slices,
    tokens split over ring_axis x ulysses_axis (ring-major). The heads must
    divide by the Ulysses degree. Raises ValueError where the sparse policy
    does not tile the ring (JAX's check)."""
    return USPAttention(mesh, ulysses_axis, ring_axis, batch_axis, inner,
                        sparse)
