"""Width-sharded whole-clip VAE decode and encode.

Port of `flexam_tpu/parallel/vae_parallel.py`, the counterpart of the
reference's closed `parallel_magvit_vae` (`FlexAM/models/__init__.py:
36-38`). JAX constrains the width to the sp axis and GSPMD inserts the
halo exchanges; here they are explicit. Each rank of the axis holds a
contiguous 1/sp of the width through the whole clip (`models/vae.py` with
its `_width_split` set):

  * a convolution of width k > 1 first takes k // 2 columns from each
    neighbour (one all_gather of the edge columns); the clip's two edges
    get the zero padding, and only there;
  * the stride-2 downsample's asymmetric padding (the odd column goes to
    the high end, as JAX's SAME) is the last rank's right halo;
  * patchify, the space-to-channel folds and the nearest upsampling stay
    local (the slices are asserted to align with them);
  * the two mid-block spatial attentions gather the width, attend, and keep
    this rank's columns; the per-pixel RMS norm needs nothing.

Every rank returns the whole result (the width gathered at the end).
"""

from __future__ import annotations

import contextlib

import torch

from flexam_tpu_torch.config import VAEConfig
from flexam_tpu_torch.models import vae as vae_mod
from flexam_tpu_torch.parallel import comm


class WidthSplit:
    """The width slices of one mesh axis (`models/vae.py`'s hook)."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.n = mesh.shape.get(axis, 1)
        self.me = mesh.index(axis)

    def halo(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        """x with `left` columns of the previous rank's right edge and
        `right` of the next rank's left edge (zeros beyond the clip)."""
        w = x.shape[-1]
        if w < max(left, right):
            raise ValueError(f"a width slice of {w} columns cannot lend a "
                             f"halo of {max(left, right)}")
        edges = torch.cat([x[..., :right], x[..., w - left:]], dim=-1)
        every = comm.all_gather_raw(edges[None], self.mesh, self.axis, 0)
        parts = []
        if left:
            parts.append(every[self.me - 1][..., right:] if self.me > 0
                         else x.new_zeros(x.shape[:-1] + (left,)))
        parts.append(x)
        if right:
            parts.append(every[self.me + 1][..., :right]
                         if self.me < self.n - 1
                         else x.new_zeros(x.shape[:-1] + (right,)))
        return torch.cat(parts, dim=-1)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_gather_raw(x, self.mesh, self.axis, -1)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        w = x.shape[-1] // self.n
        return x.narrow(-1, self.me * w, w).contiguous()


@contextlib.contextmanager
def width_split(mesh, axis: str = "sp"):
    """Run `models/vae.py` on this rank's width slice inside the block."""
    prev = vae_mod._width_split
    vae_mod._width_split = WidthSplit(mesh, axis)
    try:
        yield vae_mod._width_split
    finally:
        vae_mod._width_split = prev


def _run(fn, params, cfg, x, mesh, axis, align: int):
    split = WidthSplit(mesh, axis)
    w = x.shape[-1]
    if w % (split.n * align):
        raise ValueError(f"width {w} does not split into {split.n} slices "
                         f"of a multiple of {align} columns")
    with width_split(mesh, axis) as ws:
        out = fn(params, cfg, ws.local(x))
    return ws.whole(out)


@torch.no_grad()
def vae_decode_sharded(params: dict, cfg: VAEConfig, z: torch.Tensor,
                       mesh, seq_axis: str = "sp") -> torch.Tensor:
    """Whole-clip decode with the latent width split over `seq_axis`; z
    [B, C, T', H', W'] (the whole latents on every rank), W' divisible by
    the axis size. Returns the whole video on every rank."""
    return _run(vae_mod.vae_decode, params, cfg, z, mesh, seq_axis, 1)


@torch.no_grad()
def vae_encode_sharded(params: dict, cfg: VAEConfig, x: torch.Tensor,
                       mesh, seq_axis: str = "sp") -> torch.Tensor:
    """Whole-clip deterministic encode (the posterior mode), width split
    over `seq_axis`: each slice a multiple of 16 pixels (the patchify and
    three spatial downsamples). Returns the whole latents on every rank."""
    return _run(vae_mod.vae_encode_mode, params, cfg, x, mesh, seq_axis, 16)
