"""Parameters carried across from the JAX package.

`from_jax_params` takes a JAX parameter tree as nested dicts (and lists) of
numpy arrays — what `jax.tree_util.tree_map(np.asarray, params)` gives — and
returns the port's tree, so that both packages compute the same thing. Every
layout change between the two lives here:

  * the JAX trees stack the blocks of the DiT and the umT5 encoder on a
    leading num_layers axis (for `lax.scan`); the port keeps a list of
    per-block dicts and loops over it;
  * a "compute_dtype" entry (a numpy/JAX dtype) becomes a torch dtype.

Weights are already in torch layout in the JAX package (Linear [out, in],
conv [O, I, *K]), so no transpose is needed. bfloat16 leaves (numpy's
ml_dtypes bfloat16) arrive as torch.bfloat16.

The checkpoint loaders (`io/checkpoints.py`, `models/t5.py`) build their
trees with the per-block lists already in place and convert each leaf
through `leaf`, the one conversion both paths share.
"""

from __future__ import annotations

import numpy as np
import torch

from flexam_tpu_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def leaf(a, device, dtype=None, then=None) -> torch.Tensor:
    """One leaf on `device`: a torch tensor or a numpy array (bfloat16
    included), cast to `dtype` (JAX's `np.asarray(a, dtype)`) and then to
    `then` (a second cast, as the demo's bf16 cast after a float32 load).
    The cast runs on the device, after the copy, so a host tensor is never
    widened on the host."""
    t = a if torch.is_tensor(a) else _tensor(a, "cpu")
    t = t.to(device, copy=True)
    if dtype is not None:
        t = t.to(dtype)
    if then is not None:
        t = t.to(then)
    return t


def _convert(node, device):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "compute_dtype":
                out[k] = _DTYPES[np.dtype(v).name]
            elif k == "blocks" and isinstance(v, dict):
                out[k] = _unstack(_convert(v, device))
            else:
                out[k] = _convert(v, device)
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    if node is None:
        return None
    return _tensor(node, device)


def _unstack(tree):
    """A dict of [num_layers, ...] tensors -> a list of per-layer dicts."""
    leaves = []

    def first(t):
        if isinstance(t, dict):
            for v in t.values():
                first(v)
        else:
            leaves.append(t)

    first(tree)
    n = leaves[0].shape[0]

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    return [pick(tree, i) for i in range(n)]


def from_jax_params(tree, device="cuda") -> dict:
    """The port's parameter tree for a JAX parameter tree of numpy arrays
    (DiT, umT5 or VAE), on `device`."""
    return _convert(tree, resolve_device(device))
