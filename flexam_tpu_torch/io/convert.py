"""Parameters carried across from the JAX package.

`from_jax_params` takes a JAX parameter tree as nested dicts (and lists) of
numpy arrays — what `jax.tree_util.tree_map(np.asarray, params)` gives — and
returns the port's tree, so that both packages compute the same thing. Every
layout change between the two lives here:

  * the JAX trees stack the blocks of the DiT and the umT5 encoder on a
    leading num_layers axis (for `lax.scan`); the port keeps a list of
    per-block dicts and loops over it;
  * a "compute_dtype" entry (a numpy/JAX dtype) becomes a torch dtype.

Every other key crosses as it is, the Control-Camera adapter's
`control_adapter.{conv,res_conv1,res_conv2}.{weight,bias}` included.

The generation models' weights are already in torch layout in the JAX
package (Linear [out, in], conv [O, I, *K]), so no transpose is needed.
FLUX stacks its blocks in `double_blocks` / `single_blocks`, CLIP's text
and vision towers in `blocks`: the port keeps lists of them too. The
FLUX / SD VAE (`{"encoder", "decoder"}`, kernels under `w`), the SVD UNet
and the temporal decoder (a top-level `conv_in`, kernels under `weight`)
run NHWC in JAX: their 4-dim kernels become [O, I, kh, kw] and their
5-dim (3, 1, 1) temporal kernels [O, I, 3, 1, 1], for the port's NCHW.
The perception trees (DenseTrack3D: top-level `encoder`, `transformer`,
`upsampler`, `feat_proj`; UniDepth V2: `pixel_encoder`, `pixel_decoder`;
MoGe-2, VGGT and Pi3: an `encoder` holding the DINOv2 `patch_embed`)
keep their blocks in lists already, and hold 2-D convs in XLA's HWIO
layout: every 4-dim `weight` leaf there becomes torch's [O, I, kh, kw],
except UniDepth's ConvTranspose kernels (`process_features`), which JAX
keeps in torch's [cin, cout, k, k], and Depth-Anything-V2's DPT head
(`head` with `refinenet`), whose convs JAX keeps in torch's layout (only
its DINOv2 `encoder` is HWIO). Other 4-dim leaves (VGGT's camera and
register tokens) have one layout in both. ZoeDepth's tree (`patch_embed`,
`blocks`, `act_postprocess`, ... at the top) is torch layout throughout,
its ConvTranspose kernels [I, O, k, k] unflipped, and crosses as it is.
bfloat16 leaves (numpy's ml_dtypes bfloat16) arrive as torch.bfloat16,
float8_e4m3fn leaves (the fp8 storage mode) as torch.float8_e4m3fn
through a uint8 view, keyed on the dtype's name (`torch.from_numpy`
refuses ml_dtypes arrays, and the port never imports ml_dtypes); int8 `weight_q` and float32 `w_scale` leaves of
quantized trees cross as they are. `stack_blocks` is the inverse of the
block unstacking, for files that the JAX package reads; `deploy_dtype` is
JAX's one rule for the dtype a quantized tree's other leaves deploy in.

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
    if torch.is_tensor(a):        # a restored `.npz` leaf (host tensor)
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a.view(np.uint8))).view(
            torch.float8_e4m3fn).to(device)
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


_PERCEPTION_TREES = ({"encoder", "transformer", "upsampler", "feat_proj"},
                     {"pixel_encoder", "pixel_decoder"})


def _perception_tree(tree) -> bool:
    """DenseTrack3D, UniDepth V2, or a model on the DINOv2 encoder (MoGe-2,
    VGGT, Pi3: an `encoder` with a `patch_embed`)."""
    if not isinstance(tree, dict):
        return False
    enc = tree.get("encoder")
    return set(tree) in _PERCEPTION_TREES or (
        isinstance(enc, dict) and "patch_embed" in enc)


def _torch_layout(key: str, node) -> bool:
    """A subtree of a perception tree whose kernels JAX keeps in torch's
    layout: UniDepth's ConvTranspose kernels (`process_features`) and
    Depth-Anything-V2's DPT head (the `head` holding `refinenet`, on
    zoedepth's convs)."""
    return key == "process_features" or (
        key == "head" and isinstance(node, dict) and "refinenet" in node)


def _conv_tree(tree) -> bool:
    """The FLUX / SD VAE (an `encoder` holding `conv_in`), the SVD UNet and
    the temporal decoder (`conv_in` at the top): NHWC models in JAX, whose
    every 4-dim kernel is HWIO and 5-dim kernel DHWIO."""
    if not isinstance(tree, dict):
        return False
    enc = tree.get("encoder")
    return "conv_in" in tree or (isinstance(enc, dict) and "conv_in" in enc)


_STACKED = ("blocks", "double_blocks", "single_blocks")
_CONV_KEYS = {"weight": ("weight",), "conv": ("weight", "w")}


def _convert(node, device, hwio=False, key="", conv=False):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "compute_dtype":
                out[k] = _DTYPES[np.dtype(v).name]
            elif k in _STACKED and isinstance(v, dict):
                out[k] = _unstack(_convert(v, device))
            else:
                out[k] = _convert(v, device, hwio and not _torch_layout(k, v),
                                  k, conv)
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, hwio, key, conv) for v in node]
    if node is None:
        return None
    t = _tensor(node, device)
    if hwio and key in _CONV_KEYS["conv" if conv else "weight"]:
        if t.dim() == 4:                            # HWIO -> [O, I, kh, kw]
            t = t.permute(3, 2, 0, 1).contiguous()
        elif t.dim() == 5 and conv:                 # DHWIO -> [O, I, kd, ...]
            t = t.permute(4, 3, 0, 1, 2).contiguous()
    return t


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


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def map_leaves(tree, fn):
    """A new tree of `fn(key, leaf, in_block)` over the leaves: `key` is the
    leaf's dict key, `in_block` whether it lies under `blocks` (the port's
    per-block list, one dim fewer than JAX's stacked layout)."""
    def visit(key, node, in_block):
        if isinstance(node, dict):
            return {k: visit(k, v, in_block) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(key, v, in_block or key == "blocks") for v in node]
        return fn(key, node, in_block)
    return visit("", tree, False)


def cast_floats(tree, dtype):
    """A new tree with every floating-point leaf cast to `dtype`."""
    return map_leaves(tree, lambda key, t, in_block: (
        t.to(dtype) if t.is_floating_point() else t))


def deploy_dtype(t, key: str, in_block: bool, wide=torch.bfloat16):
    """JAX's deploy cast of a quantized DiT tree (`_put_quantized`,
    `prequant_ckpt._cast_wide_to_bf16`): `wide` for a float32 leaf of two
    or more dims in JAX's stacked layout, except the quantization scales
    (`w_scale`), which stay float32; None for every other leaf."""
    if (t.dtype == torch.float32 and t.dim() + in_block >= 2
            and key != "w_scale"):
        return wide
    return None


def host_tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 and float8 included) or a tensor, as a
    tensor, without a copy where none is needed."""
    return a if torch.is_tensor(a) else _tensor(a, "cpu")


def stack_blocks(tree: dict) -> dict:
    """The port's per-block list stacked on a leading axis (JAX's layout),
    for host trees written to files the JAX package reads."""
    blocks = tree.get("blocks")
    if not isinstance(blocks, list):
        return tree

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {**tree, "blocks": stack(blocks)}


def from_jax_params(tree, device="cuda") -> dict:
    """The port's parameter tree for a JAX parameter tree of numpy arrays
    or host tensors (DiT, umT5, VAE, DenseTrack3D, UniDepth V2, MoGe-2,
    VGGT, Pi3, ZoeDepth, Depth-Anything-V2, FLUX, the FLUX / SD VAE, CLIP
    text and ViT, the SVD UNet or the temporal decoder), on `device`."""
    conv = _conv_tree(tree)
    return _convert(tree, resolve_device(device),
                    conv or _perception_tree(tree), conv=conv)
