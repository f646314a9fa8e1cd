"""Checkpoint loading: reference state dicts -> the port's parameter trees.

Port of `flexam_tpu/io/checkpoints.py`. The reference loads the VAE from a
raw `.pth` (keys re-prefixed with `model.`) and the DiT from multi-file
safetensors with the patch embedding's input channels zero-padded; the
mapping is an explicit table from torch module paths to tree paths, the
same as JAX's.

What differs from the JAX loader:
  * the trees come out in the port's layout (per-block lists, not stacked
    on a leading axis) and on `device`, leaf by leaf, through
    `io/convert.py`'s `leaf`: a 5B DiT never exists as float32 on the
    host. `matrix_dtype` applies the demo's cast after a float32 load
    (every float32 leaf of two or more dims in JAX's stacked layout, so
    every per-block leaf, becomes `matrix_dtype`) at the same time;
  * safetensors files are read by `read_safetensors` (numpy memory maps,
    one code path on every machine, no `safetensors` package), `.pth`
    files by `torch.load(..., weights_only=True, mmap=True)`, and the
    tensors of both only when the mapping asks for them;
  * `save_pytree` files store bfloat16 / float8 leaves as uint16 / uint8
    with a `::bf16` / `::f8e4m3` suffix, as JAX writes them; they are read
    back through torch dtype views, without `ml_dtypes`.

A loaded state dict (`StateDict`) gives each tensor in the dtype JAX's
`_load_one` would: float32 for `.pth` files and for safetensors files that
hold a float8 tensor, the stored dtype otherwise (bfloat16 included).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from flexam_tpu_torch.config import DiTConfig, T5Config, VAEConfig
from flexam_tpu_torch.device import resolve_device
from flexam_tpu_torch.io.convert import leaf
from flexam_tpu_torch.models.vae import latent_stats


# ---------------------------------------------------------------------------
# State dicts read on demand
# ---------------------------------------------------------------------------

class StateDict(Mapping):
    """A checkpoint's tensors by name, read from the file when asked for.
    `sd[k]` is the host tensor in JAX's load dtype (float32 where JAX's
    loader calls `.float()`); `sd.native(k)` is the tensor as stored."""

    def __init__(self, getters: Dict[str, Callable[[], torch.Tensor]],
                 as_float: bool):
        self._get = dict(getters)
        self._as_float = {k: as_float for k in self._get}

    def native(self, key: str) -> torch.Tensor:
        return self._get[key]()

    def load_dtype(self, key: str) -> Optional[torch.dtype]:
        """float32 where JAX's loader widens this tensor, else None."""
        return torch.float32 if self._as_float[key] else None

    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._get[key]()
        return t.float() if self._as_float[key] else t

    def __iter__(self) -> Iterator[str]:
        return iter(self._get)

    def __len__(self) -> int:
        return len(self._get)

    def __contains__(self, key) -> bool:
        return key in self._get

    def update(self, other: "StateDict") -> None:
        self._get.update(other._get)
        self._as_float.update(other._as_float)

    def with_prefix_stripped(self, prefix: str) -> "StateDict":
        out = StateDict({}, False)
        n = len(prefix)
        for k, g in self._get.items():
            if k.startswith(prefix):
                out._get[k[n:]] = g
                out._as_float[k[n:]] = self._as_float[k]
        return out


def _source(sd: Mapping, key: str):
    """(tensor as stored, the dtype JAX's load gives it or None)."""
    if isinstance(sd, StateDict):
        return sd.native(key), sd.load_dtype(key)
    return sd[key], None


# ---------------------------------------------------------------------------
# safetensors, read and written with numpy
# ---------------------------------------------------------------------------

# safetensors dtype -> (numpy dtype of the stored bytes, torch view or None)
_ST_DTYPES = {
    "F64": (np.float64, None), "F32": (np.float32, None),
    "F16": (np.float16, None), "BF16": (np.int16, torch.bfloat16),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
    "I64": (np.int64, None), "I32": (np.int32, None),
    "I16": (np.int16, None), "I8": (np.int8, None), "U8": (np.uint8, None),
    "BOOL": (np.bool_, None),
}
_TORCH_TO_ST = {torch.float64: "F64", torch.float32: "F32",
                torch.float16: "F16", torch.bfloat16: "BF16",
                torch.float8_e4m3fn: "F8_E4M3", torch.float8_e5m2: "F8_E5M2",
                torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
                torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
# numpy cannot hold these even with ml_dtypes loaded (as it always is beside
# jax; bfloat16 it can), so JAX's loader goes through torch and widens every
# tensor of such a file to float32
_NOT_NUMPY = ("F8_E4M3", "F8_E5M2")


def _safetensors_header(path: str):
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str) -> StateDict:
    """The tensors of one safetensors file: an 8-byte little-endian header
    length, a JSON header (dtype, shape, data offsets by name), then the raw
    little-endian tensors. Each tensor is a view of a copy-on-write memory
    map of the file, made when it is asked for."""
    header, start = _safetensors_header(path)
    size = os.path.getsize(path) - start
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=start,
                      shape=(size,)) if size else np.zeros(0, np.uint8))

    def getter(info):
        def get():
            a, b = info["data_offsets"]
            np_dt, view = _ST_DTYPES[info["dtype"]]
            t = torch.from_numpy(data[a:b].view(np_dt).reshape(info["shape"]))
            return t.view(view) if view is not None else t
        return get

    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which this reader lacks")
    as_float = any(info["dtype"] in _NOT_NUMPY for info in header.values())
    return StateDict({k: getter(v) for k, v in header.items()}, as_float)


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors (torch or numpy) in the safetensors format, widest
    dtypes first so that every tensor starts aligned to its element size."""
    ts = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
          .detach().contiguous() for k, v in tensors.items()}
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header, off = {}, 0
    for k in order:
        n = ts[k].numel() * ts[k].element_size()
        header[k] = {"dtype": _TORCH_TO_ST[ts[k].dtype],
                     "shape": list(ts[k].shape), "data_offsets": [off, off + n]}
        off += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for k in order:
            t = ts[k].cpu()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def _vae_leaf(sd, key, dev):
    t, load_dtype = _source(sd, key)
    return leaf(t, dev, load_dtype)


def _conv(sd, prefix: str, dev) -> dict:
    return {"weight": _vae_leaf(sd, prefix + ".weight", dev),
            "bias": _vae_leaf(sd, prefix + ".bias", dev)}


def _gamma(sd, key: str, dev) -> torch.Tensor:
    """RMS_norm gamma, squeezing the broadcast dims ((c,1,1,1) or (c,1,1))."""
    return _vae_leaf(sd, key, dev).reshape(-1)


def _res_from_sd(sd, prefix: str, dev) -> dict:
    """ResidualBlock: residual = Sequential(RMS, SiLU, Conv, RMS, SiLU,
    Dropout, Conv)."""
    p = {
        "norm1": _gamma(sd, f"{prefix}.residual.0.gamma", dev),
        "conv1": _conv(sd, f"{prefix}.residual.2", dev),
        "norm2": _gamma(sd, f"{prefix}.residual.3.gamma", dev),
        "conv2": _conv(sd, f"{prefix}.residual.6", dev),
    }
    if f"{prefix}.shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{prefix}.shortcut", dev)
    return p


def _attn_from_sd(sd, prefix: str, dev) -> dict:
    return {
        "norm": _gamma(sd, f"{prefix}.norm.gamma", dev),
        "to_qkv": _conv(sd, f"{prefix}.to_qkv", dev),
        "proj": _conv(sd, f"{prefix}.proj", dev),
    }


def _resample_from_sd(sd, prefix: str, dev) -> dict:
    """Resample: resample.1 is the spatial conv (index 0 is Upsample or
    ZeroPad); time_conv is there for the 3d modes."""
    p = {"resample_conv": _conv(sd, f"{prefix}.resample.1", dev)}
    if f"{prefix}.time_conv.weight" in sd:
        p["time_conv"] = _conv(sd, f"{prefix}.time_conv", dev)
    return p


def vae_params_from_state_dict(sd: Mapping, cfg: VAEConfig,
                               device="cuda") -> dict:
    """Map an `AutoencoderKLWan2_2_` state dict (keys WITHOUT the wrapper's
    `model.` prefix) to the `models/vae.py` tree on `device`, each leaf in
    the dtype it was loaded in."""
    dev = resolve_device(device)
    n_res = cfg.num_res_blocks
    n_blocks = len(cfg.dim_mult)

    enc: Dict = {"conv1": _conv(sd, "encoder.conv1", dev), "downsamples": []}
    for i in range(n_blocks):
        base = f"encoder.downsamples.{i}.downsamples"
        blk = {"res": [_res_from_sd(sd, f"{base}.{j}", dev)
                       for j in range(n_res)]}
        if i != n_blocks - 1:
            blk["down"] = _resample_from_sd(sd, f"{base}.{n_res}", dev)
        enc["downsamples"].append(blk)
    enc["middle"] = [_res_from_sd(sd, "encoder.middle.0", dev),
                     _attn_from_sd(sd, "encoder.middle.1", dev),
                     _res_from_sd(sd, "encoder.middle.2", dev)]
    enc["head_norm"] = _gamma(sd, "encoder.head.0.gamma", dev)
    enc["head_conv"] = _conv(sd, "encoder.head.2", dev)

    dec: Dict = {"conv1": _conv(sd, "decoder.conv1", dev), "upsamples": []}
    dec["middle"] = [_res_from_sd(sd, "decoder.middle.0", dev),
                     _attn_from_sd(sd, "decoder.middle.1", dev),
                     _res_from_sd(sd, "decoder.middle.2", dev)]
    for i in range(n_blocks):
        base = f"decoder.upsamples.{i}.upsamples"
        blk = {"res": [_res_from_sd(sd, f"{base}.{j}", dev)
                       for j in range(n_res + 1)]}
        if i != n_blocks - 1:
            blk["up"] = _resample_from_sd(sd, f"{base}.{n_res + 1}", dev)
        dec["upsamples"].append(blk)
    dec["head_norm"] = _gamma(sd, "decoder.head.0.gamma", dev)
    dec["head_conv"] = _conv(sd, "decoder.head.2", dev)

    mean, inv_std = latent_stats(cfg.latent_channels)
    return {
        "encoder": enc,
        "decoder": dec,
        "conv1": _conv(sd, "conv1", dev),
        "conv2": _conv(sd, "conv2", dev),
        "latents_mean": leaf(mean, dev),
        "latents_inv_std": leaf(inv_std, dev),
    }


def strip_prefix(sd: Mapping, prefix: str) -> Mapping:
    if isinstance(sd, StateDict):
        return sd.with_prefix_stripped(prefix)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

class _Putter:
    """The DiT loader's leaf rule: cast to `dtype` (float32 for the
    modulation tables, as JAX loads them), then, with `matrix_dtype`, every
    float32 leaf of two or more dims in JAX's stacked layout (a per-block
    leaf counts one more dim) to `matrix_dtype`, as the JAX demo casts the
    loaded tree.

    With `quant`, the weights that mode stores narrow are quantized from
    their float32 values as they load, one leaf at a time on the device, as
    the JAX demo quantizes its float32 host tree: "int8" quantizes the block
    linears (`ops/qlinear.py`), "fp8" stores every fp8-eligible weight as
    float8 (`utils/fp8.py`). The rest follows `matrix_dtype`."""

    def __init__(self, sd, device, dtype, matrix_dtype, quant=None):
        self.sd, self.dev = sd, resolve_device(device)
        self.dtype, self.matrix_dtype = dtype, matrix_dtype
        self.quant = quant

    def then(self, dtype, ndim: int):
        if (self.matrix_dtype is not None and dtype == torch.float32
                and ndim >= 2):
            return self.matrix_dtype
        return None

    def __call__(self, key: str, in_block: bool = False, dtype=None,
                 fp8_ok: bool = False):
        t, _ = _source(self.sd, key)
        dtype = dtype or self.dtype
        if self.quant == "fp8" and fp8_ok and t.ndim >= 2:
            return leaf(t, self.dev, torch.float32).to(torch.float8_e4m3fn)
        return leaf(t, self.dev, dtype, self.then(dtype, t.ndim + in_block))

    def lin(self, prefix: str, in_block: bool = False,
            int8_ok: bool = False) -> dict:
        if self.quant == "int8" and int8_ok:
            from flexam_tpu_torch.ops.qlinear import quantize_linear_params
            t, _ = _source(self.sd, prefix + ".weight")
            p = quantize_linear_params(
                {"weight": leaf(t, self.dev, torch.float32)})
        else:
            p = {"weight": self(prefix + ".weight", in_block, fp8_ok=True)}
        if prefix + ".bias" in self.sd:
            p["bias"] = self(prefix + ".bias", in_block)
        return p


def dit_params_from_state_dict(sd: Mapping, cfg: DiTConfig,
                               dtype=torch.float32, device="cuda",
                               matrix_dtype=None, quant=None) -> dict:
    """Map a `Wan2_2Transformer3DModel_FlexAM` state dict to the port's DiT
    tree on `device`. Pads the patch embedding's input channels with zeros
    for checkpoints with fewer input channels than `cfg.in_dim`. `quant`
    ("int8" | "fp8") quantizes while loading (see `_Putter`)."""
    put = _Putter(sd, device, dtype, matrix_dtype, quant)
    dev = put.dev

    w, _ = _source(sd, "patch_embedding.weight")
    patch_w = leaf(w, dev, dtype)
    if patch_w.shape[1] < cfg.in_dim:   # channel pad
        pad = torch.zeros((patch_w.shape[0], cfg.in_dim - patch_w.shape[1])
                          + tuple(patch_w.shape[2:]), dtype=dtype, device=dev)
        patch_w = torch.cat([patch_w, pad], dim=1)
    then = (torch.float8_e4m3fn if quant == "fp8"
            else put.then(dtype, patch_w.dim()))
    if then is not None:
        patch_w = patch_w.to(then)

    params = {
        "patch_embedding": {"weight": patch_w,
                            "bias": put("patch_embedding.bias")},
        "text_embedding": {"fc1": put.lin("text_embedding.0"),
                           "fc2": put.lin("text_embedding.2")},
        "time_embedding": {"fc1": put.lin("time_embedding.0"),
                           "fc2": put.lin("time_embedding.2")},
        "time_projection": {"fc": put.lin("time_projection.1")},
        "density_embedding": {"fc1": put.lin("density_embedding.0"),
                              "fc2": put.lin("density_embedding.2")},
        "density_projection": {"fc": put.lin("density_projection.1")},
        "head": {
            "head": put.lin("head.head"),
            "modulation": put("head.modulation", dtype=torch.float32),
            "modulation_density": put("head.modulation_density",
                                      dtype=torch.float32),
        },
    }

    blocks = []
    for i in range(cfg.num_layers):
        p = f"blocks.{i}"

        def attn(kind):
            return {
                "q": put.lin(f"{p}.{kind}.q", True, True),
                "k": put.lin(f"{p}.{kind}.k", True, True),
                "v": put.lin(f"{p}.{kind}.v", True, True),
                "o": put.lin(f"{p}.{kind}.o", True, True),
                "norm_q": put(f"{p}.{kind}.norm_q.weight", True),
                "norm_k": put(f"{p}.{kind}.norm_k.weight", True),
            }

        blk = {
            "self_attn": attn("self_attn"),
            "cross_attn": attn("cross_attn"),
            "ffn": {"fc1": put.lin(f"{p}.ffn.0", True, True),
                    "fc2": put.lin(f"{p}.ffn.2", True, True)},
            "modulation": put(f"{p}.modulation", True, torch.float32),
            "modulation_density": put(f"{p}.modulation_density", True,
                                      torch.float32),
        }
        if cfg.cross_attn_norm:
            blk["norm3"] = {"weight": put(f"{p}.norm3.weight", True),
                            "bias": put(f"{p}.norm3.bias", True)}
        blocks.append(blk)
    params["blocks"] = blocks

    if cfg.add_ref_conv and "ref_conv.weight" in sd:
        params["ref_conv"] = {"weight": put("ref_conv.weight", fp8_ok=True),
                              "bias": put("ref_conv.bias")}
    if cfg.add_cnn_block and "cnn_conv1.0.weight" in sd:
        cnn = {}
        for j in range(1, 5):
            cnn[f"conv{j}"] = put.lin(f"cnn_conv{j}.0")
            cnn[f"gn{j}"] = {"weight": put(f"cnn_conv{j}.1.weight"),
                             "bias": put(f"cnn_conv{j}.1.bias")}
        cnn["conv5"] = put.lin("cnn_conv5")
        params["cnn"] = cnn
    return params


# ---------------------------------------------------------------------------
# Trees -> reference state dicts (the inverse maps, for writing checkpoints)
# ---------------------------------------------------------------------------

def _put_lin(sd, prefix, p):
    sd[prefix + ".weight"] = p["weight"]
    if p.get("bias") is not None:
        sd[prefix + ".bias"] = p["bias"]


def dit_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The reference-named state dict of a port DiT tree (the inverse of
    `dit_params_from_state_dict`, without the channel pad)."""
    sd: Dict[str, torch.Tensor] = {}
    _put_lin(sd, "patch_embedding", params["patch_embedding"])
    for name, fcs in (("text_embedding", ("fc1", "fc2")),
                      ("time_embedding", ("fc1", "fc2")),
                      ("density_embedding", ("fc1", "fc2"))):
        _put_lin(sd, f"{name}.0", params[name][fcs[0]])
        _put_lin(sd, f"{name}.2", params[name][fcs[1]])
    _put_lin(sd, "time_projection.1", params["time_projection"]["fc"])
    _put_lin(sd, "density_projection.1", params["density_projection"]["fc"])
    _put_lin(sd, "head.head", params["head"]["head"])
    sd["head.modulation"] = params["head"]["modulation"]
    sd["head.modulation_density"] = params["head"]["modulation_density"]
    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        for kind in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                _put_lin(sd, f"{p}.{kind}.{n}", blk[kind][n])
            sd[f"{p}.{kind}.norm_q.weight"] = blk[kind]["norm_q"]
            sd[f"{p}.{kind}.norm_k.weight"] = blk[kind]["norm_k"]
        _put_lin(sd, f"{p}.ffn.0", blk["ffn"]["fc1"])
        _put_lin(sd, f"{p}.ffn.2", blk["ffn"]["fc2"])
        sd[f"{p}.modulation"] = blk["modulation"]
        sd[f"{p}.modulation_density"] = blk["modulation_density"]
        if "norm3" in blk:
            _put_lin(sd, f"{p}.norm3", blk["norm3"])
    if "ref_conv" in params:
        _put_lin(sd, "ref_conv", params["ref_conv"])
    if "cnn" in params:
        for j in range(1, 5):
            _put_lin(sd, f"cnn_conv{j}.0", params["cnn"][f"conv{j}"])
            _put_lin(sd, f"cnn_conv{j}.1", params["cnn"][f"gn{j}"])
        _put_lin(sd, "cnn_conv5", params["cnn"]["conv5"])
    return sd


def vae_state_dict(params: dict, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """The reference-named state dict (no `model.` prefix) of a port VAE
    tree, with the RMS gammas in the reference's broadcast shapes."""
    sd: Dict[str, torch.Tensor] = {}

    def res(prefix, p):
        sd[f"{prefix}.residual.0.gamma"] = p["norm1"].reshape(-1, 1, 1, 1)
        _put_lin(sd, f"{prefix}.residual.2", p["conv1"])
        sd[f"{prefix}.residual.3.gamma"] = p["norm2"].reshape(-1, 1, 1, 1)
        _put_lin(sd, f"{prefix}.residual.6", p["conv2"])
        if "shortcut" in p:
            _put_lin(sd, f"{prefix}.shortcut", p["shortcut"])

    def attn(prefix, p):
        sd[f"{prefix}.norm.gamma"] = p["norm"].reshape(-1, 1, 1)
        _put_lin(sd, f"{prefix}.to_qkv", p["to_qkv"])
        _put_lin(sd, f"{prefix}.proj", p["proj"])

    def resample(prefix, p):
        _put_lin(sd, f"{prefix}.resample.1", p["resample_conv"])
        if "time_conv" in p:
            _put_lin(sd, f"{prefix}.time_conv", p["time_conv"])

    n_res = cfg.num_res_blocks
    for side, blocks, key, extra in (("encoder", "downsamples", "down", 0),
                                     ("decoder", "upsamples", "up", 1)):
        tree = params[side]
        _put_lin(sd, f"{side}.conv1", tree["conv1"])
        res(f"{side}.middle.0", tree["middle"][0])
        attn(f"{side}.middle.1", tree["middle"][1])
        res(f"{side}.middle.2", tree["middle"][2])
        for i, blk in enumerate(tree[blocks]):
            base = f"{side}.{blocks}.{i}.{blocks}"
            for j, r in enumerate(blk["res"]):
                res(f"{base}.{j}", r)
            if key in blk:
                resample(f"{base}.{n_res + extra}", blk[key])
        sd[f"{side}.head.0.gamma"] = tree["head_norm"].reshape(-1, 1, 1, 1)
        _put_lin(sd, f"{side}.head.2", tree["head_conv"])
    _put_lin(sd, "conv1", params["conv1"])
    _put_lin(sd, "conv2", params["conv2"])
    return sd


def t5_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The `WanT5EncoderModel` state dict of a port umT5 tree with
    per-layer position tables."""
    sd = {"token_embedding.weight": params["token_embedding"],
          "norm.weight": params["norm"]}
    for i, bp in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        sd[f"{p}.norm1.weight"] = bp["norm1"]
        sd[f"{p}.norm2.weight"] = bp["norm2"]
        for n in ("q", "k", "v", "o"):
            sd[f"{p}.attn.{n}.weight"] = bp["attn"][n]
        sd[f"{p}.ffn.gate.0.weight"] = bp["ffn"]["gate"]
        sd[f"{p}.ffn.fc1.weight"] = bp["ffn"]["fc1"]
        sd[f"{p}.ffn.fc2.weight"] = bp["ffn"]["fc2"]
        sd[f"{p}.pos_embedding.embedding.weight"] = bp["pos_embedding"]
    return sd


# ---------------------------------------------------------------------------
# File loading
# ---------------------------------------------------------------------------

def load_safetensors_dir(path: str) -> StateDict:
    """Every `*.safetensors` file of a directory merged (the reference's
    multi-file loader), or a single file (safetensors or `.pth`)."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no safetensors under {path}")
        sd = StateDict({}, False)
        for f in files:
            sd.update(_load_one(f))
        return sd
    return _load_one(path)


def _load_one(path: str) -> StateDict:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return StateDict({k: (lambda v=v: v) for k, v in sd.items()}, True)


def load_vae_checkpoint(path: str, cfg: VAEConfig, device="cuda") -> dict:
    """Raw Wan VAE `.pth` (keys without prefix; a `model.` prefix, which
    the reference adds, is stripped)."""
    sd = _load_one(path)
    if any(k.startswith("model.") for k in sd):
        sd = strip_prefix(sd, "model.")
    return vae_params_from_state_dict(sd, cfg, device)


def load_dit_checkpoint(path: str, cfg: DiTConfig, dtype=torch.float32,
                        device="cuda", matrix_dtype=None, quant=None) -> dict:
    return dit_params_from_state_dict(load_safetensors_dir(path), cfg, dtype,
                                      device, matrix_dtype, quant)


def load_t5_checkpoint(path: str, cfg: T5Config, dtype=torch.float32,
                       device="cuda") -> dict:
    from flexam_tpu_torch.models.t5 import t5_params_from_state_dict
    return t5_params_from_state_dict(_load_one(path), cfg, dtype, device)


# ---------------------------------------------------------------------------
# Tree save / restore (.npz keyed by '/'-joined paths)
# ---------------------------------------------------------------------------

def save_pytree(path: str, tree) -> None:
    """Flatten a tree (torch tensors or numpy arrays) to one .npz keyed by
    '/'-joined paths, bfloat16 / float8-e4m3 leaves stored as uint16 /
    uint8 with a `::bf16` / `::f8e4m3` suffix (JAX's file format; a port
    tree's per-block lists are saved as lists)."""
    flat = {}

    def visit(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(f"{prefix}/{i}", v)
        elif torch.is_tensor(node):
            t = node.detach().cpu()
            if t.dtype == torch.bfloat16:
                flat[prefix + "::bf16"] = t.view(torch.int16).numpy().view(
                    np.uint16)
            elif t.dtype == torch.float8_e4m3fn:
                flat[prefix + "::f8e4m3"] = t.view(torch.uint8).numpy()
            else:
                flat[prefix] = t.numpy()
        else:
            flat[prefix] = np.asarray(node)

    visit("", tree)
    np.savez(path, **flat)


def npz_member(z, k: str) -> Tuple[str, torch.Tensor]:
    """(path, host tensor) of member `k` of an open save_pytree .npz, its
    bf16 / float8 storage undone."""
    if k.endswith("::bf16"):
        return k[:-6], torch.from_numpy(z[k].view(np.int16)).view(
            torch.bfloat16)
    if k.endswith("::f8e4m3"):
        return k[:-8], torch.from_numpy(z[k]).view(torch.float8_e4m3fn)
    return k, torch.from_numpy(z[k])


def load_pytree_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A save_pytree .npz back as a flat '/'-path dict of host tensors."""
    with np.load(path) as z:
        return dict(npz_member(z, k) for k in z.files)


def nest_flat_paths(flat: dict) -> dict:
    """Rebuild a nested tree from '/'-joined flat paths. save_pytree writes
    list and tuple nodes as stringified indices, so a dict whose keys are
    exactly the digits 0..n-1 becomes a list again."""
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def delist(node):
        if not isinstance(node, dict):
            return node
        node = {k: delist(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node

    return delist(tree)


def restore_pytree_nested(path: str) -> dict:
    """Restore a save_pytree .npz without a like-tree ('/'-joined paths
    rebuild nested dicts, list nodes come back as lists)."""
    return nest_flat_paths(load_pytree_state_dict(path))


def restore_pytree(path: str, like) -> dict:
    """Restore into the structure of `like` (paths must match)."""
    flat = load_pytree_state_dict(path)

    def visit(prefix, node):
        if isinstance(node, dict):
            return {k: visit(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [visit(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(vals) if isinstance(node, tuple) else vals
        return flat[prefix]

    return visit("", like)
