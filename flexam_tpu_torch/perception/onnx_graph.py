"""An ONNX graph run op by op as torch ops on a device.

The port's counterpart of the `cv2.dnn` network JAX's DWPose builds from
each `.onnx` file (`flexam_tpu/perception/dwpose.py:221-231`).
`io/onnx.py` reads the file; `OnnxGraph` keeps the initializers on the
device (float ones as float32) and runs the nodes in the file's order,
which ONNX requires to be topological, dropping each value after the
last node that reads it. The ops are those of the YOLOX-L
and RTMPose-l exports (SiLU as Sigmoid * Mul, Focus slicing, SPP pools,
nearest upsampling, CSPNeXt's channel attention, the RTMCC head's
ScaleNorm, GAU and SimCC linears); an op outside `OPS` raises
NotImplementedError naming it and its node. Both the opset-11 forms
(axes and splits as attributes) and the opset-13 forms (as inputs) are
taken.

fp32 convolutions and matmuls run without TF32 inside the call on CUDA (the
global flags are restored after it), so the card computes what the CPU
does up to the order of summation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from flexam_tpu_torch.io.onnx import DTYPES, Model, Node, read_onnx

_TORCH_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                 5: torch.int16, 6: torch.int32, 7: torch.int64,
                 9: torch.bool, 10: torch.float16, 11: torch.float64}


def _ints(t) -> List[int]:
    """A small index tensor (or list) as Python ints."""
    if isinstance(t, torch.Tensor):
        return [int(v) for v in t.reshape(-1).tolist()]
    return [int(v) for v in t]


def _axis(a: int, rank: int) -> int:
    return a + rank if a < 0 else a


def _pads(node: Node, rank: int) -> Optional[List[int]]:
    """ONNX `pads` [b1, b2, ..., e1, e2, ...] as F.pad's (last axis first),
    or None where they are zero."""
    if node.attrs.get("auto_pad", b"NOTSET") not in (b"NOTSET", "NOTSET"):
        raise NotImplementedError(
            f"onnx: {node.op_type} node {node.name!r}: auto_pad "
            f"{node.attrs['auto_pad']!r}")
    p = list(node.attrs.get("pads", [0] * (2 * rank)))
    if not any(p):
        return None
    out = []
    for i in reversed(range(rank)):
        out += [p[i], p[i + rank]]
    return out


class OnnxGraph(torch.nn.Module):
    """An ONNX model as a module: `forward(*inputs)` takes the graph's
    inputs in order (numpy or tensors) and returns its outputs in order,
    as tensors on `device`."""

    def __init__(self, model, device="cuda"):
        super().__init__()
        if not isinstance(model, Model):
            model = read_onnx(model)
        self.model = model
        self.graph = model.graph
        self.opset = model.opset_version
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OnnxGraph: CUDA requested but no card is "
                               "available; pass device='cpu' for the host")
        self.consts: Dict[str, torch.Tensor] = {}
        for name, arr in self.graph.initializers.items():
            self.consts[name] = self._tensor(arr)
        for node in self.graph.nodes:
            if node.op_type not in OPS or node.domain not in ("",
                                                                "ai.onnx"):
                raise NotImplementedError(
                    f"onnx: op {node.domain + '.' if node.domain else ''}"
                    f"{node.op_type} (node {node.name!r}) is not one the "
                    "port runs")
        self.input_names = [i.name for i in self.graph.inputs]
        self.output_names = [o.name for o in self.graph.outputs]
        # each value is dropped after the last node that reads it
        last = {n: i for i, node in enumerate(self.graph.nodes)
                for n in node.inputs}
        keep = set(self.output_names) | set(self.consts) | {""}
        self._free: List[List[str]] = [[] for _ in self.graph.nodes]
        for n, i in last.items():
            if n not in keep:
                self._free[i].append(n)

    def _tensor(self, arr) -> torch.Tensor:
        a = np.asarray(arr)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        # (np.ascontiguousarray would make a 0-dim array 1-dim)
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    @torch.no_grad()
    def forward(self, *inputs) -> List[torch.Tensor]:
        if len(inputs) != len(self.input_names):
            raise ValueError(f"OnnxGraph: {len(self.input_names)} inputs "
                             f"({self.input_names}), got {len(inputs)}")
        env: Dict[str, torch.Tensor] = dict(self.consts)
        env[""] = None                           # an omitted input
        for name, x in zip(self.input_names, inputs):
            env[name] = (x.to(self.device) if isinstance(x, torch.Tensor)
                         else self._tensor(x))
        cuda = self.device.type == "cuda"
        if cuda:
            saved = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for node, free in zip(self.graph.nodes, self._free):
                ins = [env[n] for n in node.inputs]
                outs = OPS[node.op_type](self, node, ins)
                if isinstance(outs, torch.Tensor):
                    outs = [outs]
                for n, t in zip(node.outputs, outs):
                    env[n] = t
                del ins
                for n in free:
                    del env[n]
        finally:
            if cuda:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = saved
        return [env[n] for n in self.output_names]

    # ops whose axes / splits moved from attributes to inputs ----------

    def _axes(self, node: Node, ins, key: str = "axes", pos: int = 1):
        if key in node.attrs:
            return list(node.attrs[key])
        if len(ins) > pos and ins[pos] is not None:
            return _ints(ins[pos])
        return None


def _conv(g, node, ins):
    x, w = ins[0], ins[1]
    b = ins[2] if len(ins) > 2 else None
    nd = w.dim() - 2
    pads = _pads(node, nd)
    if pads is not None:
        x = F.pad(x, pads)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
    return conv(x, w, b, stride=node.attrs.get("strides", [1] * nd),
                dilation=node.attrs.get("dilations", [1] * nd),
                groups=node.attrs.get("group", 1))


def _max_pool(g, node, ins):
    x = ins[0]
    k = node.attrs["kernel_shape"]
    nd = len(k)
    pads = _pads(node, nd)
    if pads is not None:
        x = F.pad(x, pads, value=float("-inf"))
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
    return pool(x, k, stride=node.attrs.get("strides", [1] * nd),
                dilation=node.attrs.get("dilations", [1] * nd),
                ceil_mode=bool(node.attrs.get("ceil_mode", 0)))


def _concat(g, node, ins):
    return torch.cat(ins, dim=node.attrs["axis"])


def _split(g, node, ins):
    x = ins[0]
    axis = _axis(node.attrs.get("axis", 0), x.dim())
    sizes = g._axes(node, ins, "split")
    if sizes is None:
        n = len(node.outputs)
        sizes = [x.shape[axis] // n] * n
    return list(torch.split(x, sizes, dim=axis))


def _slice(g, node, ins):
    x = ins[0]
    if g.opset < 10:
        starts, ends = node.attrs["starts"], node.attrs["ends"]
        axes = node.attrs.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts, ends = _ints(ins[1]), _ints(ins[2])
        axes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts))))
        steps = (_ints(ins[4]) if len(ins) > 4 and ins[4] is not None
                 else [1] * len(starts))
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = _axis(a, x.dim())
        n = x.shape[a]
        if st == 0:
            raise ValueError(f"onnx: Slice node {node.name!r}: step 0")
        idx = torch.arange(n, device=x.device)[slice(
            *(max(-n - 1, min(v, n)) if v is not None else None
              for v in (s, e)), st)]
        x = x.index_select(a, idx)
    return x


def _resize(g, node, ins):
    x = ins[0]
    mode = node.attrs.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode != "nearest":
        raise NotImplementedError(
            f"onnx: Resize node {node.name!r}: mode {mode!r} (nearest only)")
    ctm = node.attrs.get("coordinate_transformation_mode", b"half_pixel")
    ctm = ctm.decode() if isinstance(ctm, bytes) else ctm
    nm = node.attrs.get("nearest_mode", b"round_prefer_floor")
    nm = nm.decode() if isinstance(nm, bytes) else nm
    if g.opset < 11:                      # Upsample-style: X, scales
        scales = ins[1].tolist()
        sizes = None
        ctm, nm = "asymmetric", "floor"
    else:
        scales = (ins[2].tolist() if len(ins) > 2 and ins[2] is not None
                  and ins[2].numel() else None)
        sizes = (_ints(ins[3]) if len(ins) > 3 and ins[3] is not None
                 else None)
    if sizes is None:
        sizes = [int(math.floor(n * s)) for n, s in zip(x.shape, scales)]
    if scales is None:
        scales = [o / n for o, n in zip(sizes, x.shape)]
    for a, (n, o, s) in enumerate(zip(x.shape, sizes, scales)):
        if n == o:
            continue
        d = torch.arange(o, dtype=torch.float64)
        if ctm == "asymmetric":
            src = d / s
        elif ctm == "half_pixel":
            src = (d + 0.5) / s - 0.5
        elif ctm == "pytorch_half_pixel":
            src = (d + 0.5) / s - 0.5 if o > 1 else torch.zeros_like(d)
        elif ctm == "align_corners":
            src = d * (n - 1) / (o - 1) if o > 1 else torch.zeros_like(d)
        else:
            raise NotImplementedError(
                f"onnx: Resize node {node.name!r}: coordinate mode {ctm!r}")
        if nm == "floor":
            idx = torch.floor(src)
        elif nm == "ceil":
            idx = torch.ceil(src)
        elif nm == "round_prefer_ceil":
            idx = torch.floor(src + 0.5)
        else:                                    # round_prefer_floor
            idx = torch.ceil(src - 0.5)
        idx = idx.clamp(0, n - 1).long().to(x.device)
        x = x.index_select(a, idx)
    return x


def _reshape(g, node, ins):
    x, shape = ins[0], _ints(ins[1])
    if not node.attrs.get("allowzero", 0):
        shape = [x.shape[i] if v == 0 else v for i, v in enumerate(shape)]
    return x.reshape(shape)


def _flatten(g, node, ins):
    x = ins[0]
    a = _axis(node.attrs.get("axis", 1), x.dim())
    return x.reshape(int(np.prod(x.shape[:a], dtype=np.int64)), -1)


def _transpose(g, node, ins):
    x = ins[0]
    perm = node.attrs.get("perm", list(reversed(range(x.dim()))))
    return x.permute(*perm)


def _unsqueeze(g, node, ins):
    x = ins[0]
    axes = g._axes(node, ins)
    rank = x.dim() + len(axes)
    for a in sorted(_axis(a, rank) for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(g, node, ins):
    x = ins[0]
    axes = g._axes(node, ins)
    if axes is None:
        return x.squeeze()
    for a in sorted((_axis(a, x.dim()) for a in axes), reverse=True):
        x = x.squeeze(a)
    return x


def _reduce(fn):
    def op(g, node, ins):
        x = ins[0]
        axes = g._axes(node, ins)
        keep = bool(node.attrs.get("keepdims", 1))
        if axes is None or not axes:
            axes = list(range(x.dim()))
        return fn(x, [_axis(a, x.dim()) for a in axes], keep)
    return op


def _gemm(g, node, ins):
    a, b = ins[0], ins[1]
    if node.attrs.get("transA", 0):
        a = a.t()
    if node.attrs.get("transB", 0):
        b = b.t()
    y = node.attrs.get("alpha", 1.0) * (a @ b)
    if len(ins) > 2 and ins[2] is not None:
        y = y + node.attrs.get("beta", 1.0) * ins[2]
    return y


def _softmax(g, node, ins):
    x = ins[0]
    if g.opset >= 13:
        return torch.softmax(x, dim=node.attrs.get("axis", -1))
    a = _axis(node.attrs.get("axis", 1), x.dim())
    flat = x.reshape(int(np.prod(x.shape[:a], dtype=np.int64)), -1)
    return torch.softmax(flat, dim=1).reshape(x.shape)


def _constant(g, node, ins):
    for key in ("value", "value_float", "value_floats", "value_int",
                "value_ints"):
        if key in node.attrs:
            v = node.attrs[key]
            if key in ("value_int", "value_ints"):
                v = np.asarray(v, np.int64)
            elif key in ("value_float", "value_floats"):
                v = np.asarray(v, np.float32)
            return g._tensor(v)
    raise NotImplementedError(
        f"onnx: Constant node {node.name!r}: attributes {list(node.attrs)}")


def _gather(g, node, ins):
    x, idx = ins[0], ins[1].long()
    a = _axis(node.attrs.get("axis", 0), x.dim())
    idx = torch.where(idx < 0, idx + x.shape[a], idx)
    out = x.index_select(a, idx.reshape(-1))
    return out.reshape(x.shape[:a] + idx.shape + x.shape[a + 1:])


def _cast(g, node, ins):
    to = node.attrs["to"]
    if to not in _TORCH_DTYPES:
        raise NotImplementedError(f"onnx: Cast node {node.name!r} to type "
                                  f"{to} ({DTYPES.get(to)})")
    return ins[0].to(_TORCH_DTYPES[to])


def _hard_sigmoid(g, node, ins):
    alpha = node.attrs.get("alpha", 0.2)
    beta = node.attrs.get("beta", 0.5)
    return (ins[0] * alpha + beta).clamp(0.0, 1.0)


OPS = {
    "Conv": _conv,
    "Sigmoid": lambda g, n, i: torch.sigmoid(i[0]),
    "Mul": lambda g, n, i: i[0] * i[1],
    "Add": lambda g, n, i: i[0] + i[1],
    "Sub": lambda g, n, i: i[0] - i[1],
    "Div": lambda g, n, i: (i[0] / i[1] if i[0].is_floating_point()
                            else torch.div(i[0], i[1], rounding_mode="trunc")),
    "Pow": lambda g, n, i: torch.pow(i[0], i[1]),
    "Sqrt": lambda g, n, i: torch.sqrt(i[0]),
    "Relu": lambda g, n, i: torch.relu(i[0]),
    "HardSigmoid": _hard_sigmoid,
    "Concat": _concat,
    "Split": _split,
    "Slice": _slice,
    "MaxPool": _max_pool,
    "GlobalAveragePool": lambda g, n, i: i[0].mean(
        dim=tuple(range(2, i[0].dim())), keepdim=True),
    "ReduceMean": _reduce(lambda x, a, k: x.mean(dim=a, keepdim=k)),
    "ReduceL2": _reduce(lambda x, a, k: torch.sqrt(
        (x * x).sum(dim=a, keepdim=k))),
    "Resize": _resize,
    "Reshape": _reshape,
    "Flatten": _flatten,
    "Transpose": _transpose,
    "Unsqueeze": _unsqueeze,
    "Squeeze": _squeeze,
    "MatMul": lambda g, n, i: torch.matmul(i[0], i[1]),
    "Gemm": _gemm,
    "Softmax": _softmax,
    "Constant": _constant,
    "Shape": lambda g, n, i: torch.tensor(list(i[0].shape), dtype=torch.int64,
                                          device=g.device),
    "Gather": _gather,
    "Cast": _cast,
    "Identity": lambda g, n, i: i[0],
}
