"""LoRA merge into the DiT weights, and train-side LoRA factors.

Port of `flexam_tpu/utils/lora.py` on the port's per-block list: kohya
(`lora_unet_*`) and diffusers (`*.lora_A/B.weight`) state dicts map onto
`blocks[i][module][proj]`, and `merge_lora` adds
`multiplier * alpha / rank * (up @ down)` to each touched weight
(`unmerge_lora` subtracts it). As in JAX, the delta is computed in numpy
float32 on the host, added in float32 on the weight's device, and cast back
to the weight's dtype; only the touched layers' deltas cross to the device.

Merge before quantizing: an int8 linear has no float weight to merge into,
and merging into one raises. A float8-stored weight merges as JAX merges
it (cast up, add, cast back).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _np(v) -> np.ndarray:
    """A state-dict value (numpy array or tensor of any float dtype) as a
    float32 numpy array."""
    if torch.is_tensor(v):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _collect_lora_pairs(lora_sd: Mapping):
    """Group {stem: (down/A, up/B, alpha)} from kohya ('lora_unet_*') or
    diffusers ('*.lora_A.weight') layouts."""
    pairs: Dict[str, dict] = {}
    for k, v in lora_sd.items():
        if k.endswith(".alpha"):
            pairs.setdefault(k[:-len(".alpha")], {})["alpha"] = float(_np(v))
        elif ".lora_down.weight" in k:
            pairs.setdefault(k.split(".lora_down.")[0], {})["down"] = v
        elif ".lora_up.weight" in k:
            pairs.setdefault(k.split(".lora_up.")[0], {})["up"] = v
        elif ".lora_A.weight" in k:
            pairs.setdefault(k.split(".lora_A.")[0], {})["down"] = v
        elif ".lora_B.weight" in k:
            pairs.setdefault(k.split(".lora_B.")[0], {})["up"] = v
    return {k: p for k, p in pairs.items() if "down" in p and "up" in p}


def _stem_to_path(stem: str) -> Optional[Tuple]:
    """kohya / diffusers stem -> DiT tree path.

    'lora_unet_blocks_3_self_attn_q' / 'blocks.3.self_attn.q'
      -> ("blocks", 3, "self_attn", "q")
    'blocks.3.ffn.0' -> ("blocks", 3, "ffn", "fc1")
    """
    s = stem
    if s.startswith("lora_unet_"):
        s = s[len("lora_unet_"):].replace("_", ".")
        # undo the over-splitting of known tokens
        s = s.replace("self.attn", "self_attn").replace(
            "cross.attn", "cross_attn")
    m = re.match(r"blocks\.(\d+)\.(self_attn|cross_attn)\.([qkvo])$", s)
    if m:
        return ("blocks", int(m.group(1)), m.group(2), m.group(3))
    m = re.match(r"blocks\.(\d+)\.ffn\.([02])$", s)
    if m:
        return ("blocks", int(m.group(1)), "ffn",
                "fc1" if m.group(2) == "0" else "fc2")
    return None


def merge_lora(params: dict, lora_sd: Mapping, multiplier: float = 1.0,
               sign: float = 1.0) -> dict:
    """Return params with the LoRA deltas merged into the block weights
    (`sign=-1` unmerges). The input tree is not changed: touched blocks and
    modules are shallow copies with new weights."""
    pairs = _collect_lora_pairs(lora_sd)
    deltas: Dict[Tuple, np.ndarray] = {}
    skipped = 0
    for stem, p in pairs.items():
        path = _stem_to_path(stem)
        if path is None:
            skipped += 1
            continue
        down = _np(p["down"])                       # [r, in]
        up = _np(p["up"])                           # [out, r]
        rank = down.shape[0]
        alpha = p.get("alpha", float(rank))
        scale = alpha / rank
        deltas[path] = sign * multiplier * scale * (up @ down)
    if skipped:
        print(f"merge_lora: {skipped} keys did not map and were skipped")

    blocks = list(params["blocks"])
    for (_, layer, mod, proj), d in deltas.items():
        lin = blocks[layer][mod][proj]
        if "weight" not in lin:
            raise ValueError(
                f"merge_lora: blocks[{layer}].{mod}.{proj} is int8-quantized "
                "(weight_q); merge the LoRA into the float weights first, "
                "then quantize (convert_dit_to_int8, pipeline quant=)")
        w = lin["weight"]
        neww = (w.float() + torch.from_numpy(d).to(w.device)).to(w.dtype)
        blocks[layer] = {**blocks[layer], mod: {
            **blocks[layer][mod], proj: {**lin, "weight": neww}}}
    return {**params, "blocks": blocks}


def unmerge_lora(params: dict, lora_sd, multiplier: float = 1.0) -> dict:
    return merge_lora(params, lora_sd, multiplier, sign=-1.0)


# ---------------------------------------------------------------------------
# Train-side LoRA factors
# ---------------------------------------------------------------------------

_PROJ_NAMES = {"self_attn": ("q", "k", "v", "o"),
               "cross_attn": ("q", "k", "v", "o"),
               "ffn": ("fc1", "fc2")}


def init_lora_params(gen: torch.Generator, dit_params: dict, rank: int = 16,
                     alpha: Optional[float] = None,
                     targets=("self_attn", "cross_attn", "ffn")) -> dict:
    """Trainable LoRA factors over the block linears, one dict a block:

      {"blocks": [{mod: {proj: {"a": [r, in], "b": [out, r]}}}, ...],
       "rank": r, "alpha": a}

    A is normal / rank, drawn from `gen` on its device for each (module,
    proj) over all blocks at once; B is zero (the delta starts at exactly
    zero); alpha defaults to rank (scale 1)."""
    blocks = dit_params["blocks"]
    out_blocks = [{} for _ in blocks]
    dev = gen.device
    for mod in targets:
        if mod not in blocks[0]:
            continue
        for proj in _PROJ_NAMES[mod]:
            if proj not in blocks[0][mod]:
                continue
            odim, idim = blocks[0][mod][proj]["weight"].shape
            a = torch.randn((len(blocks), rank, idim), generator=gen,
                            device=dev) / rank
            for i, ob in enumerate(out_blocks):
                ob.setdefault(mod, {})[proj] = {
                    "a": a[i], "b": torch.zeros((odim, rank), device=dev)}
    return {"blocks": out_blocks, "rank": rank,
            "alpha": float(alpha if alpha is not None else rank)}


def apply_lora(dit_params: dict, lora: dict, multiplier: float = 1.0
               ) -> dict:
    """Effective weights W + m * (alpha / r) * (B @ A) per block, computed
    in float32 and cast back; differentiable through the factors."""
    scale = multiplier * lora["alpha"] / lora["rank"]
    blocks = []
    for bp, lb in zip(dit_params["blocks"], lora["blocks"]):
        bp = dict(bp)
        for mod, projs in lb.items():
            newmod = dict(bp[mod])
            for proj, ab in projs.items():
                w = newmod[proj]["weight"]
                delta = (ab["b"].float() @ ab["a"].float()) * scale
                newmod[proj] = {**newmod[proj],
                                "weight": (w.float() + delta).to(w.dtype)}
            bp[mod] = newmod
        blocks.append(bp)
    return {**dit_params, "blocks": blocks}


def lora_to_state_dict(lora: dict, layout: str = "kohya"
                       ) -> Dict[str, np.ndarray]:
    """The factors in the checkpoint layouts `merge_lora` loads (kohya
    'lora_unet_*' or diffusers '*.lora_A/B'), a pair a block."""
    sd: Dict[str, np.ndarray] = {}
    alpha = np.float32(lora["alpha"])
    for layer, lb in enumerate(lora["blocks"]):
        for mod, projs in lb.items():
            for proj, ab in projs.items():
                ref_proj = {"fc1": "0", "fc2": "2"}.get(proj, proj)
                if layout == "kohya":
                    stem = f"lora_unet_blocks_{layer}_{mod}_{ref_proj}"
                    sd[f"{stem}.lora_down.weight"] = _np(ab["a"])
                    sd[f"{stem}.lora_up.weight"] = _np(ab["b"])
                else:
                    stem = f"blocks.{layer}.{mod}.{ref_proj}"
                    sd[f"{stem}.lora_A.weight"] = _np(ab["a"])
                    sd[f"{stem}.lora_B.weight"] = _np(ab["b"])
                sd[f"{stem}.alpha"] = alpha
    return sd
