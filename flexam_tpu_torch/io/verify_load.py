"""Checkpoint-mapping verification: coverage reports and pass/fail gating.

A copy of `flexam_tpu/io/verify_load.py` (pure Python), so that the port
imports nothing of the JAX package. A mapping report ({"loaded": [tree
paths], "missed": [tree paths], "unused": [checkpoint keys]}) becomes a
per-module coverage summary and a decision: a same-shape tensor can land
in the wrong module, so a caller must see per-module coverage and refuse a
mostly-random model. Paths look like "['encoder']['blocks']['3']['weight']"
(`jax.tree_util.keystr`'s form, which the JAX loaders' reports use).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

# A mapped pytree path looks like "['encoder']['blocks']['3']['weight']"
# (jax.tree_util.keystr). Group by the first `depth` components.
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _path_components(path: str) -> List[str]:
    out = []
    for m in _KEY_RE.finditer(path):
        out.append(m.group(1) if m.group(1) is not None else m.group(2))
    return out or [path]


def _module_of(path: str, depth: int) -> str:
    comps = _path_components(path)
    # skip pure-index leading components (scan-stacked block lists)
    named = [c for c in comps if not c.isdigit()]
    use = (named or comps)[:depth]
    return "/".join(use) if use else "(root)"


def summarize_mapping(report: Mapping[str, list], depth: int = 2) -> dict:
    """Coverage summary of a shape/name mapping report.

    Returns {"overall": float, "n_loaded": int, "n_total": int,
    "n_unused": int, "modules": {name: {"loaded", "total", "frac"}}}.
    """
    loaded = list(report.get("loaded", ()))
    missed = list(report.get("missed", ()))
    modules: Dict[str, dict] = {}
    for path in loaded:
        m = modules.setdefault(_module_of(path, depth),
                               {"loaded": 0, "total": 0})
        m["loaded"] += 1
        m["total"] += 1
    for path in missed:
        m = modules.setdefault(_module_of(path, depth),
                               {"loaded": 0, "total": 0})
        m["total"] += 1
    for m in modules.values():
        m["frac"] = m["loaded"] / max(m["total"], 1)
    n_total = len(loaded) + len(missed)
    return {
        "overall": len(loaded) / max(n_total, 1),
        "n_loaded": len(loaded),
        "n_total": n_total,
        "n_unused": len(report.get("unused", ())),
        "modules": modules,
    }


def format_mapping_report(name: str, summary: Mapping,
                          max_rows: int = 40) -> str:
    lines = [f"{name}: mapped {summary['n_loaded']}/{summary['n_total']} "
             f"tensors ({summary['overall']:.1%}), "
             f"{summary['n_unused']} checkpoint tensors unused"]
    rows = sorted(summary["modules"].items(),
                  key=lambda kv: (kv[1]["frac"], kv[0]))
    for mod, m in rows[:max_rows]:
        mark = " " if m["frac"] >= 0.999 else "!"
        lines.append(f"  {mark} {mod:<40s} {m['loaded']:>4d}/{m['total']:<4d}"
                     f" ({m['frac']:.0%})")
    if len(rows) > max_rows:
        lines.append(f"  ... {len(rows) - max_rows} more modules")
    return "\n".join(lines)


def check_mapping(report: Mapping[str, list], name: str = "checkpoint",
                  threshold: float = 0.9, strict: bool = False,
                  quiet: bool = False, depth: int = 2) -> bool:
    """Print the per-module coverage table and decide pass/fail.

    Fail = overall coverage below `threshold` OR any module with zero
    loaded tensors (a whole sub-model left at random init is worse than a
    uniform shortfall). With strict=True a failure raises instead of
    returning False.
    """
    summary = summarize_mapping(report, depth=depth)
    empty = [mod for mod, m in summary["modules"].items()
             if m["total"] > 0 and m["loaded"] == 0]
    ok = summary["overall"] >= threshold and not empty
    if not quiet:
        print(format_mapping_report(name, summary))
        if empty:
            print(f"  !! modules with NO loaded tensors: {', '.join(empty)}")
    if not ok and strict:
        raise ValueError(
            f"{name}: checkpoint mapping coverage "
            f"{summary['overall']:.1%} < {threshold:.0%}"
            + (f"; empty modules: {empty}" if empty else ""))
    return ok


def mapping_coverage(report: Mapping[str, list]) -> float:
    return summarize_mapping(report, depth=1)["overall"]
