"""B1 and B2 built from several source trees, side by side on one CUDA card.

    python -m flexam_tpu_torch.tools.attention_ab --other LABEL=DIR [...]

Each DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory); this tree is
"this". Each tree's `flexam_tpu_torch/csrc/flash_attention.cu` is compiled
alone, with this tree's nvcc flags, into `build/attention_ab/<label>/`,
where its SASS is written too (`<label>.sass`). The script prints one JSON
line per result:

  * "resources": each kernel's ptxas registers / spills / static shared
    memory, the dynamic shared memory a CTA takes (where the tree's library
    reports it), any ptxas note on wgmma, the counts of the opcodes that
    tell the designs apart (HGMMA, UTMALDG, ...), its SASS instruction
    count, and the opcodes whose counts differ from the first other tree's;
  * "within_bound": each build's B1 and B2 output held to the plain version
    by `testing.check_attention` (the designs sum in different orders, so
    their outputs are compared with the bound, not bit for bit), with the
    worst element's error over its bound;
  * "timing": B1 at the flagship self-attention shape (q/k/v
    [2, 11648, 24, 128] bf16) and B2 (k/v [2, 512, 24, 128]), the trees
    in order and then in reverse order (repeated), each leg the median of
    CUDA-event-timed launches, and each tree's median over the first's;

then the nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from flexam_tpu_torch.ops import build
from flexam_tpu_torch.ops.flash_attention import LOG2E, attention_plain
from flexam_tpu_torch.testing import check_attention

ENTRY_POINTS = ("flexam_flash_attention", "flexam_single_kv_attention")
KERNELS = ("flash_kernel", "single_kv_kernel")
# opcodes that tell a Hopper design (wgmma, TMA, mbarriers) from an
# mma.sync one
KEY_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA", "LDSM", "LDS",
               "STS", "BAR")


def compile_tree(root: Path, label: str) -> tuple:
    """(library path, ptxas log) of root's flash_attention.cu."""
    src = root / "flexam_tpu_torch" / "csrc" / "flash_attention.cu"
    out_dir = build.BUILD_ROOT.parent / "attention_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libab.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr[-4000:]}")
    return lib, res.stdout + res.stderr


def ptxas_resources(log: str) -> dict:
    """{kernel: "Used N registers, ... / spill line"} from `ptxas -v`."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = next((k for k in KERNELS if k in m.group(1)), None)
        elif fn and ("registers" in line or "spill" in line):
            out.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    return {k: " / ".join(v) for k, v in out.items()}


def wgmma_notes(log: str) -> list:
    """ptxas's notes on wgmma (e.g. instructions serialized)."""
    return [ln.strip() for ln in log.splitlines() if "wgmma" in ln]


def key_opcodes(ops: dict) -> dict:
    """{kernel: {opcode: count}} of KEY_OPCODES, matched on the opcode's
    stem (HGMMA.64x128x16.F32.BF16 counts as HGMMA)."""
    return {k: {op: sum(n for name, n in c.items()
                        if name.split(".")[0] == op) for op in KEY_OPCODES}
            for k, c in ops.items()}


def sass_opcodes(lib: Path) -> dict:
    """{kernel: Counter of SASS opcodes} from cuobjdump; the listing is
    written beside the library."""
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    lib.with_name(lib.parent.name + ".sass").write_text(text)
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((k for k in KERNELS if k in m.group(1)), None)
            if fn:
                out[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m:
            out[fn][m.group(1)] += 1
    return out


def load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    for name in ENTRY_POINTS:
        fn = getattr(dll, name)
        fn.argtypes = build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return dll


def dynamic_smem(dll) -> int | None:
    """Dynamic shared memory a B1/B2 CTA takes, where the library says
    (trees before the Hopper design use static shared memory only)."""
    fn = getattr(dll, "flexam_attention_smem_bytes", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def launcher(dll, name, q, k, v, out):
    b, lq, h, d = q.shape
    fn = getattr(dll, name)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            b, h, lq, k.shape[1], d, d ** -0.5 * LOG2E,
            build.stream_handle(q))

    def run():
        build.check(fn(*args), name)
    return run


def leg_ms(run, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        run()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="LABEL=DIR, repeatable")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: needs a CUDA card")
    trees = {lb: Path(d).resolve()
             for lb, d in (o.split("=", 1) for o in args.other)}
    first = next(iter(trees))
    trees["this"] = Path(__file__).resolve().parents[2]
    libs, res = {}, {}
    for label, root in trees.items():
        lib, log = compile_tree(root, label)
        libs[label] = load(lib)
        ops = sass_opcodes(lib)
        keys = key_opcodes(ops)
        res[label] = {k: {"ptxas": ptxas_resources(log).get(k),
                          "dynamic_smem_bytes": dynamic_smem(libs[label]),
                          "key_opcodes": keys.get(k),
                          "sass_instructions": sum(ops.get(k, {}).values())}
                      for k in KERNELS}
        res[label]["wgmma_notes"] = wgmma_notes(log)
        res[label]["_ops"] = ops
    diff = {}
    for label in trees:
        if label == first:
            continue
        for k in KERNELS:
            a = res[first]["_ops"].get(k, {})
            b = res[label]["_ops"].get(k, {})
            diff.setdefault(label, {})[k] = {
                op: [a.get(op, 0), b.get(op, 0)]
                for op in sorted(set(a) | set(b)) if a.get(op, 0) != b.get(op, 0)}
    for label in trees:
        del res[label]["_ops"]
    print(json.dumps({"resources": res, f"opcode_count_diff_vs_{first}": diff,
                      "trees": {k: str(v) for k, v in trees.items()}}),
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    B, H, D, L, LT = 2, 24, 128, 11648, 512

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q = randn(B, L, H, D)
    cases = {"B1 flash_kernel": ("flexam_flash_attention", randn(B, L, H, D),
                                 randn(B, L, H, D)),
             "B2 single_kv_kernel": ("flexam_single_kv_attention",
                                     randn(B, LT, H, D), randn(B, LT, H, D))}
    within, timing, failed = {}, {}, []
    for case, (name, k, v) in cases.items():
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: launcher(libs[lb], name, q, k, v, outs[lb])
                for lb in trees}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        ref = attention_plain(q, k, v, q_chunk=1024)
        within[case] = {}
        for lb in trees:
            try:
                err = check_attention(outs[lb], ref, f"{case} {lb}")
                within[case][lb] = {"within": True, **{
                    key: err[key] for key in ("max_abs_err",
                                              "max_err_over_bound")}}
            except AssertionError as e:
                within[case][lb] = {"within": False, "error": str(e)[:300]}
                failed.append(f"{case} {lb}")
        within[case]["equal_to_this"] = {
            lb: bool(torch.equal(outs[lb], outs["this"]))
            for lb in trees if lb != "this"}
        del ref
        legs = {lb: [] for lb in trees}
        order = list(trees)
        for _ in range(args.rounds):
            for lb in order + order[::-1]:
                legs[lb].append(leg_ms(runs[lb]))
        timing[case] = {lb: {"legs_ms": v, "median_ms": statistics.median(v),
                             f"over_{first}": statistics.median(v)
                             / statistics.median(legs[first])}
                        for lb, v in legs.items()}
    print(json.dumps({"within_bound": within}), flush=True)
    print(json.dumps({"timing": timing}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if failed:
        print(f"attention_ab: outside check_attention's bound: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
