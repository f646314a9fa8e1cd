"""B1, B2, B5 and B6 built from several source trees, side by side on one
CUDA card.

    python -m flexam_tpu_torch.tools.attention_ab --other LABEL=DIR [...]

Each DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory); this tree is
"this". Each tree's `flexam_tpu_torch/csrc/{flash,sparse,int8}_attention.cu`
are built as this tree's `ops/build.py` builds its library (one `nvcc -c`
a source, all started together, then one link), into
`build/attention_ab/<label>/`, where its SASS is written too
(`<label>.sass`); each tree's entry points are bound with the ctypes
signatures of its own `ops/build.py`. The script prints one JSON line per
result:

  * "resources": each kernel's ptxas registers / spills / static shared
    memory, the dynamic shared memory a CTA takes (where the tree's library
    reports it), any ptxas note on wgmma, the counts of the opcodes that
    tell the designs apart (HGMMA, IGMMA, UTMALDG, ...), its SASS
    instruction count, and the opcodes whose counts differ from the first
    other tree's;
  * "within_bound": each build's output held to the plain version by the
    kernel's check in `testing` (the designs sum in different orders, so
    their outputs are compared with the bound, not bit for bit), with the
    worst element's error over its bound;
  * "timing": B1 at the flagship self-attention shape (q/k/v
    [2, 11648, 24, 128] bf16), B2 (k/v [2, 512, 24, 128]), and B5 (the
    w=2 policy: 26 blocks of 896) and B6 at the long-clip shape (q/k/v
    [2, 23296, 24, 128]), the trees in order and then in reverse order
    (repeated), each leg the median of CUDA-event-timed launches, and each
    tree's median over the first's. B6 times its kernel alone, on q/k
    quantized once by this tree's wrapper;

then the nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
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
from flexam_tpu_torch.ops.int8_attention import (int8_attention_plain,
                                                 quantize_qk)
from flexam_tpu_torch.ops.sparse_attention import (masked_dense_attention,
                                                   rows_to_arrays,
                                                   video_sparse_policy)
from flexam_tpu_torch.testing import (check_attention, check_int8_attention,
                                      check_sparse_attention)

ENTRY_POINTS = ("flexam_flash_attention", "flexam_single_kv_attention",
                "flexam_sparse_attention", "flexam_int8_attention")
KERNELS = ("flash_kernel", "single_kv_kernel", "sparse_attention_kernel",
           "int8_attention_kernel")
# opcodes that tell a Hopper design (wgmma: HGMMA for bf16, IGMMA for int8;
# TMA; mbarriers) from an mma.sync one (HMMA, IMMA), and B6's int -> float
# conversions (I2F, I2FP)
KEY_OPCODES = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA", "IMMA",
               "LDSM", "LDS", "STS", "BAR", "I2F", "I2FP", "MUFU")


SOURCES = ("flash_attention.cu", "sparse_attention.cu", "int8_attention.cu")


def compile_tree(root: Path, label: str) -> tuple:
    """(library path, ptxas log) of root's attention kernels, built as
    `ops/build.py` builds the port's library."""
    csrc = root / "flexam_tpu_torch" / "csrc"
    out_dir = build.BUILD_ROOT.parent / "attention_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libab.so"
    log, _ = build.compile_library([csrc / f for f in SOURCES], lib)
    return lib, log


def takes_counter(root: Path) -> bool:
    """Whether root's B5 entry point takes a work counter (the Hopper B5
    does; the mma.sync one before it does not), read from the parameter
    names of its C declaration."""
    src = (root / "flexam_tpu_torch" / "csrc" / "sparse_attention.cu"
           ).read_text()
    params = re.search(r"int flexam_sparse_attention\(([^)]*)\)", src)
    return bool(params) and re.search(r"\bcounter\b",
                                      params.group(1)) is not None


def tree_signatures(root: Path) -> dict:
    """SIGNATURES of root's own ops/build.py (it imports only torch)."""
    path = root / "flexam_tpu_torch" / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"_attention_ab_build_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


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


def load(lib: Path, root: Path) -> ctypes.CDLL:
    """root's library, its entry points bound with the ctypes signatures of
    root's own `ops/build.py`."""
    dll = ctypes.CDLL(str(lib))
    signatures = tree_signatures(root)
    for name in ENTRY_POINTS:
        fn = getattr(dll, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    dll.sparse_takes_counter = takes_counter(root)
    return dll


SMEM_EXPORTS = {"flash_kernel": "flexam_attention_smem_bytes",
                "single_kv_kernel": "flexam_attention_smem_bytes",
                "int8_attention_kernel": "flexam_int8_attention_smem_bytes"}


def dynamic_smem(dll, kernel: str) -> int | None:
    """Dynamic shared memory a CTA of `kernel` takes, where the library
    says (trees before the Hopper designs use static shared memory only;
    B5's CTA takes B1's)."""
    fn = getattr(dll, SMEM_EXPORTS.get(kernel, ""), None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def launcher(dll, name, q, k, v, out):
    """B1 / B2 from `dll` on q, k, v into out."""
    b, lq, h, d = q.shape
    fn = getattr(dll, name)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            b, h, lq, k.shape[1], d, d ** -0.5 * LOG2E,
            build.stream_handle(q))

    def run():
        build.check(fn(*args), name)
    run.tensors = (q, k, v, out)      # args holds only their addresses
    return run


def sparse_launcher(dll, q, k, v, out, kidx, nnz, blk):
    """B5 from `dll`, with a scratch word for its work counter where the
    tree's entry point takes one (it zeroes the word itself)."""
    b, L, h, d = q.shape
    fn = dll.flexam_sparse_attention
    counter = torch.empty(1, dtype=torch.int32, device=q.device)
    lists = [kidx.data_ptr(), nnz.data_ptr()]
    if dll.sparse_takes_counter:
        lists.append(counter.data_ptr())
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *lists,
            b, h, L // blk, blk, kidx.shape[1], d, d ** -0.5 * LOG2E,
            build.stream_handle(q))

    def run():
        build.check(fn(*args), "sparse_attention")
    run.tensors = (q, k, v, out, kidx, nnz, counter)
    return run


def int8_launcher(dll, quantized, v, out):
    """B6's kernel from `dll` on q/k quantized once (q8, qs, k8, ks)."""
    q8, qs, k8, ks = quantized
    b, lq, h, d = q8.shape
    fn = dll.flexam_int8_attention
    args = (q8.data_ptr(), k8.data_ptr(), v.data_ptr(), out.data_ptr(),
            qs.data_ptr(), ks.data_ptr(), None, b, h, lq, k8.shape[1], d,
            d ** -0.5 * LOG2E, build.stream_handle(v))

    def run():
        build.check(fn(*args), "int8_attention")
    run.tensors = (*quantized, v, out)
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
        libs[label] = load(lib, root)
        ops = sass_opcodes(lib)
        keys = key_opcodes(ops)
        res[label] = {k: {"ptxas": ptxas_resources(log).get(k),
                          "dynamic_smem_bytes": dynamic_smem(libs[label], k),
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
    B, H, D, L, LT, LL = 2, 24, 128, 11648, 512, 52 * 448

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def attention_case(name, q, k, v):
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: launcher(libs[lb], name, q, k, v, outs[lb])
                for lb in trees}
        return runs, outs, lambda: attention_plain(q, k, v, q_chunk=1024), \
            check_attention

    def sparse_case(q, k, v):
        pol = video_sparse_policy(51, 448, ref_tokens=448, window=2)
        rows, blk = pol["rows"], pol["blk"]
        kidx, nnz = (torch.from_numpy(a).to(dev)
                     for a in rows_to_arrays(rows))
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: sparse_launcher(libs[lb], q, k, v, outs[lb], kidx, nnz,
                                    blk)
                for lb in trees}
        return runs, outs, lambda: masked_dense_attention(q, k, v, rows,
                                                          blk), \
            check_sparse_attention

    def int8_case(q, k, v):
        quantized = quantize_qk(q, k)
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: int8_launcher(libs[lb], quantized, v, outs[lb])
                for lb in trees}
        return runs, outs, lambda: int8_attention_plain(q, k, v), \
            check_int8_attention

    within, timing, failed = {}, {}, []

    def run_case(case, runs, outs, ref_fn, check):
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        ref = ref_fn()
        within[case] = {}
        for lb in runs:
            try:
                err = check(outs[lb], ref, f"{case} {lb}")
                within[case][lb] = {"within": True, **{
                    key: err[key] for key in ("max_abs_err",
                                              "max_err_over_bound")}}
            except AssertionError as e:
                within[case][lb] = {"within": False, "error": str(e)[:300]}
                failed.append(f"{case} {lb}")
        within[case]["equal_to_this"] = {
            lb: bool(torch.equal(outs[lb], outs["this"]))
            for lb in runs if lb != "this"}
        del ref
        legs = {lb: [] for lb in runs}
        order = list(runs)
        for _ in range(args.rounds):
            for lb in order + order[::-1]:
                legs[lb].append(leg_ms(runs[lb]))
        timing[case] = {lb: {"legs_ms": v, "median_ms": statistics.median(v),
                             f"over_{first}": statistics.median(v)
                             / statistics.median(legs[first])}
                        for lb, v in legs.items()}

    q = randn(B, L, H, D)
    for case, name, lk in (("B1 flash_kernel", "flexam_flash_attention", L),
                           ("B2 single_kv_kernel",
                            "flexam_single_kv_attention", LT)):
        k, v = randn(B, lk, H, D), randn(B, lk, H, D)
        run_case(case, *attention_case(name, q, k, v))
    del q, k, v
    q, k, v = randn(B, LL, H, D), randn(B, LL, H, D), randn(B, LL, H, D)
    run_case("B5 sparse_attention_kernel", *sparse_case(q, k, v))
    run_case("B6 int8_attention_kernel", *int8_case(q, k, v))
    print(json.dumps({"within_bound": within}), flush=True)
    print(json.dumps({"timing": timing}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    if failed:
        print(f"attention_ab: outside the check's bound: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
