"""B1-B6 built from several source trees, side by side on one CUDA card.

    python -m flexam_tpu_torch.tools.attention_ab --other LABEL=DIR [...]

Each DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory); this tree is
"this". Each tree's `flexam_tpu_torch/csrc/` kernels (`SOURCES`: the
attention kernels and the row kernels B3, B4) are built by
`build.compile_library`, as the port's library is built, into
`build/attention_ab/<label>/`, where its SASS is written too
(`<label>.sass`); each tree's entry points are bound with the ctypes
signatures of its own `ops/build.py`, and B3's and B4's arguments are
passed by the parameter names of the tree's C declarations. The script
prints one JSON line per result:

  * "resources": each kernel's ptxas registers / spills / static shared
    memory, the dynamic shared memory a CTA takes (where the tree's library
    reports it), any ptxas note on wgmma, the counts of the opcodes that
    tell the designs apart (HGMMA, IGMMA, UTMALDG, ...) and of 128-bit
    global loads and stores (LDG.E.128 / STG.E.128, any suffix), its SASS
    instruction count, and the opcodes whose counts differ from the first
    other tree's. A kernel instantiated for several row widths (B3, B4) is
    reported at the flagship width's instantiation (`FLAGSHIP_NV`), one
    instantiated for several head dims (B1, B2, B5, B6) at head dim 128,
    and again at head dim 256 (`<kernel><256>`, `D256_KERNELS`); B1 and B2
    also in fp32 (`<kernel><f32>`, `F32_KERNELS`);
  * "within_bound": each build's output held to the plain version by the
    kernel's check in `testing` (the designs sum in different orders, so
    their outputs are compared with the bound, not bit for bit), with the
    worst element's error over its bound;
  * "timing": B1 at the flagship self-attention shape (q/k/v
    [2, 11648, 24, 128] bf16), B2 (k/v [2, 512, 24, 128]), B5 (the w=2
    policy: 26 blocks of 896) and B6 at the long-clip shape (q/k/v
    [2, 23296, 24, 128]), B4 (binary and broadcast) and B3 at the flagship
    shape (x [2, 11648, 3072] bf16), B4 binary and B3 with the RIFLEx
    tables at the long path's (x [2, 23296, 3072]); B1, B2, B5 and B6 again
    in 12 heads of 256 ("d256/...": the tokens and widths of the rows
    above) and in fp32 at head dim 128 ("f32/...", TF32); B1 at FLUX's
    joint attention, q/k/v [1, 2304, 24, 128] and the ragged
    [1, 2072, 24, 128] ("B1 flash_kernel FLUX ..."), and at two lengths
    whose last round takes no tail split on 132 SMs, [1, 4096, 24, 128]
    (a tail over half a round) and [1, 2816, 24, 128] (whole rounds)
    ("B1 flash_kernel unsplit ..."); the trees in
    order and then in reverse order (repeated), each leg
    `timing.device_ms` (20 back-to-back launches between two events, the
    median of 5 such runs; 5 and 3 for a call of SLOW_MS or more), each
    tree's median over the first's. B6 times its kernel alone, on q/k
    quantized once by this tree's wrapper. B1 and B2 also time SDPA
    (`F.scaled_dot_product_attention` on [B, H, L, D] views, the yardstick
    `chip_smoke.py` times) in the same rounds, and every attention row gives
    each leg's share of its bound (operations at the type's peak). B3/B4
    also time `out.copy_(x)` in the same rounds (what the card streams)
    and give each tree's GB/s and share of the bound (x read and the
    output written once at 3.35 TB/s). B4 gets the main path's terms:
    strided views of a [B, 2, 6, D] modulation tensor where the tree's
    entry point takes strides, contiguous copies (made once) where it does
    not;
  * "sweep": each tree's B2 and SDPA over 64 to 512 keys in steps of 64
    (`device_ms` each) at head dim 256 ("d256": q [2, 11648, 12, 256]) and
    at head dim 128 in bf16 ("d128") and fp32 ("f32": q [2, 11648, 24,
    128]), and each leg's least-squares line through its 8 times
    ("sweep_fit": `sweep_fit`), which splits a work item's fixed cost from
    the cost of 64 more keys; and each tree's B1 and SDPA at batch 1, 24
    heads of 128 over 1,024 to 4,608 tokens in steps of 256 ("b1"), with
    the work items and the tail split (t, s) each tree takes, which show
    the steps of B1's rounds;

then a "clocks" line where `nvidia-smi` is found: the SM clock and power
draw it sampled every 100 ms, their medians over each timed case's legs
of each tree (a card held at its power limit lowers its clock), and the
nvidia-smi name and power limit. `--cases` keeps the timed cases whose
names hold one of its words (all by default; the sweep always runs).
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
import threading
import time
from datetime import datetime
from pathlib import Path

import torch
import torch.nn.functional as F

from flexam_tpu_torch.core.rope import build_video_rope, make_rope_tables
from flexam_tpu_torch.ops import build
from flexam_tpu_torch.ops.flash_attention import (LOG2E, attention_plain,
                                                  b1_split, split_workspace,
                                                  vt_workspace)
from flexam_tpu_torch.ops.fused import ln_modulation_plain, rmsnorm_rope_plain
from flexam_tpu_torch.ops.int8_attention import (int8_attention_plain,
                                                 quantize_qk)
from flexam_tpu_torch.ops.sparse_attention import (masked_dense_attention,
                                                   rows_to_arrays,
                                                   video_sparse_policy)
from flexam_tpu_torch.testing import (check_attention, check_attention_tf32,
                                      check_int8_attention,
                                      check_int8_attention_tf32,
                                      check_ln_modulation, check_rmsnorm_rope,
                                      check_sparse_attention,
                                      check_sparse_attention_tf32)
from flexam_tpu_torch.tools.timing import device_ms

ENTRY_POINTS = ("flexam_flash_attention", "flexam_single_kv_attention",
                "flexam_sparse_attention", "flexam_int8_attention",
                "flexam_ln_modulation", "flexam_rmsnorm_rope",
                "flexam_flash_attention_f32",
                "flexam_single_kv_attention_f32",
                "flexam_sparse_attention_f32", "flexam_int8_attention_f32")
KERNELS = ("flash_kernel", "single_kv_kernel", "sparse_attention_kernel",
           "int8_attention_kernel", "ln_mod_kernel", "rmsnorm_rope_kernel",
           "flash_wide_kernel", "single_kv_wide_kernel",
           "sparse_attention_wide_kernel", "int8_attention_wide_kernel",
           "ln_mod_f32_kernel", "rmsnorm_rope_f32_kernel")
# the attention kernels reported again at their head-dim-256 instance
D256_KERNELS = ("flash_kernel", "single_kv_kernel", "sparse_attention_kernel",
                "int8_attention_kernel")
# and at their fp32 (head dim 128) instance
F32_KERNELS = ("flash_kernel", "single_kv_kernel")
# the row kernels' instantiation at the flagship width (3072 features: 12
# 16-byte vectors a lane)
FLAGSHIP_NV = 12
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 tensor-core peak
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core peak
SLOW_MS = 10.0               # calls this long: 5 launches a run, 3 runs
# opcodes that tell a Hopper design (wgmma: HGMMA for bf16, IGMMA for int8;
# TMA; mbarriers) from an mma.sync one (HMMA, IMMA), and B6's int -> float
# conversions (I2F, I2FP)
KEY_OPCODES = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "SYNCS", "HMMA", "IMMA",
               "LDSM", "LDS", "STS", "BAR", "I2F", "I2FP", "MUFU")


SOURCES = ("flash_attention.cu", "sparse_attention.cu", "int8_attention.cu",
           "ln_modulation.cu", "rmsnorm_rope.cu")


def compile_tree(root: Path, label: str) -> tuple:
    """(library path, ptxas log) of root's attention kernels, built as
    `ops/build.py` builds the port's library."""
    csrc = root / "flexam_tpu_torch" / "csrc"
    out_dir = build.BUILD_ROOT.parent / "attention_ab" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libab.so"
    log, _ = build.compile_library([csrc / f for f in SOURCES], lib)
    return lib, log


def c_params(root: Path, source: str, entry: str) -> list:
    """Parameter names of the C entry point `entry` in root's csrc/`source`
    (empty if the source does not declare it)."""
    src = (root / "flexam_tpu_torch" / "csrc" / source).read_text()
    params = re.search(rf"int {entry}\(([^)]*)\)", src)
    if not params:
        return []
    return [re.findall(r"\w+", p)[-1] for p in params.group(1).split(",")
            if p.strip()]


def takes_counter(root: Path) -> bool:
    """Whether root's B5 entry point takes a work counter (the Hopper B5
    does; the mma.sync one before it does not), read from the parameter
    names of its C declaration."""
    return "counter" in c_params(root, "sparse_attention.cu",
                                 "flexam_sparse_attention")


def kernel_label(symbol: str):
    """The kernel of KERNELS a (mangled) symbol names, with its template
    argument where it has one: an int ("ln_mod_kernel<12>"), the head dim
    of a bf16 plan ("flash_kernel<128>"; `SplitPlan<d, ...>` is "<d>",
    `D256Plan<keys>` of trees before it "<256>"), or "f32" for an fp32
    instance ("flash_kernel<f32>", `F32SplitPlan` too,
    "flash_wide_kernel<f32>"); None for any other symbol."""
    for k in KERNELS:
        i = symbol.find(k)
        if i >= 0:
            rest = symbol[i + len(k):]
            nv = re.match(r"ILi(\d+)E", rest)
            if nv:
                return f"{k}<{nv.group(1)}>"
            plan = re.match(r"I\w*?(Bf16Plan|F32SplitPlan|F32Plan|D256Plan"
                            r"|SplitPlan)(?:ILi(\d+)E)?", rest)
            if plan:
                name = plan.group(1)
                if name.startswith("F32"):
                    return f"{k}<f32>"
                return f"{k}<256>" if name == "D256Plan" \
                    else f"{k}<{plan.group(2)}>"
            return f"{k}<f32>" if rest.startswith("ILb1E") else k
    return None


def flagship(by_label: dict, kernel: str):
    """The entry of `kernel` in a dict keyed by `kernel_label`: the kernel
    itself, or its instantiation at the flagship width (B3, B4:
    FLAGSHIP_NV vectors a lane; B1, B2, B5, B6: head dim 128)."""
    for key in (kernel, f"{kernel}<{FLAGSHIP_NV}>", f"{kernel}<128>"):
        if key in by_label:
            return by_label[key]
    return None


def wide_accesses(ops) -> dict:
    """Counts of 128-bit global loads and stores in a kernel's SASS opcode
    counts (LDG.E.128, LDG.E.128.CONSTANT, STG.E.128, ...)."""
    return {f"{op}.E.128": sum(n for name, n in ops.items()
                               if name.split(".")[0] == op
                               and ".128" in name)
            for op in ("LDG", "STG")}


def tree_signatures(root: Path) -> dict:
    """SIGNATURES of root's own ops/build.py (it imports only torch)."""
    path = root / "flexam_tpu_torch" / "ops" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"_attention_ab_build_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def ptxas_resources(log: str) -> dict:
    """{kernel label: "Used N registers, ... / spill line"} from
    `ptxas -v`."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_label(m.group(1))
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
    """{kernel label: Counter of SASS opcodes} from cuobjdump; the listing
    is written beside the library."""
    tool = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    lib.with_name(lib.parent.name + ".sass").write_text(text)
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
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
    root's own `ops/build.py` (those it has: trees before fp32 lack the
    `_f32` ones)."""
    dll = ctypes.CDLL(str(lib))
    signatures = tree_signatures(root)
    for name in ENTRY_POINTS:
        if name not in signatures:
            continue
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
    B5's CTA takes B1's). B2 ("single_kv_kernel", at head dim 128) and
    "flash_kernel<256>" / "single_kv_kernel<256>": from
    `flexam_attention_smem_bytes_at` where the library has it; the fp32
    "flash_kernel<f32>" / "single_kv_kernel<f32>" from
    `flexam_attention_smem_bytes_f32`."""
    single_kv = int(kernel.startswith("single_kv"))
    if kernel in ("single_kv_kernel", "flash_kernel<256>",
                  "single_kv_kernel<256>"):
        fn = getattr(dll, "flexam_attention_smem_bytes_at", None)
        if fn is not None:
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
            return fn(256 if kernel.endswith("<256>") else 128, single_kv)
        if kernel.endswith("<256>"):
            return None
    if kernel in ("flash_kernel<f32>", "single_kv_kernel<f32>"):
        fn = getattr(dll, "flexam_attention_smem_bytes_f32", None)
        if fn is None:
            return None
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        return fn(single_kv)
    fn = getattr(dll, SMEM_EXPORTS.get(kernel, ""), None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def f32_workspaces(q, k, v) -> tuple:
    """The fp32 pre-pass's outputs (q and k rounded, V^T), as the port's
    wrappers allocate them."""
    return torch.empty_like(q), torch.empty_like(k), vt_workspace(v)


def launcher(dll, name, q, k, v, out):
    """B1 / B2 from `dll` on q, k, v into out (bf16, or fp32 through the
    tree's `_f32` entry point and its workspaces)."""
    b, lq, h, d = q.shape
    ws = f32_workspaces(q, k, v) if q.dtype == torch.float32 else ()
    fn = getattr(dll, name + ("_f32" if ws else ""))
    split = ()
    if (name == "flexam_flash_attention" and not ws
            and hasattr(dll, "flexam_b1_plan")):
        # a tree with the tail split: its split on its own plan, and a
        # workspace of the size it asks for, as its wrapper takes them
        t, s = b1_split(q, k, dll)
        split = ((split_workspace(q, dll).data_ptr() if s > 1 else None), t,
                 s)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(w.data_ptr() for w in ws), out.data_ptr(), None, *split,
            b, h, lq, k.shape[1], d, d ** -0.5 * LOG2E,
            build.stream_handle(q))

    def run():
        build.check(fn(*args), name)
    run.tensors = (q, k, v, out, *ws)   # args holds only their addresses
    run.split = split[1:]
    return run


def sparse_launcher(dll, q, k, v, out, kidx, nnz, blk):
    """B5 from `dll`, with a scratch word for its work counter where the
    tree's entry point takes one (it zeroes the word itself); fp32
    through its `_f32` entry point."""
    b, L, h, d = q.shape
    ws = f32_workspaces(q, k, v) if q.dtype == torch.float32 else ()
    fn = dll.flexam_sparse_attention_f32 if ws else dll.flexam_sparse_attention
    counter = torch.empty(1, dtype=torch.int32, device=q.device)
    lists = [kidx.data_ptr(), nnz.data_ptr()]
    if dll.sparse_takes_counter:
        lists.append(counter.data_ptr())
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(w.data_ptr() for w in ws), out.data_ptr(), *lists,
            b, h, L // blk, blk, kidx.shape[1], d, d ** -0.5 * LOG2E,
            build.stream_handle(q))

    def run():
        build.check(fn(*args), "sparse_attention")
    run.tensors = (q, k, v, out, kidx, nnz, counter, *ws)
    return run


def int8_launcher(dll, quantized, v, out):
    """B6's kernel from `dll` on q/k quantized once (q8, qs, k8, ks); fp32
    v through its `_f32` entry point and a V^T workspace."""
    q8, qs, k8, ks = quantized
    b, lq, h, d = q8.shape
    ws = (vt_workspace(v),) if v.dtype == torch.float32 else ()
    fn = dll.flexam_int8_attention_f32 if ws else dll.flexam_int8_attention
    args = (q8.data_ptr(), k8.data_ptr(), v.data_ptr(),
            *(w.data_ptr() for w in ws), out.data_ptr(),
            qs.data_ptr(), ks.data_ptr(), None, b, h, lq, k8.shape[1], d,
            d ** -0.5 * LOG2E, build.stream_handle(v))

    def run():
        build.check(fn(*args), "int8_attention")
    run.tensors = (*quantized, v, out, *ws)
    return run


def row_launcher(dll, root: Path, entry: str, source: str, values: dict):
    """B3 / B4 from `dll`, its arguments passed by the parameter names of
    root's C declaration of `entry` (`values` maps every name a tree's
    declaration may use to its argument, and "tensors" to the tensors
    behind the pointers)."""
    fn = getattr(dll, entry)
    args = tuple(values[n] for n in c_params(root, source, entry))

    def run():
        build.check(fn(*args), entry)
    run.tensors = values["tensors"]
    return run


def resources(res_ops: dict, ptxas: dict, keys: dict, dll) -> dict:
    """One tree's "resources": each of KERNELS at its flagship
    instantiation, D256_KERNELS again at head dim 256 and F32_KERNELS in
    fp32."""
    names = [(k, flagship) for k in KERNELS] + [
        (f"{k}<{t}>", lambda by, key: by.get(key))
        for t, ks in (("256", D256_KERNELS), ("f32", F32_KERNELS))
        for k in ks]
    return {k: {"ptxas": pick(ptxas, k),
                "dynamic_smem_bytes": dynamic_smem(dll, k),
                "key_opcodes": pick(keys, k),
                "wide_accesses": wide_accesses(pick(res_ops, k) or {}),
                "sass_instructions": sum((pick(res_ops, k) or {}).values())}
            for k, pick in names}


def sweep_fit(times: dict, items_per_sm: float) -> dict:
    """The least-squares line through one leg's sweep, `times` {keys: ms}:
    its value at 0 keys (the fixed cost) and its slope per 64 keys, in ms
    and in µs of one work item (the ms over the items a persistent CTA
    walks, `items_per_sm` on average)."""
    xs = [k / 64 for k in times]
    ys = list(times.values())
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) \
        / sum((x - mx) ** 2 for x in xs)
    fixed = my - slope * mx
    return {"fixed_ms": fixed, "per_64_keys_ms": slope,
            "fixed_us_an_item": fixed * 1e3 / items_per_sm,
            "per_64_keys_us_an_item": slope * 1e3 / items_per_sm}


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W), sampled by
    `nvidia-smi -lms` in the background, each sample with its time; `over`
    gives the medians of the samples inside a list of (start, end) windows
    of `time.time()`."""

    def __init__(self, period_ms: int = 100):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                stamp, mhz, watts = (f.strip() for f in line.split(","))
                t = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
                self.samples.append((t.timestamp(), float(mhz),
                                     float(watts)))
            except ValueError:
                continue

    def over(self, windows) -> dict:
        inside = [(mhz, w) for t, mhz, w in list(self.samples)
                  if any(a <= t <= b for a, b in windows)]
        if not inside:
            return {"samples": 0}
        return {"samples": len(inside),
                "sm_mhz_median": statistics.median(m for m, _ in inside),
                "sm_mhz_min": min(m for m, _ in inside),
                "power_w_median": statistics.median(w for _, w in inside)}

    def stop(self):
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.thread.join(timeout=30)


def attention_bound_ms(flops: float, nbytes: float, peak: float) -> float:
    """The least time of an attention call: its operations at `peak` or
    its bytes at PEAK_BYTES, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="LABEL=DIR, repeatable")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="time only the cases whose names hold one of these "
                         "words (e.g. d256 f32 B1)")
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
        res[label] = resources(ops, ptxas_resources(log), key_opcodes(ops),
                               libs[label])
        res[label]["wgmma_notes"] = wgmma_notes(log)
        res[label]["_ops"] = ops
    diff = {}
    for label in trees:
        if label == first:
            continue
        for k in [*KERNELS, *(f"{k}<256>" for k in D256_KERNELS),
                  *(f"{k}<f32>" for k in F32_KERNELS)]:
            a = flagship(res[first]["_ops"], k) or {}
            b = flagship(res[label]["_ops"], k) or {}
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

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def attention_case(name, q, k, v):
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: launcher(libs[lb], name, q, k, v, outs[lb])
                for lb in trees}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        check = check_attention_tf32 if q.dtype == torch.float32 \
            else check_attention
        return runs, outs, lambda: attention_plain(q, k, v, q_chunk=1024), \
            check

    def sparse_case(q, k, v):
        pol = video_sparse_policy(51, 448, ref_tokens=448, window=2)
        rows, blk = pol["rows"], pol["blk"]
        kidx, nnz = (torch.from_numpy(a).to(dev)
                     for a in rows_to_arrays(rows))
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: sparse_launcher(libs[lb], q, k, v, outs[lb], kidx, nnz,
                                    blk)
                for lb in trees}
        check = check_sparse_attention_tf32 if q.dtype == torch.float32 \
            else check_sparse_attention
        return runs, outs, lambda: masked_dense_attention(q, k, v, rows,
                                                          blk), check

    def int8_case(q, k, v):
        quantized = quantize_qk(q, k)
        outs = {lb: torch.empty_like(q) for lb in trees}
        runs = {lb: int8_launcher(libs[lb], quantized, v, outs[lb])
                for lb in trees}
        check = check_int8_attention_tf32 if q.dtype == torch.float32 \
            else check_int8_attention
        return runs, outs, lambda: int8_attention_plain(q, k, v), check

    def sparse_flops(q):
        b, n, h, d = q.shape
        pol = video_sparse_policy(51, 448, ref_tokens=448, window=2)
        pairs = sum(len(r) for r in pol["rows"])
        return 4.0 * b * h * pairs * pol["blk"] ** 2 * d

    def rows_x(L):
        """x [B, L, 3072] bf16 whose rows have their own offset and scale,
        as DiT hidden states have (so B4's mean subtraction matters)."""
        f = torch.float32
        return (randn(B, L, H * D, dtype=f)
                * torch.exp(0.5 * randn(B, L, 1, dtype=f))
                + 4.0 * randn(B, L, 1, dtype=f)).to(torch.bfloat16)

    def ln_case(x, binary):
        b, s, d = x.shape
        mod = randn(b, 2, 6, d, dtype=torch.float32)   # the main path's terms
        sh, sc = (mod[:, :, 0], mod[:, :, 1]) if binary \
            else (mod[:, 0, 0], mod[:, 0, 1])
        mask = None
        if binary:
            mask = torch.ones((b, s), device=dev)
            mask[:, 448:896] = 0.0       # the first video frame, known
        outs = {lb: torch.empty_like(x) for lb in trees}
        runs = {}
        for lb, root in trees.items():
            strided = "sh_b" in c_params(root, "ln_modulation.cu",
                                         "flexam_ln_modulation")
            tsh, tsc = (sh, sc) if strided else (sh.contiguous(),
                                                 sc.contiguous())
            runs[lb] = row_launcher(libs[lb], root, "flexam_ln_modulation",
                                    "ln_modulation.cu", dict(
                x=x.data_ptr(), shift=tsh.data_ptr(), scale=tsc.data_ptr(),
                mask=mask.data_ptr() if binary else None,
                out=outs[lb].data_ptr(), rows=b * s, B=b, S=s, D=d,
                sh_b=tsh.stride(0), sh_r=tsh.stride(1) if binary else 0,
                sc_b=tsc.stride(0), sc_r=tsc.stride(1) if binary else 0,
                eps=1e-6, stream=build.stream_handle(x),
                tensors=(x, tsh, tsc, mask, outs[lb])))
        nbytes = 4.0 * x.numel() + 4.0 * 2 * sh.numel() \
            + (4.0 * mask.numel() if binary else 0.0)
        return runs, outs, lambda: ln_modulation_plain(x, sh, sc, mask=mask), \
            lambda got, ref, name: check_ln_modulation(got, ref, sh, mask,
                                                       name), nbytes

    def rms_case(x, grid, riflex=None):
        b, s, d = x.shape
        gamma = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(x.dtype)
        tables = torch.from_numpy(make_rope_tables(D, 1024, riflex=riflex))
        cos, sin = (t.float().contiguous() for t in
                    build_video_rope(tables.to(dev), grid, D))
        outs = {lb: torch.empty_like(x) for lb in trees}
        runs = {lb: row_launcher(libs[lb], root, "flexam_rmsnorm_rope",
                                 "rmsnorm_rope.cu", dict(
            x=x.data_ptr(), gamma=gamma.data_ptr(), cos_t=cos.data_ptr(),
            sin_t=sin.data_ptr(), out=outs[lb].data_ptr(), rows=b * s, B=b,
            S=s, D=d, dh=D, L_rot=cos.shape[0], eps=1e-6,
            stream=build.stream_handle(x),
            tensors=(x, gamma, cos, sin, outs[lb])))
            for lb, root in trees.items()}
        nbytes = 4.0 * x.numel() + 2.0 * d + 4.0 * 2 * cos.numel()
        return runs, outs, lambda: rmsnorm_rope_plain(
            x, gamma, cos, sin, H).reshape(b, s, d), check_rmsnorm_rope, nbytes

    within, timing, failed = {}, {}, []
    # each timed leg's (start, end), for the clocks line
    windows = {}
    sampler = ClockSampler() if shutil.which("nvidia-smi") else None

    def wanted(case: str) -> bool:
        return args.cases is None or any(w in case for w in args.cases)

    def run_case(case, runs, outs, ref_fn, check, nbytes=None, bound=None):
        """Hold each tree's output to the plain version, then time the
        trees in turns; a row kernel (`nbytes` given) has `out.copy_(x)`
        timed beside it, with the copy's bytes (x read, out written); an
        attention kernel (`bound` ms given) each leg's share of it, and
        SDPA where `runs` holds it."""
        trees_runs = {lb: r for lb, r in runs.items() if lb in trees}
        for run in trees_runs.values():
            run()
        torch.cuda.synchronize()
        ref = ref_fn()
        within[case] = {}
        for lb in trees_runs:
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
            for lb in trees_runs if lb != "this"}
        splits = {lb: r.split for lb, r in trees_runs.items()
                  if getattr(r, "split", None)}
        if splits:
            within[case]["tail_split"] = splits
        del ref
        timed = dict(runs)
        x = None
        if nbytes is not None:
            x = next(iter(runs.values())).tensors[0]
            copy_out = torch.empty_like(x)
            timed["copy"] = lambda: copy_out.copy_(x)
        slow = device_ms(trees_runs["this"], launches=1, reps=1,
                         warmup=1) >= SLOW_MS
        kw = dict(launches=5, reps=3) if slow else {}
        legs = {lb: [] for lb in timed}
        order = list(timed)
        for _ in range(args.rounds):
            for lb in order + order[::-1]:
                t0 = time.time()
                legs[lb].append(device_ms(timed[lb], **kw))
                windows.setdefault(case, {}).setdefault(lb, []).append(
                    (t0, time.time()))
        timing[case] = {lb: {"legs_ms": v, "median_ms": statistics.median(v),
                             f"over_{first}": statistics.median(v)
                             / statistics.median(legs[first])}
                        for lb, v in legs.items()}
        if nbytes is not None:
            for lb, t in timing[case].items():
                moved = 4.0 * x.numel() if lb == "copy" else nbytes
                t.update(gbps=moved / t["median_ms"] / 1e6,
                         bound_share=moved / PEAK_BYTES * 1e3 / t["median_ms"])
        if bound is not None:
            timing[case]["bound_ms"] = bound
            for lb, t in timing[case].items():
                if lb != "bound_ms":
                    t["bound_share"] = bound / t["median_ms"]

    def attention_rows(prefix, h, d, dtype, peak):
        """B1, B2, B5 and B6 on `h` heads of `d` in `dtype`, the tokens of
        the flagship (B1, B2) and of the long clip (B5, B6)."""
        size = torch.finfo(dtype).bits // 8
        q = randn(B, L, h, d, dtype=dtype)
        for case, name, lk in (("B1 flash_kernel", "flexam_flash_attention",
                                L),
                               ("B2 single_kv_kernel",
                                "flexam_single_kv_attention", LT)):
            if not wanted(prefix + case):
                continue
            k, v = randn(B, lk, h, d, dtype=dtype), randn(B, lk, h, d,
                                                          dtype=dtype)
            bound = attention_bound_ms(
                4.0 * B * h * L * lk * d,
                size * (2 * q.numel() + k.numel() + v.numel()), peak)
            run_case(prefix + case, *attention_case(name, q, k, v),
                     bound=bound)
            del k, v
        del q
        cases = [c for c in ("B5 sparse_attention_kernel",
                             "B6 int8_attention_kernel")
                 if wanted(prefix + c)]
        if not cases:
            return
        q, k, v = (randn(B, LL, h, d, dtype=dtype) for _ in range(3))
        nbytes = size * 4.0 * q.numel()
        ops = 2.0 * B * h * LL * LL * d
        for c in cases:
            if c.startswith("B5"):
                run_case(prefix + c, *sparse_case(q, k, v),
                         bound=attention_bound_ms(sparse_flops(q), nbytes,
                                                  peak))
            else:
                t_ops = (ops / PEAK_INT8_OPS + ops / peak) * 1e3
                run_case(prefix + c, *int8_case(q, k, v),
                         bound=max(t_ops, nbytes / PEAK_BYTES * 1e3))
        del q, k, v

    attention_rows("", H, D, torch.bfloat16, PEAK_BF16_FLOPS)
    # B1 at FLUX.1-Depth's joint attention: 512x896 (2,304 tokens) and the
    # ragged 480x832 (2,072); and at 4,096 and 2,816 tokens, whose 768 and
    # 528 work items leave a last round over half full and none on 132 SMs
    for case, lf in (("B1 flash_kernel FLUX 2304", 2304),
                     ("B1 flash_kernel FLUX' 2072", 2072),
                     ("B1 flash_kernel unsplit 4096", 4096),
                     ("B1 flash_kernel unsplit 2816", 2816)):
        if wanted(case):
            q, k, v = (randn(1, lf, H, D) for _ in range(3))
            run_case(case, *attention_case("flexam_flash_attention", q, k, v),
                     bound=attention_bound_ms(4.0 * H * lf * lf * D,
                                              2.0 * 4 * q.numel(),
                                              PEAK_BF16_FLOPS))
            del q, k, v
    rows = [("B4 ln_mod_kernel binary", L, lambda x: ln_case(x, True)),
            ("B4 ln_mod_kernel broadcast", L, lambda x: ln_case(x, False)),
            ("B3 rmsnorm_rope_kernel", L,
             lambda x: rms_case(x, (26, 16, 28))),
            ("long/B4 ln_mod_kernel binary", LL,
             lambda x: ln_case(x, True)),
            ("long/B3 rmsnorm_rope_kernel riflex", LL,
             lambda x: rms_case(x, (52, 16, 28),
                                riflex={"k": 6, "L_test": 51}))]
    x = None
    for case, n, make in rows:
        if not wanted(case):
            continue
        if x is None or x.shape[1] != n:
            x = rows_x(n)
        run_case(case, *make(x))
    del x
    attention_rows("d256/", H // 2, 2 * D, torch.bfloat16, PEAK_BF16_FLOPS)
    attention_rows("f32/", H, D, torch.float32, PEAK_TF32_FLOPS)
    sweep, fits = {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, h, d, dtype in (("d256", H // 2, 2 * D, torch.bfloat16),
                              ("d128", H, D, torch.bfloat16),
                              ("f32", H, D, torch.float32)):
        q = randn(B, L, h, d, dtype=dtype)
        sweep[name] = {}
        for lk in range(64, LT + 1, 64):
            k, v = (randn(B, lk, h, d, dtype=dtype) for _ in range(2))
            runs = attention_case("flexam_single_kv_attention", q, k, v)[0]
            sweep[name][lk] = {lb: device_ms(run) for lb, run in runs.items()}
        del q, k, v
        items = -(-L // 128) * h * B
        fits[name] = {lb: sweep_fit({lk: t[lb] for lk, t in sweep[name].items()},
                                    items / sms)
                      for lb in sweep[name][LT]}
    # B1 at batch 1, 24 heads over 1,024..4,608 tokens: the steps of its
    # rounds of work items (ceil(L / 128) x 24 on the card's SMs) and the
    # tail split each tree takes
    sweep["b1"] = {}
    for lf in range(1024, 4608 + 1, 256):
        q, k, v = (randn(1, lf, H, D) for _ in range(3))
        runs = attention_case("flexam_flash_attention", q, k, v)[0]
        sweep["b1"][lf] = {lb: device_ms(run) for lb, run in runs.items()}
        sweep["b1"][lf]["items"] = -(-lf // 128) * H
        sweep["b1"][lf]["tail_split"] = {
            lb: r.split for lb, r in runs.items()
            if getattr(r, "split", None)}
    del q, k, v
    print(json.dumps({"sweep": sweep, "sweep_fit": fits}), flush=True)
    print(json.dumps({"within_bound": within}), flush=True)
    print(json.dumps({"timing": timing}), flush=True)
    if sampler is not None:
        sampler.stop()
        print(json.dumps({"clocks": {
            case: {lb: sampler.over(w) for lb, w in by.items()}
            for case, by in windows.items()}}), flush=True)
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
