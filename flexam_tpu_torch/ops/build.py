"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled for `sm_90a` by its own `nvcc -c`, all
started together, and the objects are linked by one `nvcc -shared` into
`build/flexam_tpu_torch/<hash>/libflexam_kernels.so` at the root of the
checkout (a directory git ignores), at first use. The sources carry a plain
`extern "C"` interface and include no PyTorch header, so the build takes
seconds (the longest source's compile); the library is bound with `ctypes`.
The hash covers the sources and the flags, so an edited source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "flexam_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "flexam_flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _F, _P],
    "flexam_single_kv_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _P],
    "flexam_flash_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _F, _P],
    "flexam_single_kv_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _F, _P],
    "flexam_attention_smem_bytes": [],
    "flexam_b1_plan": [_P],
    "flexam_b1_split_workspace_bytes": [_I],
    "flexam_attention_smem_bytes_at": [_I, _I],
    "flexam_attention_smem_bytes_f32": [_I],
    "flexam_rmsnorm_rope": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flexam_rmsnorm_rope_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _P],
    "flexam_ln_modulation": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _F, _P],
    "flexam_ln_modulation_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _F, _P],
    "flexam_sparse_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _F, _P],
    "flexam_sparse_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
    "flexam_int8_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _P],
    "flexam_int8_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _F, _P],
    "flexam_int8_attention_smem_bytes": [],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # {"seconds": float | None, "cached": bool, "path": str}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                           "the port's CUDA kernels cannot be built")
    return path


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def compile_library(srcs: list, lib_path: Path) -> tuple:
    """Compile each of `srcs` by its own `nvcc -c`, all started together,
    and link the objects into `lib_path`; returns (nvcc's output, which
    holds ptxas's -v report, and the seconds the compiles took). Raises if
    a compile or the link fails."""
    out_dir = lib_path.parent
    tag = os.getpid()
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = out_dir / f"{Path(src).stem}.{tag}.o"
        jobs.append((Path(src), obj, subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode}):\n{out[-4000:]}")
    compile_seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"{lib_path.stem}.{tag}.so"
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                          *[str(obj) for _, obj, _ in jobs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib_path)
    return log, compile_seconds


def build() -> Path:
    """Compile the kernels (or reuse a build of the same sources); returns
    the library's path and fills `build_info`."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libflexam_kernels.so"
    if lib_path.exists():
        build_info.update(seconds=None, cached=True, path=str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        log, compile_seconds = compile_library(sorted(CSRC.glob("*.cu")),
                                               lib_path)
    except RuntimeError as e:
        (out_dir / "nvcc.log").write_text(str(e))
        raise
    (out_dir / "nvcc.log").write_text(log)
    build_info.update(seconds=time.perf_counter() - t0,
                      compile_seconds=compile_seconds, cached=False,
                      path=str(lib_path), log=str(out_dir / "nvcc.log"))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise NotImplementedError if autograd would record a kernel launch:
    grad mode on and any tensor argument requiring grad. The kernels write
    their outputs through raw pointers, so an output would carry no
    `grad_fn` and `backward()` would drop every gradient through it without
    an error. JAX's Pallas kernels have no gradient either; training takes
    the differentiable torch ops that JAX's training takes."""
    if not torch.is_grad_enabled():
        return
    if any(torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (nor has JAX's Pallas "
            "kernel); to train, run with FLEXAM_FUSED=0 "
            "FLEXAM_ATTENTION=xla (the differentiable torch ops), or call "
            "it under torch.no_grad() / torch.inference_mode()")


def stream_handle(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
