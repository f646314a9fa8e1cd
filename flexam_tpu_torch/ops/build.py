"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by ONE `nvcc -shared` call for `sm_90a`
into `build/flexam_tpu_torch/<hash>/libflexam_kernels.so` at the root of the
checkout (a directory git ignores), at first use. The sources carry a plain
`extern "C"` interface and include no PyTorch header, so the build takes
seconds; the library is bound with `ctypes`. The hash covers the sources and
the flags, so an edited source builds anew.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "flexam_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flexam_single_kv_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _P],
    "flexam_rmsnorm_rope": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flexam_ln_modulation": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (or reuse a build of the same sources); returns
    the library's path and fills `build_info`."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libflexam_kernels.so"
    if lib_path.exists():
        build_info.update(seconds=None, cached=True, path=str(lib_path))
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libflexam_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    build_info.update(seconds=seconds, cached=False, path=str(lib_path),
                      log=str(out_dir / "nvcc.log"))
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


def stream_handle(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
