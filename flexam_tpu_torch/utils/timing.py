"""Timing and tracing.

Port of `flexam_tpu/utils/timing.py`: named wall-clock spans and counters
dumped as one JSON object, a printing `timer` decorator, and a profiler
trace. A span given `sync=` waits for the card (`torch.cuda.synchronize`)
before it stops the clock, where JAX blocks on its arrays; `torch_profile`
is the counterpart of `jax_profile` (a `torch.profiler` trace of the CPU
and, where there is one, the CUDA device, written as a Chrome trace).
"""

from __future__ import annotations

import functools
import json
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


def _sync(obj) -> None:
    """Wait for the card if `obj` (a tensor, or a list / tuple / dict of
    them) lives on a CUDA device."""
    if isinstance(obj, dict):
        obj = list(obj.values())
    items = obj if isinstance(obj, (list, tuple)) else [obj]
    for t in items:
        if isinstance(t, (list, tuple, dict)):
            _sync(t)
        elif torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class Metrics:
    """Accumulates named wall-clock spans; dumps one JSON object."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}

    @contextmanager
    def span(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps({"spans_s": self.spans, "counters": self.counters},
                       indent=2)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(s)
        return s


metrics = Metrics()


def timer(func):
    """Wall-clock print decorator; the time also goes to `metrics`."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        dt = time.perf_counter() - t0
        print(f"[timer] {func.__name__}: {dt:.3f}s")
        metrics.spans[func.__name__] = metrics.spans.get(
            func.__name__, 0.0) + dt
        return out
    return wrapper


@contextmanager
def torch_profile(logdir: str):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    device), written to `logdir/trace.json` (chrome://tracing format)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
