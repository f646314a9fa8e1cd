"""One launcher for a mesh of ranks on one host, shared by the tests and the
smoke.

    result = launch.run(fn, world, *args)

spawns `world` processes, initialises a gloo process group among them
over `tcp://localhost:<a free port>` (MASTER_ADDR / MASTER_PORT are set to
the same), pins each rank's torch to one CPU thread, calls `fn(*args)` in
every rank and returns rank 0's result (tensors in it brought to the
host). If a rank raises, the others are stopped and the exception is
raised here with every rank's exit code and the last line of each failed
rank's traceback (the first rank seen to fail may only have lost a peer
that failed first): no rank's failure passes silently.

`fn` must import in a fresh interpreter: a module-level function of a
module on `sys.path` (the parent's `sys.path` goes to the ranks), or a
"module:name" string. The worker entry `_worker` is a function of this
package for that reason: under `spawn` the child imports the target by
name.

On several cards, `torchrun --nproc_per_node N script.py` starts the ranks
instead, and `make_mesh` initialises the group from its environment.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Callable, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target_name(fn: Union[str, Callable]) -> str:
    if isinstance(fn, str):
        return fn
    return f"{fn.__module__}:{fn.__qualname__}"


def _resolve(name: str) -> Callable:
    mod, _, attr = name.partition(":")
    obj = sys.modules["__main__"] if mod == "__main__" else \
        importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def to_host(obj):
    """obj with every tensor in it detached and on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _worker(rank: int, world: int, port: int, target: str, sys_path: list,
            args_path: str, timeout_s: float, out_path: str) -> None:
    """One rank: join the group, run the target, rank 0 writes the result.
    The group is gloo: NCCL refuses two ranks on one card, and ranks that
    share a card are what this launcher is for (`torchrun` starts ranks on
    several).
    The arguments come from a file: handed to each child through its
    start-up pipe, a large pickle would hold the parent until that child
    had imported torch, and the ranks would start one after another."""
    for p in reversed(sys_path):
        if p not in sys.path:
            sys.path.insert(0, p)
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        with open(args_path, "rb") as f:
            args, kwargs = pickle.load(f)
        result = _resolve(target)(*args, **kwargs)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(to_host(result), f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_report(ctx) -> str:
    """Each rank's exit code and, where it raised, its traceback's last
    line."""
    lines = ["-- every rank:"]
    for i, (proc, path) in enumerate(zip(ctx.processes, ctx.error_files)):
        last = ""
        if path and os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                last = pickle.load(f).strip().splitlines()[-1]
        lines.append(f"rank {i}: exit code {proc.exitcode} {last}".rstrip())
    return "\n".join(lines)


def run(fn: Union[str, Callable], world: int, *args, timeout: float = 600.0,
        run_timeout: float = 3600.0, **kwargs):
    """Run fn(*args, **kwargs) on `world` ranks; rank 0's result (see the
    module docstring). `timeout` bounds each collective's wait,
    `run_timeout` the whole run: past it every rank is stopped and
    TimeoutError raised."""
    tmp = tempfile.mkdtemp(prefix="flexam_launch_")
    out_path = str(Path(tmp) / "rank0.pkl")
    args_path = str(Path(tmp) / "args.pkl")
    ctx = None
    try:
        with open(args_path, "wb") as f:
            pickle.dump((args, kwargs), f)
        ctx = mp.start_processes(
            _worker, args=(world, free_port(), _target_name(fn),
                           list(sys.path), args_path, float(timeout),
                           out_path),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + run_timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world} ranks of {fn} did not "
                                       f"end within {run_timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"{e}\n{_rank_report(ctx)}") from None
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
