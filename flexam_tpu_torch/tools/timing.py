"""Device time of a call on a CUDA card, from back-to-back launches.

A pair of CUDA events around one call also counts the host's time between
them (argument checks, allocation, the launch itself), which is a visible
share of a kernel under half a millisecond. `device_ms` records the events
around `launches` calls issued back to back, so the host queues the next
launch while the card runs the last one and only the card's time is
counted, and takes the median over `reps` such runs. That holds while one
call's host time stays below its device time (true of every kernel row
`chip_smoke.py` and `tools/attention_ab.py` time, down to B2's 0.3 ms);
a call that synchronises inside is timed whole, host included.
"""

from __future__ import annotations

import statistics


def device_ms(fn, launches: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Median over `reps` runs of the milliseconds per call of `fn`, each
    run `launches` calls between two CUDA events, after `warmup` untimed
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)
