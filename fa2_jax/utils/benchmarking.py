"""Wall-clock timing of jitted functions on the device.

JAX dispatches asynchronously, so a timing that does not end in
`block_until_ready` measures the enqueue. `device_time` compiles and warms
the function, then times `iters` back-to-back calls that end in one
`block_until_ready`, and reports the median of `reps` such windows.
"""
from __future__ import annotations

import time
from typing import Callable

import jax


def device_time(fn: Callable, *args, iters: int = 20, reps: int = 3) -> float:
    """Median per-call time (seconds) of jit(fn)(*args)."""
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / iters)
    ts.sort()
    return ts[len(ts) // 2]
