"""Device timing: host clock around work that ends in
``jax.block_until_ready`` (without it a timing measures the enqueue).

Use ``bench_ms(fn, *args)`` for every speed number recorded in this
repo, and report it with the card's name and power limit.
"""

from __future__ import annotations

import time

import jax
import numpy as np


def bench_ms(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0


def bench_ms_median(fn, *args, iters: int = 10, reps: int = 3) -> float:
    """Median of ``reps`` independent bench_ms runs."""
    return float(np.median([bench_ms(fn, *args, iters=iters)
                            for _ in range(reps)]))
