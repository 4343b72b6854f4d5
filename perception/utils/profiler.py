"""Stage profiling + structured metrics.

The reference's observability is the OpenPose ``Profiler`` (scoped
timers keyed by call site, averaged every X frames,
``utilities/profiler.hpp:33-66``), ``caffe time``, and
publish-every-intermediate ROS topics. Equivalents here:

  * ``StageTimer`` — named walltime accumulator with
    ``block_until_ready`` discipline (device work must be drained to be
    chargeable) and OpenPose-style print-every-X averaging;
  * ``MetricsLog`` — JSON-lines metrics emitter (frames/s, residuals,
    inlier counts, ATE) replacing topic eyeballing;
  * ``trace`` — context manager around ``jax.profiler`` for on-device
    traces when XLA-level detail is needed.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import jax


class StageTimer:
    def __init__(self, print_every: int = 0):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.print_every = print_every

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        out = {}
        yield out
        # Drain device work attributed to this stage.
        if "result" in out:
            jax.block_until_ready(out["result"])
        elif result is not None:
            jax.block_until_ready(result)
        dt = time.perf_counter() - t0
        self.total[name] += dt
        self.count[name] += 1
        if self.print_every and self.count[name] % self.print_every == 0:
            print(f"[profile] {name}: {self.mean_ms(name):.2f} ms avg over {self.count[name]}")

    def mean_ms(self, name: str) -> float:
        return self.total[name] / max(self.count[name], 1) * 1000.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.total}


class MetricsLog:
    """JSON-lines metrics sink (stdout or file)."""

    def __init__(self, path: Optional[str] = None):
        self.fh = open(path, "a") if path else None

    def emit(self, **fields) -> None:
        line = json.dumps({"ts": time.time(), **fields})
        if self.fh:
            self.fh.write(line + "\n")
            self.fh.flush()
        else:
            print(line)

    def close(self) -> None:
        if self.fh:
            self.fh.close()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
