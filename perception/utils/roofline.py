"""Roofline accounting for jitted stages.

Per stage: how many FLOPs and device-memory bytes it moves and what
fraction of the card's peaks that achieves, so a stage can be called
bandwidth-bound or latency-bound from more than its wall time.

FLOP/byte counts come from XLA's own compiled cost model
(``compiled.cost_analysis()``) — the same numbers the compiler
schedules with, so they track fusion decisions rather than hand
arithmetic. Peaks come from a table keyed by the full
``device.device_kind``; a device missing from it is an error, never a
default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import jax


class Peaks(NamedTuple):
    f32_tflops: float    # f32 off the tensor cores (HIGHEST-precision dots)
    tf32_tflops: float   # dense tensor cores
    bf16_tflops: float   # dense tensor cores
    hbm_gbps: float
    source: str


# Full device_kind -> published dense peaks (no sparsity), per card.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        67.0, 495.0, 989.0, 3350.0,
        "NVIDIA H100 data sheet, SXM5 column, at the 700 W limit",
    ),
    "NVIDIA H100 PCIe": Peaks(
        51.0, 378.0, 756.0, 2000.0,
        "NVIDIA H100 data sheet, PCIe column, at the 350 W limit",
    ),
}


def device_peaks(device=None) -> Peaks:
    """Published peaks of ``device`` (default: the first JAX device).

    Raises KeyError for a device kind the table does not hold."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    if kind not in _PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add a row with "
            f"its source to perception.utils.roofline._PEAKS"
        )
    return _PEAKS[kind]


@dataclasses.dataclass
class StageRoofline:
    name: str
    ms: float
    flops: Optional[float]          # from XLA cost analysis
    bytes_accessed: Optional[float]
    gflops_per_s: Optional[float] = None
    gbytes_per_s: Optional[float] = None
    f32_pct: Optional[float] = None        # achieved / f32 peak
    hbm_pct: Optional[float] = None        # achieved / HBM BW peak
    intensity: Optional[float] = None      # flops / byte
    bound: str = "unknown"

    def row(self) -> str:
        f = lambda v, fmt: (fmt % v) if v is not None else "    -"
        return (
            f"{self.name:<34} {self.ms:8.3f}  {f((self.flops or 0)/1e9, '%8.3f')} "
            f"{f((self.bytes_accessed or 0)/1e6, '%9.2f')} "
            f"{f(self.gflops_per_s, '%9.1f')} {f(self.gbytes_per_s, '%8.1f')} "
            f"{f(self.f32_pct, '%7.2f')} {f(self.hbm_pct, '%6.1f')} "
            f"{f(self.intensity, '%7.2f')}  {self.bound}"
        )


HEADER = (
    f"{'stage':<34} {'ms':>8}  {'GFLOP':>8} {'MB moved':>9} "
    f"{'GFLOP/s':>9} {'GB/s':>8} {'%F32':>7} {'%HBM':>6} {'FLOP/B':>7}  bound"
)


def cost_of(jitted, *args) -> tuple:
    """(flops, bytes_accessed) from the compiled executable's cost
    analysis; (None, None) when the backend doesn't report them."""
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        if isinstance(ca, list):  # older jax returns [dict]
            ca = ca[0]
        return ca.get("flops"), ca.get("bytes accessed")
    except Exception:
        return None, None


def measure_stage(
    name: str,
    jitted: Callable,
    *args,
    reps: int = 50,
    peaks=None,
) -> StageRoofline:
    """Steady-state time + XLA cost counts + utilization vs peaks.

    Dispatch is pipelined (enqueue reps, block once) so the per-call
    figure is device time, not host round-trips.
    """
    out = jitted(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jitted(*args)
    jax.block_until_ready(out)
    ms = 1e3 * (time.perf_counter() - t0) / reps

    flops, nbytes = cost_of(jitted, *args)
    st = StageRoofline(name=name, ms=ms, flops=flops, bytes_accessed=nbytes)
    if flops is not None:
        st.gflops_per_s = flops / (ms * 1e-3) / 1e9
    if nbytes is not None:
        st.gbytes_per_s = nbytes / (ms * 1e-3) / 1e9
    if flops and nbytes:
        st.intensity = flops / max(nbytes, 1.0)
    if peaks is None:
        peaks = device_peaks()
    if st.gflops_per_s is not None and st.gbytes_per_s is not None:
        f32_tf, hbm = peaks.f32_tflops, peaks.hbm_gbps
        st.f32_pct = 100.0 * st.gflops_per_s / (f32_tf * 1e3)
        st.hbm_pct = 100.0 * st.gbytes_per_s / hbm
        ridge = (f32_tf * 1e3) / hbm  # FLOP/byte where compute == BW
        if st.hbm_pct > 40.0:
            st.bound = "HBM-bw"
        elif st.f32_pct > 40.0:
            st.bound = "compute"
        elif st.intensity is not None and st.intensity < ridge and st.hbm_pct > 3 * st.f32_pct / ridge:
            st.bound = "bw-leaning"
        else:
            st.bound = "latency/serial"
    return st
