"""Device-mesh construction for multi-device / multi-host scaling.

The reference's only distribution mechanism is single-host NCCL
data-parallel Caffe (``caffe/src/caffe/parallel.cpp:117-340``) plus
round-robin multi-GPU inference (``wrapperAuxiliary.hpp:159-286``).
This engine instead declares a 2-D logical mesh:

  * ``dp`` — frame/keyframe parallelism (the round-robin axis, but with
    collectives available for map fusion and pose-graph reduction);
  * ``sp`` — point-block parallelism inside a frame (scatter the 307k
    backprojected points of a 640x480 depth image; GN normal equations
    reduce over this axis with psum).

The mesh follows the algorithm alone: the cards of one host reach each
other all-to-all at one rate. Across hosts, ``dp`` is the axis to span
them, so the per-iteration 6x6 psum over ``sp`` stays inside a host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: Optional[int] = None,
    sp: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, sp) mesh over the available devices.

    With only ``dp`` given, all devices go to the frame axis (the
    multi-GPU-inference topology). ``dp * sp`` must equal the device
    count used.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-frames arrays: leading axis over dp, points over sp."""
    return NamedSharding(mesh, P("dp", "sp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
