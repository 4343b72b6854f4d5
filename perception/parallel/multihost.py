"""Multi-host process runtime: ``jax.distributed`` bootstrap + global meshes.

This is the layer the reference's NCCL worker bootstrap occupies
(``openpose/3rdparty/caffe/src/caffe/parallel.cpp:117-340``: spawn one
worker per device, broadcast weights, all-reduce gradients). The
replacement here is process-level: every host runs the *same*
SPMD program, ``jax.distributed.initialize`` wires the processes into
one runtime (coordinator handshake = the ``ncclCommInitRank`` analog),
and a single global :class:`jax.sharding.Mesh` spans every device of
every process. Collectives (`psum`, `all_gather`, ...) under
``shard_map`` then ride the host's card-to-card links within a host and
the network across hosts — no hand-written reduction loops.

Layout convention (see ``parallel/mesh.py``): the ``dp`` (frame/keyframe)
axis maps across processes — cross-host traffic is the small 6x6 /
Schur-block psums — while ``sp`` (point blocks) stays within a process
so the bandwidth-heavy point-axis reductions stay inside a host.

Tested without a cluster via the posture SURVEY.md §4(e) prescribes:
N OS processes on localhost, each holding a slice of virtual CPU
devices, with gloo cross-process collectives
(``tests/test_multihost.py`` spawns the workers and asserts
sharded == single-process bitwise agreement).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Join this process into a multi-process JAX runtime.

    Call once per process before any other JAX API touches a backend.
    The three arguments are always explicit (``localhost:<port>`` for a
    single machine), so localhost CPU fleets (tests, CI) and GPU hosts
    share one code path.

    ``local_device_count`` (CPU only): carve this many virtual devices
    out of the host platform for this process — the fake-backend
    multi-host posture of SURVEY.md §4(e).
    """
    backend = os.environ.get("JAX_PLATFORMS", "").strip() or None
    if backend and "cpu" in backend:
        if local_device_count is not None:
            flags = os.environ.get("XLA_FLAGS", "")
            if "host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={local_device_count}"
                ).strip()
        # Cross-process CPU collectives need a real transport; gloo is
        # the one baked into jaxlib.
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_coordinator() -> bool:
    """True on the process that should do singleton side effects
    (checkpoint writes, metric logging) — process 0 by convention."""
    return jax.process_index() == 0


def global_mesh(sp: Optional[int] = None, dp: Optional[int] = None) -> Mesh:
    """Build the (dp, sp) mesh over ALL devices of ALL processes.

    Default layout puts ``sp`` = local device count (point-block axis
    inside a host) and ``dp`` = the remaining factor, which for one
    process per host is exactly the process axis (across hosts).
    Devices are ordered process-major, so reshaping the
    global device list to (dp, sp) keeps each mesh row within one
    process.
    """
    devices = jax.devices()
    n = len(devices)
    if sp is None:
        sp = jax.local_device_count() if dp is None else n // dp
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} global devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def shard_host_data(
    mesh: Mesh, spec: P, local_data: np.ndarray, global_shape: Sequence[int]
) -> jax.Array:
    """Assemble a global sharded array from per-process host data.

    Each process passes only ITS slice (`local_data`); the result is a
    single logical `jax.Array` of `global_shape` addressable by every
    process — the input convention for the distributed ICP/BA steps.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_data), global_shape=tuple(global_shape)
    )


def replicate_host_data(mesh: Mesh, data: np.ndarray) -> jax.Array:
    """Replicated global array (same `data` passed by every process)."""
    return shard_host_data(mesh, P(), data, np.asarray(data).shape)


def fetch_replicated(x: jax.Array) -> np.ndarray:
    """Bring a (replicated-output) global array to host on every process."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=False))


def sync(name: str = "barrier") -> None:
    """Cross-process barrier (debug/checkpoint ordering)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
