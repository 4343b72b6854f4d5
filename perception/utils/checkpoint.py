"""Checkpoint/restore of engine state (SLAM keyframes, pose graph,
odometry, pipeline configs).

The reference checkpoints only Caffe training state
(``Solver::Snapshot`` -> .caffemodel/.solverstate protobufs,
``caffe/src/caffe/solver.cpp:420-480``; SIGINT-to-snapshot via
``util/signal_handler.cpp:71-103``). The engine checkpoints its
*perception* state so a crashed host can resume a mapping session:
any NamedTuple/pytree state (e.g. ``SlamState``) round-trips through
orbax (preferred, async-capable) or a plain .npz (fallback, zero deps).

The SIGINT-to-snapshot behavior is available via ``install_snapshot_handler``.
"""

from __future__ import annotations

import signal
from pathlib import Path
from typing import Any, Callable, Optional

import jax
import numpy as np


def _flatten_with_paths(state: Any):
    leaves, treedef = jax.tree_util.tree_flatten(state)
    return leaves, treedef


def save_npz(path, state: Any) -> None:
    """Serialize a pytree of arrays to ``<path>.npz`` (+ treedef str)."""
    leaves, treedef = _flatten_with_paths(state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(str(treedef).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_npz(path, like: Any) -> Any:
    """Restore a pytree saved by save_npz; ``like`` supplies the
    structure (its leaf values are ignored)."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    leaves = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        leaves.append(jax.numpy.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _mask_empty_leaves(state: Any) -> Any:
    """Orbax refuses zero-size arrays; they carry no data, so stand in a
    scalar sentinel (restored from ``like``, which has the real shape)."""
    def mask(leaf):
        arr = np.asarray(leaf)
        if arr.size == 0:
            return np.zeros((1,), np.int32)
        # Bare numpy/python scalars are rejected by orbax's template
        # validation — normalize to 0-d ndarrays.
        return leaf if isinstance(leaf, (np.ndarray, jax.Array)) else arr

    return jax.tree_util.tree_map(mask, state)


def save_orbax(path, state: Any) -> None:
    """Orbax save (falls back to npz if orbax is unavailable)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        save_npz(str(path) + ".npz", state)
        return
    path = Path(path).absolute()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, _mask_empty_leaves(state), force=True)


def load_orbax(path, like: Any) -> Any:
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        return load_npz(str(path) + ".npz", like)
    path = Path(path).absolute()
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(path, _mask_empty_leaves(like))
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    leaves_restored = jax.tree_util.tree_flatten(restored)[0]
    out = [
        ref if np.asarray(ref).size == 0 else got
        for ref, got in zip(leaves_like, leaves_restored)
    ]
    return jax.tree_util.tree_unflatten(treedef, out)


def install_snapshot_handler(
    save_fn: Callable[[], None],
    signals=(signal.SIGINT, signal.SIGTERM),
) -> None:
    """Caffe-style graceful shutdown: on SIGINT/SIGTERM, snapshot then
    re-raise the default behavior (signal_handler.cpp:71-103 semantics)."""
    def handler(signum, frame):
        save_fn()
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)

    for s in signals:
        signal.signal(s, handler)
