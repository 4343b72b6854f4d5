"""Training loop for the CNN models (the Caffe Solver capability).

The reference trains its nets with Caffe's Solver (SGD/Adam variants,
``caffe/src/caffe/solver.cpp``, snapshot/restore at ``:420-480``,
NCCL data-parallel in ``parallel.cpp``). Equivalent here:

  * ``TrainState`` + ``make_train_step`` — optax optimizer, jitted
    update, loss = heatmap MSE + PAF MSE (the CMU two-branch loss,
    summed over stages is possible by calling per-stage);
  * data-parallel over the mesh with one ``psum`` of gradients — the
    structural twin of Caffe's per-layer ``ncclAllReduce``
    (``parallel.cpp:227``), expressed as a sharded jit;
  * snapshot/restore delegates to utils/checkpoint (orbax/npz).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jax.Array


def make_optimizer(
    learning_rate: float = 1e-3, kind: str = "adam", weight_decay: float = 0.0
):
    """The solver zoo: sgd/momentum/nesterov/adam/adamw/rmsprop/adagrad/
    adadelta (Caffe ships sgd, adam, rmsprop, adagrad, adadelta,
    nesterov — solver.cpp + solvers/)."""
    if kind == "sgd":
        return optax.sgd(learning_rate)
    if kind == "momentum":
        return optax.sgd(learning_rate, momentum=0.9)
    if kind == "nesterov":
        return optax.sgd(learning_rate, momentum=0.9, nesterov=True)
    if kind == "adam":
        return optax.adam(learning_rate)
    if kind == "adamw":
        return optax.adamw(learning_rate, weight_decay=weight_decay)
    if kind == "rmsprop":
        return optax.rmsprop(learning_rate)
    if kind == "adagrad":
        return optax.adagrad(learning_rate)
    if kind == "adadelta":
        return optax.adadelta(learning_rate)
    raise ValueError(f"unknown optimizer {kind!r}")


def pose_loss(apply_fn, params, batch) -> jax.Array:
    """Two-branch MSE: PAF + heatmap regression with a validity mask
    (masked pixels carry no gradient — unlabeled regions)."""
    paf_pred, hm_pred = apply_fn(params, batch["image"])
    m = batch.get("mask")
    paf_err = (paf_pred - batch["paf"]) ** 2
    hm_err = (hm_pred - batch["heatmap"]) ** 2
    if m is not None:
        paf_err = paf_err * m[..., None]
        hm_err = hm_err * m[..., None]
    return jnp.mean(paf_err) + jnp.mean(hm_err)


def make_train_step(
    apply_fn: Callable,
    optimizer,
    loss_fn: Callable = pose_loss,
    axis_name: Optional[str] = None,
):
    """Jitted SGD step; with ``axis_name`` (inside ``shard_map`` over
    that axis, params replicated) the gradient is the mean over the mesh
    (data-parallel training, NCCL-allreduce analog)."""

    def objective(p, batch):
        loss = loss_fn(apply_fn, p, batch)
        # Replicated params receive the sum of the per-shard cotangents
        # from autodiff itself, so differentiating the mean loss gives
        # the mean gradient; a pmean of the gradients on top of that
        # would count each shard once per device.
        return loss if axis_name is None else jax.lax.pmean(loss, axis_name)

    def step(state: TrainState, batch) -> Tuple[TrainState, jax.Array]:
        loss, grads = jax.value_and_grad(objective)(state.params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), loss

    return jax.jit(step) if axis_name is None else step


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=jnp.int32(0))


def snapshot(path, state: TrainState) -> None:
    from perception.utils.checkpoint import save_orbax

    save_orbax(path, state)


def restore(path, like: TrainState) -> TrainState:
    from perception.utils.checkpoint import load_orbax

    return load_orbax(path, like)
