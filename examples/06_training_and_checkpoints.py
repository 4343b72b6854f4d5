"""Example 06 — training a pose net + checkpoint/restore.

The Caffe Solver equivalents (solver.cpp, solvers/*.cpp): an optax
solver zoo (sgd/nesterov/adam/rmsprop/adagrad/adadelta), a jitted train
step with optional psum gradient averaging (the NCCL-allreduce analog,
parallel.cpp:117-340), and snapshot/restore of the full train state
(Solver::Snapshot/Restore, solver.cpp:420-480).
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from perception.models.pose import PoseNet, TOPOLOGIES, init_posenet  # noqa: E402
from perception.models.train import (  # noqa: E402
    init_train_state,
    make_optimizer,
    make_train_step,
    restore,
    snapshot,
)


def main() -> None:
    topology = "MPI_15"
    net_hw = (32, 32)
    parts, pairs = TOPOLOGIES[topology]
    net = PoseNet(num_parts=len(parts), num_limbs=len(pairs))
    params = init_posenet(jax.random.key(0), topology, net_hw=net_hw)

    optimizer = make_optimizer(learning_rate=1e-3, kind="adam")
    step = make_train_step(net.apply, optimizer)
    state = init_train_state(params, optimizer)

    # Synthetic supervision: random images against fixed target maps.
    key = jax.random.key(1)
    h8, w8 = net_hw[0] // 8, net_hw[1] // 8
    batch = {
        "image": jax.random.uniform(key, (2, *net_hw, 3)),
        "paf": jnp.zeros((2, h8, w8, 2 * len(pairs))),
        "heatmap": jnp.zeros((2, h8, w8, len(parts) + 1)).at[..., -1].set(1.0),
    }

    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    print("loss curve:", " -> ".join(f"{l:.4f}" for l in losses))
    assert losses[-1] < losses[0], "loss should decrease on a fixed batch"

    # Snapshot -> perturb -> restore (Solver::Snapshot/Restore).
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "solver_iter_5.npz"
        snapshot(path, state)
        state2 = restore(path, like=state)
    same = jax.tree.all(
        jax.tree.map(lambda a, b: jnp.allclose(a, b), state.params, state2.params)
    )
    print(f"restored step = {int(state2.step)}, params bit-stable = {bool(same)}")
    assert bool(same) and int(state2.step) == 5


if __name__ == "__main__":
    main()
