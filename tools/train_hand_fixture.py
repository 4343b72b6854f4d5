"""Train the tiny hand fixture on synthetic hand scenes.

Usage: python tools/train_hand_fixture.py [--steps 3000] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--target-px", type=float, default=1.5)
    ap.add_argument("--pixel-noise", type=float, default=0.25,
                    help="max per-scene Gaussian noise level (fraction of "
                         "255) — robustness augmentation, FIXTURES.md")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from perception.models.hand_data import make_hand_batch
    from perception.models.hand_fixture import (
        FIXTURE_PATH,
        evaluate,
        init_tiny,
        save_fixture,
        tiny_handnet,
    )

    print(f"backend: {jax.default_backend()}", flush=True)
    params = init_tiny(jax.random.key(0))
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"params: {n_params/1e3:.1f}k", flush=True)

    net = tiny_handnet()
    sched = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.05)
    optimizer = optax.adam(sched)
    opt_state = optimizer.init(params)

    @jax.jit
    def step_fn(p, o, k):
        batch = make_hand_batch(k, args.batch, pixel_noise=args.pixel_noise)

        def loss_fn(p):
            maps = net.apply(p, batch["crop"])
            return jnp.mean((maps - batch["heatmaps"]) ** 2) * 100.0

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = optimizer.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    key = jax.random.key(1)
    best = float("inf")
    t0 = time.time()
    for step in range(1, args.steps + 1):
        key, bk = jax.random.split(key)
        params, opt_state, loss = step_fn(params, opt_state, bk)
        if step % args.eval_every == 0 or step == args.steps:
            err = evaluate(params, jax.random.key(99))
            print(
                f"step {step}: loss={float(loss):.5f} lm_err={err:.2f}px "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
            if err <= best:
                best = err
                save_fixture(params, args.out or FIXTURE_PATH)
            if err <= args.target_px:
                print("target reached", flush=True)
                break

    print(f"best lm err {best:.2f}px; fixture at {args.out or FIXTURE_PATH}")
    return 0 if best <= 4.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
