"""Train the tiny face fixture (landmark net + AU head) on synthetic
face scenes.

Runs on whatever backend JAX picks (the GPU when available; pass --cpu to
force CPU). Writes tests/fixtures/facenet_tiny.msgpack when the
landmark-error target is reached.

Usage: python tools/train_face_fixture.py [--steps 3000] [--cpu]
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
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--target-px", type=float, default=2.0)
    ap.add_argument("--rot-range", type=float, default=0.50,
                    help="training head-rotation range (rad); covers the "
                         "0.45 rad held-out family where the r4 fixture's "
                         "AU02 gate mis-fired (FIXTURES.md)")
    ap.add_argument("--pixel-noise", type=float, default=0.12,
                    help="max per-scene noise level (fraction of 255)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from perception.models.face import normalize_landmarks
    from perception.models.face_data import make_face_batch
    from perception.models.face_fixture import (
        FIXTURE_CROP,
        FIXTURE_HW,
        FIXTURE_PATH,
        evaluate,
        init_tiny,
        save_fixture,
        tiny_au_head,
        tiny_facenet,
    )

    print(f"backend: {jax.default_backend()}", flush=True)
    params = init_tiny(jax.random.key(0))
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"params: {n_params/1e3:.1f}k", flush=True)

    from perception.models.face_fixture import tiny_detector

    lm_net = tiny_facenet()
    au_net = tiny_au_head()
    det_net = tiny_detector()

    sched = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.05)
    optimizer = optax.adam(sched)
    opt_state = optimizer.init(params)

    def loss_fn(p, batch):
        maps = lm_net.apply(p["landmark"], batch["crop"])
        lm_loss = jnp.mean((maps - batch["heatmaps"]) ** 2) * 100.0
        # AU head trains on GT crop landmarks (at inference it consumes
        # the landmark net's decode — same normalization).
        def au_one(uv, au_t):
            inten, _ = au_net.apply(
                p["au"], normalize_landmarks(uv, jnp.ones(uv.shape[0], bool))
            )
            return jnp.mean((inten - au_t) ** 2)

        au_loss = jnp.mean(jax.vmap(au_one)(batch["uv_crop"], batch["au"]))

        # Detector: MSE heat + center-weighted log-size regression.
        heat, size = jax.vmap(
            lambda im: det_net.apply(p["det"], im[..., None] / 255.0)
        )(batch["image"])
        det_loss = jnp.mean((heat - batch["det_heat"]) ** 2) * 20.0
        wsum = jnp.maximum(jnp.sum(batch["det_weight"]), 1.0)
        size_loss = (
            jnp.sum(batch["det_weight"] * (size - batch["det_size"]) ** 2) / wsum
        )
        return lm_loss + 0.1 * au_loss + det_loss + 0.2 * size_loss

    @jax.jit
    def step_fn(p, o, k):
        batch = {
            k2: v
            for k2, v in make_face_batch(
                k, args.batch,
                rot_range=args.rot_range, pixel_noise=args.pixel_noise,
            ).items()
            if k2 != "scene"
        }
        loss, grads = jax.value_and_grad(loss_fn)(p, batch)
        updates, o = optimizer.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    key = jax.random.key(1)
    best_err = float("inf")
    t0 = time.time()
    for step in range(1, args.steps + 1):
        key, bk = jax.random.split(key)
        params, opt_state, loss = step_fn(params, opt_state, bk)
        if step % args.eval_every == 0 or step == args.steps:
            err_px, au_sep, det_iou = evaluate(params, jax.random.key(99))
            # Held-out tilt family: the r4 fixture's AU02 separation
            # flipped negative here (FIXTURES.md) — monitor + gate.
            _, au_sep_rot, _ = evaluate(
                params, jax.random.key(98), rot_range=0.45
            )
            print(
                f"step {step}: loss={float(loss):.5f} lm_err={err_px:.2f}px "
                f"au02_sep={au_sep:.2f} au02_sep@0.45rad={au_sep_rot:.2f} "
                f"det_iou={det_iou:.2f} ({time.time()-t0:.0f}s)",
                flush=True,
            )
            if err_px <= best_err and au_sep_rot > 0.0:
                best_err = err_px
                save_fixture(params, args.out or FIXTURE_PATH)
            if (err_px <= args.target_px and au_sep > 1.0
                    and au_sep_rot > 0.3 and det_iou > 0.6):
                print("target reached", flush=True)
                break

    print(f"best lm err {best_err:.2f}px; fixture at {args.out or FIXTURE_PATH}")
    return 0 if best_err <= 4.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
