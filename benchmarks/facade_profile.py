"""Per-extractor facade latency breakdown on the GPU.

Times the wrapper's jitted step with each extractor subset enabled
(pose / face / hands / all) on the same 256x256 3-face scene, so the
all-on frame time decomposes into its stages.

Run: python -m benchmarks.facade_profile
"""

from __future__ import annotations

import json
import time


def time_engine(pose=False, face=False, hand=False, frames=60):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from perception.models import face_fixture as FF
    from perception.models import pose_fixture as PF
    from perception.models.face_data import render_faces, sample_face_at
    from perception.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructHand,
        WrapperStructPose,
    )

    hw = (256, 256)
    engine = Perception(
        pose=WrapperStructPose(enabled=pose, topology=PF.FIXTURE_TOPOLOGY,
                               net_hw=PF.FIXTURE_HW),
        face=WrapperStructFace(enabled=face, max_faces=4),
        hand=WrapperStructHand(enabled=hand, top_n_people=2),
    )
    key = jax.random.key(0)
    offs = [(-0.14, -0.14), (0.14, -0.14), (0.0, 0.14)]
    scenes = [
        sample_face_at(jax.random.fold_in(key, i), hw, FF.FIXTURE_FX,
                       FF.FIXTURE_FX, o, 0.62)
        for i, o in enumerate(offs)
    ]
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scenes)
    imgs = [
        jnp.asarray(
            np.repeat(
                np.asarray(
                    render_faces(stacked, hw, key=jax.random.fold_in(key, 100 + t))
                )[..., None],
                3, axis=-1,
            ),
            jnp.float32,
        )
        for t in range(8)
    ]
    jax.block_until_ready(imgs[-1])
    d = engine.emplace_and_pop(imgs[0], frame_index=0)
    for probe in (getattr(d.people, "keypoints", None) if d.people else None,
                  d.faces["landmarks"] if d.faces else None,
                  d.hands["landmarks"] if d.hands else None):
        if probe is not None:
            jax.block_until_ready(probe)
    t0 = time.perf_counter()
    last = None
    for t in range(frames):
        last = engine.emplace_and_pop(imgs[t % len(imgs)], frame_index=t + 1)
    for probe in (getattr(last.people, "keypoints", None) if last.people else None,
                  last.faces["landmarks"] if last.faces else None,
                  last.hands["landmarks"] if last.hands else None):
        if probe is not None:
            jax.block_until_ready(probe)
    dt = time.perf_counter() - t0
    return 1000.0 * dt / frames


def main() -> None:
    rows = []
    for name, kw in [
        ("pose only", dict(pose=True)),
        ("face only", dict(face=True)),
        ("pose+hands", dict(pose=True, hand=True)),
        ("all on", dict(pose=True, face=True, hand=True)),
    ]:
        ms = time_engine(**kw)
        row = {"config": name, "ms_per_frame": round(ms, 2),
               "fps": round(1000.0 / ms, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
