"""Example 03 — human-pose keypoints from an image.

The OpenPose flow (poseExtractorCaffe.cpp:202-340): two-branch CNN ->
heatmap NMS with subpixel refinement -> PAF line-integral pair scoring
-> greedy skeleton assembly — all inside one jitted call, at a tiny net
resolution (the reference CI smoke-runs with --net_resolution -1x32 the
same way).

Part 2 runs the *trained* tiny PoseNet fixture (weights trained in-repo
on synthetic skeleton scenes — tools/train_pose_fixture.py) and
recovers actual multi-person skeletons from a rendered image.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from perception.models.pose import (  # noqa: E402
    TOPOLOGIES,
    extract_people,
    init_posenet,
)
from perception.utils.keypoints import keep_top_n_people  # noqa: E402


def main() -> None:
    topology = "COCO_18"
    net_hw = (64, 64)
    parts, pairs = TOPOLOGIES[topology]
    print(f"topology {topology}: {len(parts)} parts, {len(pairs)} limb pairs")

    params = init_posenet(jax.random.key(0), topology, net_hw=net_hw)
    image = jax.random.uniform(jax.random.key(1), (96, 96, 3))

    people = jax.block_until_ready(
        jax.jit(
            lambda p, im: extract_people(p, im, topology, scales=(1.0,), net_hw=net_hw)
        )(params, image)
    )
    kp = np.asarray(people.keypoints)
    n = int(np.asarray(people.mask).sum())
    print(f"people detected (random weights, so ~noise): {n}; "
          f"keypoint tensor {kp.shape}")

    top_kp, top_scores, top_mask = keep_top_n_people(
        people.keypoints, people.score, people.mask, n=2
    )
    print(f"keep_top_n_people(2) -> {int(np.asarray(top_mask).sum())} kept "
          f"of capacity {top_kp.shape[0]}")

    # --- part 2: trained fixture -> real skeletons from a real image ---
    from perception.models.pose_fixture import (
        FIXTURE_HW,
        evaluate_pck,
        fixture_available,
        load_fixture,
    )

    if not fixture_available():
        print("trained fixture absent (run tools/train_pose_fixture.py); "
              "skipping part 2")
        return
    trained = load_fixture()
    pck, recall = evaluate_pck(trained, jax.random.key(7), n_scenes=2)
    print(f"trained tiny PoseNet on fresh synthetic scenes: "
          f"PCK={pck:.2f}, person recall={recall:.2f}")
    assert recall > 0.5, "trained net failed to find people"


def main_facade() -> None:
    """The same pipeline through the Perception facade (wrapper.py) —
    the reference Wrapper::emplaceAndPop flow in a few lines."""
    import numpy as np

    from perception.wrapper import (
        Perception,
        WrapperStructInput,
        WrapperStructPose,
    )

    frames = [np.random.RandomState(i).rand(96, 96, 3).astype(np.float32)
              for i in range(2)]
    engine = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64), top_n=2),
        input=WrapperStructInput(source=frames),
    )
    for datum in engine.exec():
        n = int(np.asarray(datum.people.mask).sum())
        print(f"facade frame {datum.frame_index}: {n} people")


if __name__ == "__main__":
    main()
    main_facade()
