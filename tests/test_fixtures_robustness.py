"""Held-out generator families (FIXTURES.md): the trained fixtures must
degrade gracefully, not fall over, on data the training generator never
produced. Marked slow: full sweeps run via tools/fixtures_robustness."""

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.slow


def test_pose_held_out_families():
    from perception.models import pose_fixture as PF
    from perception.models.pose_data import render_people, sample_skeletons

    if not PF.fixture_available():
        pytest.skip("pose fixture missing")
    params = PF.load_fixture()
    hw = PF.FIXTURE_HW

    # r5: the fixture trains WITH crowded scenes (n_people<=4 +
    # pixel-noise augmentation, tools/train_pose_fixture.py), fixing
    # the r4 crowded-recall regression at its source — the loosened
    # 0.6 floor from commit 70722da is restored to 0.8 (VERDICT r4
    # item 5; training-time crowd_recall gate >= 0.85 at save).
    for scale, n_people, min_recall in (((0.30, 0.45), 2, 0.8),
                                        ((0.75, 0.92), 2, 0.8),
                                        ((0.45, 0.75), 4, 0.8)):
        keys = jax.random.split(jax.random.key(11), 6)
        scenes = jax.vmap(
            lambda k: sample_skeletons(k, hw, n_people=n_people,
                                       scale_range=scale)
        )(keys)
        images = np.array(jax.vmap(lambda s: render_people(s, hw))(scenes))
        pck, recall = PF.pck_on_images(params, images, scenes)
        assert pck > 0.6, (scale, n_people, pck)
        assert recall > min_recall, (scale, n_people, recall)


def test_pose_noise_degradation_bounded():
    from perception.models import pose_fixture as PF
    from perception.models.pose_data import render_people, sample_skeletons

    if not PF.fixture_available():
        pytest.skip("pose fixture missing")
    params = PF.load_fixture()
    hw = PF.FIXTURE_HW
    keys = jax.random.split(jax.random.key(12), 6)
    scenes = jax.vmap(lambda k: sample_skeletons(k, hw))(keys)
    images = np.array(jax.vmap(lambda s: render_people(s, hw))(scenes))
    rng = np.random.RandomState(0)
    noisy = np.clip(images + rng.randn(*images.shape) * 0.15, 0, 1)
    pck, recall = PF.pck_on_images(params, noisy, scenes)
    assert pck > 0.6 and recall > 0.8, (pck, recall)


def test_face_hand_held_out():
    from perception.models import face_fixture as FF
    from perception.models import hand_fixture as HF

    if not (FF.fixture_available() and HF.fixture_available()):
        pytest.skip("face/hand fixtures missing")
    fp = FF.load_fixture()
    err, sep, iou = FF.evaluate(fp, jax.random.key(13), n_scenes=8,
                                z_range=(0.75, 0.95))
    assert err < 4.0 and iou > 0.4, (err, iou)
    err_n, _, _ = FF.evaluate(fp, jax.random.key(14), n_scenes=8,
                              pixel_noise=0.10)
    assert err_n < 5.0, err_n

    # r5: face training widened to rot 0.50 rad — the AU02 publish gate
    # must keep a POSITIVE raised/neutral separation on tilted heads
    # (the r4 fixture flipped to -0.13 at 0.45 rad, FIXTURES.md).
    _, sep_rot, _ = FF.evaluate(fp, jax.random.key(16), n_scenes=8,
                                rot_range=0.45)
    assert sep_rot > 0.0, sep_rot

    # r5: hand training noise-augmented (<=0.25) — noise 0.2 landmark
    # error must stay within the <=5 px target (r4 recorded 10.07 px).
    hp = HF.load_fixture()
    he = HF.evaluate(hp, jax.random.key(15), n_scenes=8, pixel_noise=0.10)
    assert he < 5.0, he
    he2 = HF.evaluate(hp, jax.random.key(17), n_scenes=8, pixel_noise=0.20)
    assert he2 < 5.0, he2
