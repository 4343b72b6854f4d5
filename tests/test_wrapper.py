"""The Perception facade (perception/wrapper.py) — the reference
Wrapper API surface (wrapper.hpp:73-227): typed configure structs,
construction-time sanity checks, exec / start+pop / emplace_and_pop."""

import numpy as np
import pytest

from perception.wrapper import (
    Perception,
    PerceptionDatum,
    WrapperStructFace,
    WrapperStructGui,
    WrapperStructHand,
    WrapperStructInput,
    WrapperStructOutput,
    WrapperStructPose,
)


def _frames(n=3, hw=(96, 96)):
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, hw + (3,), np.uint8) for _ in range(n)]


def test_sanity_checks():
    with pytest.raises(ValueError, match="no extractor"):
        Perception(pose=WrapperStructPose(enabled=False))
    with pytest.raises(ValueError, match="hand extraction needs pose"):
        Perception(pose=WrapperStructPose(enabled=False),
                   face=WrapperStructFace(enabled=True),
                   hand=WrapperStructHand(enabled=True))
    with pytest.raises(ValueError, match="multiples of 8"):
        Perception(pose=WrapperStructPose(net_hw=(100, 100)))
    with pytest.raises(ValueError, match="scale"):
        Perception(pose=WrapperStructPose(scales=()))
    with pytest.raises(ValueError, match="fps_keep"):
        Perception(input=WrapperStructInput(source=[], fps_keep=-1.0))
    with pytest.raises(ValueError, match="video container"):
        Perception(output=WrapperStructOutput(video_path="out.xyz"))


def test_emplace_and_pop_pose_only():
    p = Perception(pose=WrapperStructPose(topology="COCO_18",
                                          net_hw=(64, 64), top_n=2))
    datum = p.emplace_and_pop(_frames(1)[0])
    assert isinstance(datum, PerceptionDatum)
    assert datum.people is not None
    # keep_top_n_people keeps the static capacity; only the mask caps.
    assert int(np.asarray(datum.people.mask).sum()) <= 2
    assert datum.faces is None and datum.hands is None


def test_exec_over_array_source(tmp_path):
    frames = _frames(4)
    p = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64)),
        input=WrapperStructInput(source=frames, frame_limit=3),
        output=WrapperStructOutput(json_dir=str(tmp_path / "json")),
    )
    data = list(p.exec())
    assert len(data) == 3
    assert sorted(f.name for f in (tmp_path / "json").iterdir()) == [
        "people_000000.json", "people_000001.json", "people_000002.json",
    ]


def test_async_start_stop():
    frames = _frames(3)
    p = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64)),
        input=WrapperStructInput(source=frames),
    )
    p.start()
    got = []
    while True:
        d = p.wait_and_pop(timeout=60.0)
        if d is None:
            break
        got.append(d)
    p.stop()
    assert [d.frame_index for d in got] == [0, 1, 2]


@pytest.mark.slow  # ~25 s on the 2-core CI host (CI-budget triage, r5);
# the facade's multi-face assembly is also covered by
# tests/test_face_multi.py::test_facade_returns_per_face_slots
def test_fixture_pipelines_if_available():
    """Full pose+face+hand assembly when the trained fixtures exist
    (they are checked into tests/fixtures)."""
    from perception.models import face_fixture as FF
    from perception.models import hand_fixture as HF
    from perception.models import pose_fixture as PF

    if not (PF.fixture_available() and FF.fixture_available()
            and HF.fixture_available()):
        pytest.skip("trained fixtures not present")
    p = Perception(
        pose=WrapperStructPose(topology=PF.FIXTURE_TOPOLOGY,
                               net_hw=PF.FIXTURE_HW),
        face=WrapperStructFace(enabled=True, max_faces=3),
        hand=WrapperStructHand(enabled=True, top_n_people=2),
    )
    datum = p.emplace_and_pop(_frames(1, hw=(128, 128))[0])
    assert datum.people is not None
    assert datum.faces is not None and "head_pose" in datum.faces
    # Multi-face slots: (max_faces, ...) arrays.
    assert datum.faces["head_pose"].shape == (3, 4, 4)
    assert datum.faces["mask"].shape == (3,)
    # Both hands for the top-N people: (N, 2[left,right], 21, ...).
    assert datum.hands is not None and "landmarks" in datum.hands
    assert datum.hands["landmarks"].shape == (2, 2, 21, 2)
    assert datum.hands["boxes"].shape == (2, 2, 4)
    assert datum.hands["box_valid"].shape == (2, 2)
