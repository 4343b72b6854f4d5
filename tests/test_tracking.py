import jax
import jax.numpy as jnp
import numpy as np

from perception.models.tracking import TrackerConfig, tracker_init, tracker_step


def textured(seed=0, h=120, w=160):
    rng = np.random.RandomState(seed)
    img = np.kron(rng.rand(h // 8, w // 8) * 200, np.ones((8, 8)))
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, 1.5).astype(np.float32)


def person(cx, cy, parts=5):
    """Simple vertical 5-part skeleton at (cx, cy), (P, 3)."""
    kp = np.zeros((parts, 3), np.float32)
    for p in range(parts):
        kp[p] = (cx, cy + 8 * p, 1.0)
    return kp


def cfg():
    return TrackerConfig(max_tracks=8, num_parts=5, match_threshold_px=20.0,
                         min_shared_parts=3)


def test_new_detections_get_ids():
    c = cfg()
    st = tracker_init(c)
    img = jnp.asarray(textured())
    dets = jnp.asarray(np.stack([person(40, 30), person(100, 40)]))
    mask = jnp.ones(2, bool)
    st, ids = tracker_step(st, img, img, dets, mask, c)
    ids = np.asarray(ids)
    assert set(ids.tolist()) == {0, 1}
    assert int(st.next_id) == 2


def test_ids_stable_across_motion():
    c = cfg()
    st = tracker_init(c)
    img0 = jnp.asarray(textured(0))
    img1 = jnp.asarray(np.roll(np.asarray(img0), 3, axis=1))  # scene shifts 3px right
    dets0 = jnp.asarray(np.stack([person(40, 30), person(100, 40)]))
    mask = jnp.ones(2, bool)
    st, ids0 = tracker_step(st, img0, img0, dets0, mask, c)
    # Next frame: same people moved +3 px x; detection order SWAPPED.
    dets1 = jnp.asarray(np.stack([person(103, 40), person(43, 30)]))
    st, ids1 = tracker_step(st, img0, img1, dets1, mask, c)
    ids0, ids1 = np.asarray(ids0), np.asarray(ids1)
    # The person at x~40 keeps its id despite the order swap.
    assert ids1[1] == ids0[0]
    assert ids1[0] == ids0[1]
    assert int(st.next_id) == 2  # no spurious new ids


def test_far_detection_gets_new_id():
    c = cfg()
    st = tracker_init(c)
    img = jnp.asarray(textured())
    st, ids0 = tracker_step(st, img, img, jnp.asarray(person(40, 30)[None]), jnp.ones(1, bool), c)
    st, ids1 = tracker_step(st, img, img, jnp.asarray(person(130, 80)[None]), jnp.ones(1, bool), c)
    assert np.asarray(ids1)[0] != np.asarray(ids0)[0]


def test_unmatched_track_persists_via_lk():
    c = cfg()
    st = tracker_init(c)
    img = jnp.asarray(textured())
    st, _ = tracker_step(st, img, img, jnp.asarray(person(40, 30)[None]), jnp.ones(1, bool), c)
    # No detections this frame: track should survive with propagated kps.
    st, ids = tracker_step(st, img, img, jnp.zeros((1, 5, 3)), jnp.zeros(1, bool), c)
    assert int((np.asarray(st.ids) >= 0).sum()) == 1
    assert np.asarray(ids)[0] == -1


def test_smoothing_reduces_detection_jitter():
    """PersonTracker smoothing variant (personTracker.cpp): with
    smooth_alpha on, noisy detections of a linearly-moving person yield
    a visibly smoother keypoint trajectory than the raw PersonIdExtractor
    behavior, without losing the true path."""
    rng = np.random.RandomState(3)
    base = np.asarray(textured(0))
    steps = 14
    speed = 2.0  # px/frame, pure x translation of scene and person
    noise = 3.0

    def run(alpha):
        c = TrackerConfig(max_tracks=4, num_parts=5,
                          match_threshold_px=25.0, min_shared_parts=3,
                          smooth_alpha=alpha)
        st = tracker_init(c)
        prev = jnp.asarray(base)
        traj = []
        rng2 = np.random.RandomState(7)
        for t in range(steps):
            img = jnp.asarray(np.roll(base, int(round(speed * (t + 1))), axis=1))
            det = person(40.0 + speed * (t + 1), 30.0)
            det[:, :2] += rng2.randn(5, 2) * noise  # detector jitter
            st, ids = tracker_step(
                st, prev, img, jnp.asarray(det[None]), jnp.ones(1, bool), c
            )
            slot = int(np.asarray(ids)[0])
            assert slot == 0  # single stable id throughout
            track = np.asarray(st.keypoints[np.asarray(st.ids) == 0])[0]
            traj.append(track[0])  # head keypoint
            prev = img
        return np.stack(traj)

    raw = run(0.0)
    smooth = run(0.7)

    def jitter(tr):
        # second-difference magnitude = deviation from constant velocity
        return float(np.mean(np.abs(np.diff(tr, n=2, axis=0))))

    assert jitter(smooth) < 0.6 * jitter(raw), (jitter(smooth), jitter(raw))
    # The smoothed track still follows the true motion.
    gt_x = 40.0 + speed * np.arange(1, steps + 1)
    err = np.abs(smooth[:, 0] - gt_x)
    assert float(err[3:].mean()) < 4.0, err
