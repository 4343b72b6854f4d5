import jax
import jax.numpy as jnp
import numpy as np

from perception.models.hand import (
    HandLandmarkNet,
    NUM_HAND_LANDMARKS,
    crop_image,
    extract_hand,
    hand_roi_from_pose,
)
from perception.models.pose import PoseNet
from perception.models.train import (
    init_train_state,
    make_optimizer,
    make_train_step,
    pose_loss,
    restore,
    snapshot,
)


def test_hand_roi_geometry():
    kp = np.zeros((25, 3), np.float32)
    kp[3] = (100, 100, 1.0)   # RElbow
    kp[4] = (140, 100, 1.0)   # RWrist
    box, ok = hand_roi_from_pose(jnp.asarray(kp), arm=(3, 4))
    assert bool(ok)
    box = np.asarray(box)
    cx = (box[0] + box[2]) / 2
    assert abs(cx - 152) < 1e-3  # wrist + 0.3*(wrist-elbow)
    assert box[2] - box[0] > 20


def test_hand_roi_invalid_without_keypoints():
    kp = np.zeros((25, 3), np.float32)
    _, ok = hand_roi_from_pose(jnp.asarray(kp))
    assert not bool(ok)


def test_crop_image_identity_box():
    img = jnp.asarray(np.random.RandomState(0).rand(32, 32).astype(np.float32))
    out = crop_image(img, jnp.array([0.0, 0.0, 32.0, 32.0]), 32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-5)


def test_crop_image_subregion():
    img = jnp.zeros((64, 64))
    img = img.at[20:28, 30:38].set(1.0)
    out = crop_image(img, jnp.array([30.0, 20.0, 38.0, 28.0]), 8)
    assert float(out.mean()) > 0.9  # the crop is the bright block


def test_extract_hand_shapes():
    net = HandLandmarkNet()
    params = net.init(jax.random.key(0), jnp.zeros((1, 64, 64, 1)))
    img = jnp.asarray(np.random.RandomState(1).rand(120, 160).astype(np.float32))
    lms, mask, score = extract_hand(params, img, jnp.array([40.0, 30.0, 104.0, 94.0]))
    assert lms.shape == (NUM_HAND_LANDMARKS, 2)


def test_train_step_reduces_loss():
    # Tiny PoseNet overfitting one synthetic batch.
    net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(8, 8, 8))
    key = jax.random.key(0)
    img = jax.random.uniform(key, (2, 32, 32, 3))
    params = net.init(key, img)
    batch = {
        "image": img,
        "paf": jax.random.normal(jax.random.key(1), (2, 4, 4, 4)) * 0.1,
        "heatmap": jax.random.normal(jax.random.key(2), (2, 4, 4, 4)) * 0.1,
    }
    opt = make_optimizer(1e-3, "adam")
    state = init_train_state(params, opt)
    step = make_train_step(net.apply, opt)
    losses = []
    for _ in range(30):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    assert int(state.step) == 30


def test_snapshot_restore_roundtrip(tmp_path):
    net = PoseNet(num_parts=3, num_limbs=2, num_stages=1, backbone_widths=(4, 4, 4))
    key = jax.random.key(0)
    params = net.init(key, jnp.zeros((1, 16, 16, 3)))
    opt = make_optimizer(1e-3, "momentum")
    state = init_train_state(params, opt)
    snapshot(tmp_path / "ck", state)
    back = restore(tmp_path / "ck", state)
    la = jax.tree_util.tree_leaves(state.params)
    lb = jax.tree_util.tree_leaves(back.params)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_optimizer_zoo():
    for kind in ("sgd", "momentum", "nesterov", "adam", "adamw", "rmsprop", "adagrad"):
        make_optimizer(1e-3, kind)
