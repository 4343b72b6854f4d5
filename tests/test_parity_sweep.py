"""Tests for the parity-sweep additions: dense rectification, compressed
codecs, topology zoo, keypoint utils, IP/FLIR producers, 3-D renderer."""

import numpy as np
import jax.numpy as jnp
import pytest

from perception.geometry.camera import PinholeCamera

# Long e2e sweeps: run with `-m slow` (core suite excludes them).
pytestmark = pytest.mark.slow


class TestRectifyImage:
    def _distorted_camera(self):
        return PinholeCamera.from_K(
            [300.0, 0, 320, 0, 300.0, 240, 0, 0, 1],
            dist=[-0.15, 0.05, 0.001, -0.001, 0.0],
        )

    def test_matches_cv2_undistort(self):
        cv2 = pytest.importorskip("cv2")
        cam = self._distorted_camera()
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
        img = cv2.GaussianBlur(img, (0, 0), 3)  # smooth so bilinear≈cv2 remap
        K = np.asarray(cam.K)
        d = np.asarray(cam.dist)
        ref = cv2.undistort(img, K, d)
        out = np.asarray(cam.rectify_image(jnp.asarray(img)))
        # Compare interior (border handling differs).
        a, b = ref[40:-40, 40:-40], out[40:-40, 40:-40]
        assert np.median(np.abs(a - b)) < 0.5
        assert np.mean(np.abs(a - b)) < 1.5

    def test_zero_distortion_identity(self):
        cam = PinholeCamera.d435_depth()
        img = jnp.arange(480 * 640, dtype=jnp.float32).reshape(480, 640) % 251
        out = cam.rectify_image(img)
        # f32 normalize/denormalize round trip costs ~2e-3 px of shift.
        assert np.allclose(np.asarray(out)[1:-1, 1:-1], np.asarray(img)[1:-1, 1:-1], atol=2e-2)

    def test_multichannel_shape(self):
        cam = self._distorted_camera()
        img = jnp.ones((480, 640, 3))
        assert cam.rectify_image(img).shape == (480, 640, 3)


class TestCompressed:
    def test_png_roundtrip_exact(self):
        pytest.importorskip("cv2")
        from perception.io.imgcodec import array_to_compressed, compressed_to_array

        rng = np.random.default_rng(1)
        img = rng.integers(0, 255, (32, 48, 3), dtype=np.uint8)
        msg = array_to_compressed(img, "png")
        assert msg["format"] == "png"
        out = compressed_to_array(msg)
        assert np.array_equal(out, img)

    def test_jpg_roundtrip_close(self):
        pytest.importorskip("cv2")
        from perception.io.imgcodec import array_to_compressed, compressed_to_array

        img = np.full((32, 48, 3), 128, np.uint8)
        out = compressed_to_array(array_to_compressed(img, "jpg", quality=95))
        assert out.shape == img.shape
        assert np.mean(np.abs(out.astype(int) - 128)) < 3


class TestTopologies:
    def test_zoo_entries_consistent(self):
        from perception.models.pose import TOPOLOGIES

        for name, (parts, pairs) in TOPOLOGIES.items():
            assert pairs.ndim == 2 and pairs.shape[1] == 2, name
            assert pairs.min() >= 0 and pairs.max() < len(parts), name
        assert set(TOPOLOGIES) >= {"BODY_25", "COCO_18", "MPI_15", "CAR_12"}
        assert len(TOPOLOGIES["MPI_15"][0]) == 15
        assert len(TOPOLOGIES["CAR_12"][0]) == 12

    def test_posenet_builds_on_mpi(self):
        import jax
        from perception.models.pose import TOPOLOGIES, PoseNet, init_posenet

        params = init_posenet(jax.random.key(0), "MPI_15", net_hw=(32, 32))
        parts, pairs = TOPOLOGIES["MPI_15"]
        net = PoseNet(num_parts=len(parts), num_limbs=len(pairs))
        x = jnp.zeros((1, 32, 32, 3))
        pafs, hms = net.apply(params, x)
        assert hms.shape[-1] == 15 + 1  # parts + background


class TestKeypointUtils:
    def _people(self):
        kp = np.zeros((4, 5, 3), np.float32)
        kp[0, :, :2] = [[0, 0], [10, 0], [10, 10], [0, 10], [5, 5]]
        kp[0, :, 2] = 0.9
        kp[1, :2, :2] = [[1, 1], [3, 1]]
        kp[1, :2, 2] = 0.5
        kp[2, 0, 2] = 0.2  # single visible part -> area 0
        mask = np.array([True, True, True, False])
        scores = np.array([0.9, 0.5, 0.2, 0.0], np.float32)
        return jnp.asarray(kp), jnp.asarray(scores), jnp.asarray(mask)

    def test_rescale(self):
        from perception.utils.keypoints import rescale_keypoints

        kp, _, _ = self._people()
        out = rescale_keypoints(kp, 2.0)
        assert np.allclose(np.asarray(out)[0, 2, :2], [20, 20])
        assert np.allclose(np.asarray(out)[..., 2], np.asarray(kp)[..., 2])

    def test_area(self):
        from perception.utils.keypoints import keypoint_area

        kp, _, _ = self._people()
        area = np.asarray(keypoint_area(kp))
        assert area[0] == pytest.approx(100.0)
        assert area[1] == pytest.approx(0.0)  # degenerate rect, 2 collinear pts
        assert area[2] == 0.0

    def test_distance(self):
        from perception.utils.keypoints import keypoints_person_distance

        kp, _, _ = self._people()
        d = keypoints_person_distance(kp[0], kp[1])
        assert np.isfinite(float(d))
        d2 = keypoints_person_distance(kp[3], kp[1])  # no shared visible part
        assert np.isinf(float(d2))

    def test_keep_top_n(self):
        from perception.utils.keypoints import keep_top_n_people

        kp, scores, mask = self._people()
        okp, osc, omk = keep_top_n_people(kp, scores, mask, 2)
        omk = np.asarray(omk)
        assert omk.sum() == 2
        assert np.asarray(osc)[0] == pytest.approx(0.9)
        assert np.asarray(osc)[1] == pytest.approx(0.5)
        # Compacted: best person's keypoints first.
        assert np.allclose(np.asarray(okp)[0], np.asarray(kp)[0])


class TestProducers:
    def test_flir_reader_gated(self):
        from perception.io.producers import FlirReader

        with pytest.raises(RuntimeError):
            FlirReader()

    def test_ip_camera_bad_url(self):
        pytest.importorskip("cv2")
        from perception.io.producers import IpCameraReader

        with pytest.raises((ConnectionError, Exception)):
            IpCameraReader("rtsp://127.0.0.1:1/none")


class TestRender3D:
    def test_renders_cloud(self):
        from perception.models.viz import render_points_3d

        rng = np.random.default_rng(0)
        pts = rng.uniform(-0.2, 0.2, (500, 3))
        pts[:, 2] += 0.8
        img = render_points_3d(pts, size=(120, 160))
        assert img.shape == (120, 160, 3)
        assert (img != 16).any()  # something was splatted

    def test_zbuffer_front_wins(self):
        from perception.models.viz import render_points_3d

        # Two points on the same ray from the default eye; red is closer.
        eye = np.array([0.0, 0.0, -1.0])
        d = np.array([0.0, 0.0, 1.0])
        pts = np.stack([eye + 0.5 * d, eye + 1.5 * d])
        cols = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
        img = render_points_3d(pts, colors=cols, size=(64, 64),
                               eye=tuple(eye), target=(0, 0, 1), point_px=3)
        assert (img == np.array([255, 0, 0])).all(-1).any()
        assert not (img == np.array([0, 255, 0])).all(-1).any()


class TestRationalDistortion:
    def test_matches_cv2_rational(self):
        cv2 = pytest.importorskip("cv2")
        import numpy as np

        dist8 = [-0.3, 0.1, 0.001, -0.0005, 0.02, -0.25, 0.07, 0.015]
        cam = PinholeCamera.from_K([400.0, 0, 320, 0, 400.0, 240, 0, 0, 1], dist=dist8)
        rng = np.random.default_rng(2)
        ideal = rng.uniform([100, 100], [540, 380], (50, 2)).astype(np.float32)
        ours = np.asarray(cam.unrectify_point(jnp.asarray(ideal)))

        # cv2.projectPoints applies the same rational model to the
        # normalized ideal coordinates.
        K = np.asarray(cam.K, np.float64)
        pts3 = np.concatenate(
            [(ideal - [320, 240]) / 400.0, np.ones((50, 1), np.float32)], axis=1
        ).astype(np.float64)
        ref, _ = cv2.projectPoints(pts3, np.zeros(3), np.zeros(3), K,
                                   np.asarray(dist8, np.float64))
        assert np.abs(ours - ref.reshape(-1, 2)).max() < 1e-2

    def test_rectify_roundtrip(self):
        import numpy as np

        dist8 = [-0.3, 0.1, 0.001, -0.0005, 0.02, -0.25, 0.07, 0.015]
        cam = PinholeCamera.from_K([400.0, 0, 320, 0, 400.0, 240, 0, 0, 1], dist=dist8)
        uv = jnp.asarray([[200.0, 150.0], [320.0, 240.0], [450.0, 300.0]])
        back = cam.rectify_point(cam.unrectify_point(uv), iters=10)
        assert np.abs(np.asarray(back) - np.asarray(uv)).max() < 0.05

    def test_bad_length_rejected(self):
        with pytest.raises(ValueError):
            PinholeCamera.from_K([400.0, 0, 320, 0, 400.0, 240, 0, 0, 1], dist=[0.1] * 6)
