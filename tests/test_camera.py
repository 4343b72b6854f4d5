import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry.camera import PinholeCamera, depth_from_u16


def test_project_backproject_roundtrip():
    # The image_geometry invariant: project(ray(uv) * z) == uv
    # (vision_opencv/image_geometry/test/directed.py:15-26).
    cam = PinholeCamera.d435_color()
    uv = jnp.array([[0.0, 0.0], [320.0, 240.0], [639.0, 479.0], [100.5, 380.25]])
    rays = cam.pixel_to_ray(uv)
    pts = rays * 2.5
    uv2 = cam.project(pts)
    np.testing.assert_allclose(uv2, uv, atol=1e-4)


def test_ray_center_pixel_is_axis():
    cam = PinholeCamera.d435_depth()
    ray = cam.pixel_to_ray(jnp.array([cam.cx, cam.cy]))
    np.testing.assert_allclose(ray, jnp.array([0.0, 0.0, 1.0]), atol=1e-6)


def test_rectify_unrectify_roundtrip():
    cam = PinholeCamera.from_K(
        [616.8, 0, 321.8, 0, 616.6, 239.9, 0, 0, 1],
        dist=[-0.1, 0.05, 0.001, -0.002, 0.01],
    )
    uv = jnp.array([[100.0, 100.0], [320.0, 240.0], [500.0, 400.0]])
    raw = cam.unrectify_point(uv)
    back = cam.rectify_point(raw)
    np.testing.assert_allclose(back, uv, atol=1e-2)


def test_zero_distortion_identity():
    cam = PinholeCamera.d435_color()
    uv = jnp.array([[123.0, 45.0]])
    np.testing.assert_allclose(cam.unrectify_point(uv), uv, atol=1e-4)
    np.testing.assert_allclose(cam.rectify_point(uv), uv, atol=1e-4)


def test_backproject_depth_shapes_and_mask():
    cam = PinholeCamera.d435_depth()
    depth = jnp.full((480, 640), 1.5, dtype=jnp.float32)
    depth = depth.at[0, 0].set(0.0)       # invalid: zero
    depth = depth.at[10, 10].set(jnp.nan)  # invalid: nan
    depth = depth.at[20, 20].set(50.0)     # invalid: too far
    pts, mask = cam.backproject_depth(depth)
    assert pts.shape == (480 * 640, 3)
    assert mask.shape == (480 * 640,)
    assert not mask[0]
    assert not mask[10 * 640 + 10]
    assert not mask[20 * 640 + 20]
    assert int(mask.sum()) == 480 * 640 - 3
    # Invalid points parked at origin, no NaNs anywhere.
    assert bool(jnp.isfinite(pts).all())
    np.testing.assert_allclose(pts[10 * 640 + 10], jnp.zeros(3))


def test_backproject_project_inverse():
    cam = PinholeCamera.d435_depth()
    depth = jnp.full((48, 64), 2.0, dtype=jnp.float32)
    pts, mask = cam.backproject_depth(depth)
    uv = cam.project(pts)
    uu = uv[:, 0].reshape(48, 64)
    vv = uv[:, 1].reshape(48, 64)
    np.testing.assert_allclose(uu[0], jnp.arange(64, dtype=jnp.float32), atol=1e-3)
    np.testing.assert_allclose(vv[:, 0], jnp.arange(48, dtype=jnp.float32), atol=1e-3)


def test_camera_is_pytree():
    cam = PinholeCamera.d435_depth()

    @jax.jit
    def f(c, uv):
        return c.project(c.pixel_to_ray(uv) * 3.0)

    uv = jnp.array([[10.0, 20.0]])
    np.testing.assert_allclose(f(cam, uv), uv, atol=1e-4)


def test_depth_from_u16_tum_convention():
    raw = np.array([[5000, 0], [10000, 2500]], dtype=np.uint16)
    d = depth_from_u16(raw)
    assert d[0, 0] == 1.0
    assert np.isnan(d[0, 1])
    assert d[1, 0] == 2.0
    assert d[1, 1] == 0.5


class TestCameraInfoBinningRoi:
    """fromCameraInfo with binning/ROI (pinhole_camera_model.cpp:84-194)
    and ROI rectification (:371-412), on the D435 color intrinsics
    (reference README.md:39-80)."""

    K = (616.8246459960938, 0.0, 321.81976318359375,
         0.0, 616.609375, 239.91116333007812,
         0.0, 0.0, 1.0)

    def test_full_resolution_passthrough(self):
        from perception.geometry.camera import CameraInfo, PinholeCamera

        info = CameraInfo(K=self.K, width=640, height=480)
        cam = PinholeCamera.from_camera_info(info)
        assert (cam.width, cam.height) == (640, 480)
        np.testing.assert_allclose(float(cam.fx), self.K[0], rtol=1e-6)
        np.testing.assert_allclose(float(cam.cx), self.K[2], rtol=1e-6)

    def test_binning_halves_model(self):
        from perception.geometry.camera import CameraInfo, PinholeCamera

        info = CameraInfo(K=self.K, width=640, height=480,
                          binning_x=2, binning_y=2)
        cam = PinholeCamera.from_camera_info(info)
        full = PinholeCamera.from_K(self.K)
        assert (cam.width, cam.height) == (320, 240)
        # The same 3-D point lands at half the full-res pixel coords.
        pt = jnp.asarray([0.2, -0.1, 1.5])
        uv_full = np.asarray(full.project(pt))
        uv_bin = np.asarray(cam.project(pt))
        np.testing.assert_allclose(uv_bin, uv_full / 2.0, rtol=1e-5)

    def test_roi_shifts_principal_point(self):
        from perception.geometry.camera import CameraInfo, PinholeCamera

        roi = (96, 64, 320, 240)
        info = CameraInfo(K=self.K, width=640, height=480, roi=roi)
        cam = PinholeCamera.from_camera_info(info)
        full = PinholeCamera.from_K(self.K)
        assert (cam.width, cam.height) == (320, 240)
        pt = jnp.asarray([0.05, 0.02, 1.0])
        uv_full = np.asarray(full.project(pt))
        uv_roi = np.asarray(cam.project(pt))
        np.testing.assert_allclose(uv_roi, uv_full - np.asarray(roi[:2]), rtol=1e-5)

    def test_roi_plus_binning_roundtrip(self):
        from perception.geometry.camera import CameraInfo, PinholeCamera

        info = CameraInfo(K=self.K, width=640, height=480,
                          binning_x=2, binning_y=2, roi=(64, 32, 512, 384))
        cam = PinholeCamera.from_camera_info(info)
        assert (cam.width, cam.height) == (256, 192)
        # project o pixel_to_ray = identity in the reduced image.
        uv = jnp.asarray([[10.0, 20.0], [100.0, 150.0], [255.0, 191.0]])
        ray = cam.pixel_to_ray(uv)
        uv2 = cam.project(ray * 2.0)
        np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv), atol=1e-4)

    def test_roi_exceeding_sensor_rejected(self):
        import pytest

        from perception.geometry.camera import CameraInfo, PinholeCamera

        info = CameraInfo(K=self.K, width=640, height=480,
                          roi=(400, 0, 320, 240))
        with pytest.raises(ValueError, match="ROI"):
            PinholeCamera.from_camera_info(info)

    def test_rectify_roi_vs_cv2(self):
        import pytest

        cv2 = pytest.importorskip("cv2")
        from perception.geometry.camera import PinholeCamera

        dist = (0.12, -0.05, 0.001, -0.002, 0.01)
        cam = PinholeCamera.from_K(self.K, dist=dist)
        roi = (100, 80, 200, 150)
        rect = cam.rectify_roi(roi)
        # cv2 oracle: undistort the same border points, take the bound.
        x, y, w, h = roi
        ts = np.linspace(0.0, 1.0, 16)
        border = np.concatenate([
            np.stack([x + ts * w, np.full(16, y)], -1),
            np.stack([x + ts * w, np.full(16, y + h)], -1),
            np.stack([np.full(16, x), y + ts * h], -1),
            np.stack([np.full(16, x + w), y + ts * h], -1),
        ]).astype(np.float64)
        K = np.asarray(self.K).reshape(3, 3)
        und = cv2.undistortPoints(border[:, None], K, np.asarray(dist),
                                  P=K)[:, 0]
        exp = (np.floor(und[:, 0].min()), np.floor(und[:, 1].min()),
               np.ceil(und[:, 0].max()) - np.floor(und[:, 0].min()),
               np.ceil(und[:, 1].max()) - np.floor(und[:, 1].min()))
        assert abs(rect[0] - exp[0]) <= 1 and abs(rect[1] - exp[1]) <= 1
        assert abs(rect[2] - exp[2]) <= 2 and abs(rect[3] - exp[3]) <= 2

    def test_unrectify_roi_inverts(self):
        from perception.geometry.camera import PinholeCamera

        dist = (0.1, -0.02, 0.0, 0.0, 0.0)
        cam = PinholeCamera.from_K(self.K, dist=dist)
        roi = (150, 120, 160, 120)
        rect = cam.rectify_roi(roi)
        back = cam.unrectify_roi(rect)
        # The round trip must contain the original ROI (bounding boxes
        # only grow through the two walks).
        assert back[0] <= roi[0] and back[1] <= roi[1]
        assert back[0] + back[2] >= roi[0] + roi[2]
        assert back[1] + back[3] >= roi[1] + roi[3]
        assert back[2] <= roi[2] + 8 and back[3] <= roi[3] + 8
