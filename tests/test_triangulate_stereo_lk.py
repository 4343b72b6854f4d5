import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry.camera import PinholeCamera
from perception.geometry.stereo import MISSING_Z, StereoCamera
from perception.ops.lk import lk_track
from perception.ops.triangulate import triangulate, triangulate_dlt


def camera_ring(n_cams=4, radius=2.0, fx=500.0):
    """Cameras on a ring looking at the origin; returns (C, 3, 4) P."""
    Ps = []
    for k in range(n_cams):
        ang = 2 * np.pi * k / n_cams * 0.15  # mild baseline
        C = np.array([radius * np.sin(ang), 0.2 * k / n_cams, -radius * np.cos(ang)])
        # Look-at origin
        z = -C / np.linalg.norm(C)
        x = np.cross([0, 1, 0], z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])  # world->cam rows
        t = -R @ C
        K = np.array([[fx, 0, 320], [0, fx, 240], [0, 0, 1.0]])
        Ps.append(K @ np.concatenate([R, t[:, None]], 1))
    return np.stack(Ps).astype(np.float32)


def test_triangulate_exact_observations():
    rng = np.random.RandomState(0)
    P = camera_ring()
    X = rng.uniform(-0.5, 0.5, (50, 3)).astype(np.float32)
    hom = np.concatenate([X, np.ones((50, 1))], 1)
    proj = np.einsum("cij,nj->nci", P, hom)
    uv = proj[..., :2] / proj[..., 2:]
    mask = np.ones((50, 4), bool)
    res = triangulate(jnp.asarray(P), jnp.asarray(uv), jnp.asarray(mask))
    assert bool(res.valid.all())
    np.testing.assert_allclose(np.asarray(res.points), X, atol=1e-3)
    assert float(res.reproj_error.max()) < 0.1


def test_triangulate_refinement_beats_dlt_under_noise():
    rng = np.random.RandomState(1)
    P = camera_ring(6)
    X = rng.uniform(-0.5, 0.5, (80, 3)).astype(np.float32)
    hom = np.concatenate([X, np.ones((80, 1))], 1)
    proj = np.einsum("cij,nj->nci", P, hom)
    uv = proj[..., :2] / proj[..., 2:] + rng.randn(80, 6, 2) * 1.0
    mask = np.ones((80, 6), bool)
    X_dlt = np.asarray(triangulate_dlt(jnp.asarray(P), jnp.asarray(uv), jnp.asarray(mask)))
    res = triangulate(jnp.asarray(P), jnp.asarray(uv), jnp.asarray(mask), iterations=8)
    err_dlt = np.linalg.norm(X_dlt - X, axis=1).mean()
    err_gn = np.linalg.norm(np.asarray(res.points) - X, axis=1).mean()
    assert err_gn <= err_dlt * 1.05
    assert err_gn < 0.03


def test_triangulate_respects_camera_mask():
    P = camera_ring(4)
    X = np.array([[0.1, -0.2, 0.3]], np.float32)
    hom = np.concatenate([X, np.ones((1, 1))], 1)
    proj = np.einsum("cij,nj->nci", P, hom)
    uv = proj[..., :2] / proj[..., 2:]
    uv_bad = uv.copy()
    uv_bad[:, 2] += 300.0  # corrupt camera 2, then mask it out
    mask = np.ones((1, 4), bool)
    mask[0, 2] = False
    res = triangulate(jnp.asarray(P), jnp.asarray(uv_bad), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(res.points)[0], X[0], atol=1e-3)


def test_stereo_roundtrip():
    cam = PinholeCamera.d435_depth()
    st = StereoCamera(left=cam, baseline=jnp.float32(0.05))
    depth = jnp.asarray([0.5, 1.0, 3.0])
    disp = st.depth_to_disparity(depth)
    back = st.disparity_to_depth(disp)
    np.testing.assert_allclose(np.asarray(back), np.asarray(depth), rtol=1e-5)


def test_stereo_missing_z():
    cam = PinholeCamera.d435_depth()
    st = StereoCamera(left=cam, baseline=jnp.float32(0.05))
    assert float(st.disparity_to_depth(jnp.float32(0.0))) == MISSING_Z
    pts = st.project_disparity_to_3d(jnp.array([10.0, 20.0]), jnp.float32(-1.0))
    assert float(pts[2]) == MISSING_Z


def test_stereo_project_matches_pinhole():
    cam = PinholeCamera.d435_depth()
    st = StereoCamera(left=cam, baseline=jnp.float32(0.05))
    uv = jnp.array([400.0, 300.0])
    z_true = 2.0
    disp = st.depth_to_disparity(jnp.float32(z_true))
    p = st.project_disparity_to_3d(uv, disp)
    np.testing.assert_allclose(float(p[2]), z_true, rtol=1e-5)
    # Reprojecting through the left pinhole recovers the pixel.
    uv_back = cam.project(p)
    np.testing.assert_allclose(np.asarray(uv_back), np.asarray(uv), atol=1e-3)


def textured_image(h=120, w=160, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(h // 8, w // 8) * 200
    img = np.kron(img, np.ones((8, 8)))  # blocky texture
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, 1.5).astype(np.float32)


def test_lk_tracks_translation():
    img0 = textured_image()
    shift = (3.0, 2.0)  # (dx, dy)
    img1 = np.roll(np.roll(img0, 2, axis=0), 3, axis=1)
    pts = jnp.asarray(np.array([[40.0, 30.0], [80.0, 60.0], [120.0, 90.0]], np.float32))
    mask = jnp.ones(3, bool)
    res = lk_track(jnp.asarray(img0), jnp.asarray(img1), pts, mask)
    assert bool(res.valid.all())
    flow = np.asarray(res.points) - np.asarray(pts)
    np.testing.assert_allclose(flow, np.tile(shift, (3, 1)), atol=0.3)


def test_lk_large_motion_needs_pyramid():
    img0 = textured_image(seed=2)
    img1 = np.roll(img0, 11, axis=1)  # 11 px shift > window radius
    pts = jnp.asarray(np.array([[60.0, 50.0], [90.0, 70.0]], np.float32))
    mask = jnp.ones(2, bool)
    res = lk_track(jnp.asarray(img0), jnp.asarray(img1), pts, mask, levels=3, radius=7)
    flow = np.asarray(res.points) - np.asarray(pts)
    np.testing.assert_allclose(flow[:, 0], 11.0, atol=0.5)
    np.testing.assert_allclose(flow[:, 1], 0.0, atol=0.5)


def test_lk_flat_region_invalid():
    img0 = np.full((100, 100), 80.0, np.float32)
    img1 = img0.copy()
    pts = jnp.asarray(np.array([[50.0, 50.0]], np.float32))
    res = lk_track(jnp.asarray(img0), jnp.asarray(img1), pts, jnp.ones(1, bool))
    assert not bool(res.valid[0])  # no gradient -> untrackable
