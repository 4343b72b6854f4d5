import jax
import jax.numpy as jnp
import numpy as np

from perception.geometry.camera import PinholeCamera
from perception.ops.normals import normals_knn, normals_from_depth


def test_normals_knn_plane():
    rng = np.random.RandomState(0)
    pts = np.zeros((500, 3), np.float32)
    pts[:, :2] = rng.uniform(-0.5, 0.5, (500, 2))
    pts[:, 2] = 1.0  # plane z=1, viewed from origin -> normal -z
    n, valid = normals_knn(jnp.asarray(pts), jnp.ones(500, bool), k=8)
    assert bool(valid.all())
    nz = np.asarray(n)[:, 2]
    assert (nz < -0.999).all()  # oriented toward viewpoint (origin)


def test_normals_knn_sphere():
    rng = np.random.RandomState(1)
    d = rng.randn(800, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    center = np.array([0, 0, 5.0], np.float32)
    pts = (center + d).astype(np.float32)  # unit sphere at (0,0,5)
    n, valid = normals_knn(jnp.asarray(pts), jnp.ones(800, bool), k=12, viewpoint=(0, 0, 5.0))
    # normal should point along +d (away from center = toward... viewpoint
    # is the center here so orientation flips toward center): use |dot|.
    dots = np.abs((np.asarray(n) * d).sum(1))
    assert np.median(dots) > 0.99


def test_normals_knn_respects_mask():
    pts = jnp.zeros((50, 3))
    mask = jnp.zeros(50, bool)
    n, valid = normals_knn(pts, mask, k=8)
    assert not bool(valid.any())


def test_normals_from_depth_plane():
    cam = PinholeCamera.d435_depth()
    depth = jnp.full((120, 160), 2.0, jnp.float32)
    pts, valid = cam.backproject_depth(depth)
    p = pts.reshape(120, 160, 3)
    v = valid.reshape(120, 160)
    n, nv = normals_from_depth(p, v)
    inner = np.asarray(n)[5:-5, 5:-5]
    assert bool(np.asarray(nv)[5:-5, 5:-5].all())
    np.testing.assert_allclose(inner[..., 2], -1.0, atol=1e-3)  # toward camera


def test_normals_from_depth_discontinuity_rejected():
    cam = PinholeCamera.d435_depth()
    depth = jnp.full((60, 80), 1.0, jnp.float32)
    depth = depth.at[:, 40:].set(3.0)  # depth jump
    pts, valid = cam.backproject_depth(depth)
    n, nv = normals_from_depth(pts.reshape(60, 80, 3), valid.reshape(60, 80))
    nv = np.asarray(nv)
    assert not nv[:, 39:41].any()   # normals at the jump are invalid
    assert nv[10:-10, 5:30].all()   # flat regions fine


def test_normals_from_depth_tilted_plane():
    cam = PinholeCamera.d435_depth()
    H, W = 100, 120
    vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    rays = np.stack(
        [(uu - float(cam.cx)) / float(cam.fx), (vv - float(cam.cy)) / float(cam.fy), np.ones_like(uu, float)],
        -1,
    )
    nvec = np.array([0.2, -0.1, -1.0])
    nvec /= np.linalg.norm(nvec)
    d = -1.5
    t = d / (rays @ nvec)
    depth = jnp.asarray((rays * t[..., None])[..., 2], jnp.float32)
    pts, valid = cam.backproject_depth(depth)
    n, nv = normals_from_depth(pts.reshape(H, W, 3), valid.reshape(H, W))
    inner = np.asarray(n)[10:-10, 10:-10].reshape(-1, 3)
    dots = inner @ nvec
    assert np.abs(dots).min() > 0.999
