import numpy as np

from perception.io.pcd import read_pcd, write_pcd
from perception.io.templates import cuboid_template, cuboid_vertices, CUBOID_EDGES


def test_pcd_ascii_roundtrip(tmp_path):
    pts = np.random.RandomState(0).randn(100, 3).astype(np.float32)
    p = tmp_path / "test.pcd"
    write_pcd(p, pts)
    back = read_pcd(p)
    np.testing.assert_allclose(back, pts, atol=1e-5)


def test_pcd_binary_roundtrip(tmp_path):
    pts = np.random.RandomState(1).randn(57, 3).astype(np.float32)
    p = tmp_path / "test_bin.pcd"
    write_pcd(p, pts, binary=True)
    back = read_pcd(p)
    np.testing.assert_allclose(back, pts, atol=1e-6)


def test_pcd_drops_nan_rows(tmp_path):
    pts = np.ones((5, 3), dtype=np.float32)
    pts[2] = np.nan
    p = tmp_path / "nan.pcd"
    write_pcd(p, pts)
    back = read_pcd(p)
    assert back.shape == (4, 3)


def test_template_matches_reference_generator():
    # make_cuboid.py defaults: L=0.2 W=0.1 H=0.075 d=0.002
    # grids: X 100 pts, Y 50, Z 38 -> N = 100*50 + 100*38 + 50*38 = 10700
    t = cuboid_template(0.2, 0.1, 0.075, 0.002)
    assert t.shape == (10700, 3)
    # Face constants: first block z=-H/2, second y=-W/2, third x=-L/2.
    assert np.allclose(t[:5000, 2], -0.0375)
    assert np.allclose(t[5000:8800, 1], -0.05)
    assert np.allclose(t[8800:, 0], -0.1)
    # All points inside the half-open box.
    assert t[:, 0].min() >= -0.1 and t[:, 0].max() < 0.1
    assert t[:, 1].min() >= -0.05 and t[:, 1].max() < 0.05
    assert t[:, 2].min() >= -0.0375 and t[:, 2].max() < 0.0375


def test_template_vs_shipped_reference_pcd():
    # Cross-check against a template checked into the reference repo.
    import pathlib

    ref = pathlib.Path(
        "/root/reference/cuboid_detection/templates/template_cuboid_L200_W100_H30_3faces.pcd"
    )
    if not ref.exists():
        import pytest

        pytest.skip("reference template not available")
    ref_pts = read_pcd(ref)
    ours = cuboid_template(0.2, 0.1, 0.03, 0.002)
    assert ours.shape == ref_pts.shape
    np.testing.assert_allclose(
        np.sort(ours.view("f4").reshape(-1, 3), axis=0),
        np.sort(ref_pts, axis=0),
        atol=1e-5,
    )


def test_cuboid_vertices_and_edges():
    v = cuboid_vertices(0.2, 0.1, 0.03)
    assert v.shape == (8, 3)
    assert np.allclose(np.abs(v), [0.1, 0.05, 0.015])
    assert CUBOID_EDGES.shape == (12, 2)
    # Each edge connects vertices differing in exactly one axis.
    for a, b in CUBOID_EDGES:
        assert (v[a] != v[b]).sum() == 1


def test_ply_roundtrip(tmp_path):
    """PLY read/write (reference ply_viewer.py input format), ascii and
    binary, plus extra-property skipping."""
    from perception.io.pcd import read_ply, write_ply

    pts = np.random.RandomState(0).randn(57, 3).astype(np.float32)
    for binary in (False, True):
        p = tmp_path / f"c_{binary}.ply"
        write_ply(p, pts, binary=binary)
        back = read_ply(p)
        np.testing.assert_allclose(back, pts, atol=1e-5)

    # Extra per-vertex properties (e.g. color) are skipped.
    p = tmp_path / "rgb.ply"
    with open(p, "wb") as f:
        f.write(b"ply\nformat ascii 1.0\nelement vertex 2\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
                b"end_header\n"
                b"1.0 2.0 3.0 255 0 0\n"
                b"4.0 5.0 6.0 0 255 0\n")
    back = read_ply(p)
    np.testing.assert_allclose(back, [[1, 2, 3], [4, 5, 6]])
