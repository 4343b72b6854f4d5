import numpy as np
import pytest

from perception.io.pcd import read_pcd, write_pcd
from perception.runtime import FramePrefetcher, native_available, read_pcd_native


def test_native_builds():
    assert native_available(), "g++ native build failed"


def test_native_pcd_matches_python_ascii(tmp_path):
    pts = np.random.RandomState(0).randn(500, 3).astype(np.float32)
    p = tmp_path / "a.pcd"
    write_pcd(p, pts)
    a = read_pcd_native(p)
    b = read_pcd(p)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_native_pcd_matches_python_binary(tmp_path):
    pts = np.random.RandomState(1).randn(321, 3).astype(np.float32)
    p = tmp_path / "b.pcd"
    write_pcd(p, pts, binary=True)
    a = read_pcd_native(p)
    np.testing.assert_array_equal(a, pts)


def test_native_pcd_drops_nans(tmp_path):
    pts = np.ones((10, 3), np.float32)
    pts[4] = np.nan
    p = tmp_path / "n.pcd"
    write_pcd(p, pts)
    a = read_pcd_native(p)
    assert a.shape == (9, 3)


def test_native_reads_reference_templates():
    import glob

    paths = sorted(glob.glob("/root/reference/*/templates/*.pcd"))
    if not paths:
        pytest.skip("reference not mounted")
    for p in paths[:6]:
        a = read_pcd_native(p)
        b = read_pcd(p)
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_prefetcher_ordered_delivery(tmp_path):
    paths = []
    for i in range(12):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (100 + i))
        paths.append(p)
    got = list(FramePrefetcher(paths, threads=3, ring=4))
    assert len(got) == 12
    for i, data in enumerate(got):
        assert data == bytes([i]) * (100 + i), f"frame {i} out of order/corrupt"


def test_prefetcher_single_file(tmp_path):
    p = tmp_path / "one.bin"
    p.write_bytes(b"hello")
    assert list(FramePrefetcher([p])) == [b"hello"]


def test_prefetcher_empty_list():
    assert list(FramePrefetcher([])) == []
