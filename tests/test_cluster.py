import jax
import jax.numpy as jnp
import numpy as np

from perception.ops.cluster import euclidean_cluster, extract_cluster


def blob(rng, center, n, spread=0.005):
    return (rng.randn(n, 3) * spread + np.asarray(center)).astype(np.float32)


def test_three_separated_blobs():
    rng = np.random.RandomState(0)
    a = blob(rng, [0, 0, 0.5], 400)
    b = blob(rng, [0.3, 0, 0.5], 300)
    c = blob(rng, [0, 0.3, 0.5], 250)
    pts = jnp.asarray(np.concatenate([a, b, c]))
    mask = jnp.ones(len(pts), bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=100, max_size=25000)
    assert int(cl.num_clusters) == 3
    sizes = np.asarray(cl.sizes)
    assert list(sizes[:3]) == [400, 300, 250]  # biggest-first
    labels = np.asarray(cl.labels)
    # Each blob maps to exactly one label.
    assert len(set(labels[:400])) == 1
    assert len(set(labels[400:700])) == 1
    assert len(set(labels[700:])) == 1
    assert labels[0] != labels[400] != labels[700]
    # Centroids near the blob centers.
    cents = np.asarray(cl.centroids)[:3]
    for center in ([0, 0, 0.5], [0.3, 0, 0.5], [0, 0.3, 0.5]):
        assert np.abs(cents - center).sum(1).min() < 0.01


def test_size_filter():
    rng = np.random.RandomState(1)
    big = blob(rng, [0, 0, 0.5], 500)
    tiny = blob(rng, [1.0, 0, 0.5], 20)  # below min_size
    pts = jnp.asarray(np.concatenate([big, tiny]))
    mask = jnp.ones(len(pts), bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=100, max_size=25000)
    assert int(cl.num_clusters) == 1
    labels = np.asarray(cl.labels)
    assert (labels[500:] == -1).all()  # tiny cluster rejected
    assert (labels[:500] == 0).all()


def test_connected_elongated_shape():
    # A 1m rod sampled at 5mm: single cluster despite 50+ voxel diameter.
    xs = np.arange(0, 1.0, 0.005, dtype=np.float32)
    pts = jnp.asarray(np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1))
    mask = jnp.ones(len(pts), bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=50, max_size=25000)
    assert int(cl.num_clusters) == 1
    assert int(cl.sizes[0]) == len(xs)


def test_mask_respected():
    rng = np.random.RandomState(2)
    a = blob(rng, [0, 0, 0.5], 300)
    pts = jnp.asarray(a)
    mask = jnp.ones(300, bool).at[:150].set(False)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=100, max_size=25000)
    assert (np.asarray(cl.labels)[:150] == -1).all()
    assert int(cl.sizes[0]) == 150


def test_two_points_split_by_gap():
    pts = jnp.array([[0.0, 0, 0], [0.1, 0, 0]])  # 10 cm apart, tol 2 cm
    mask = jnp.ones(2, bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=1, max_size=100)
    labels = np.asarray(cl.labels)
    assert labels[0] != labels[1]
    assert int(cl.num_clusters) == 2


def test_extract_cluster():
    rng = np.random.RandomState(3)
    a = blob(rng, [0, 0, 0.5], 200)
    b = blob(rng, [0.5, 0, 0.5], 100)
    pts = jnp.asarray(np.concatenate([a, b]))
    mask = jnp.ones(300, bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=50, max_size=1000)
    cpts, cmask = extract_cluster(pts, cl.labels, 1, capacity=128)
    assert int(cmask.sum()) == 100
    got = np.sort(np.asarray(cpts)[np.asarray(cmask)], axis=0)
    np.testing.assert_allclose(got, np.sort(b, axis=0), atol=1e-6)


def test_empty_input():
    pts = jnp.zeros((64, 3))
    mask = jnp.zeros(64, bool)
    cl = euclidean_cluster(pts, mask, tolerance=0.02, min_size=1, max_size=100)
    assert int(cl.num_clusters) == 0
    assert (np.asarray(cl.labels) == -1).all()


def test_refine_splits_voxel_bridged_clusters():
    # Cells are tol-sized from origin -5 (boundary at y = -5 + k*0.02).
    # Line a at y=0.001 (cell 250) and line b at y=0.039 (cell 251):
    # adjacent cells, but every cross pair is 0.038 > tol apart. Voxel
    # adjacency merges them; refine=True applies PCL's exact radius.
    tol = 0.02
    x = np.linspace(0, 0.3, 60)
    a = np.stack([x, np.full(60, 0.001), np.full(60, 0.5)], 1)
    b = np.stack([x, np.full(60, 0.039), np.full(60, 0.5)], 1)
    pts = np.zeros((256, 3), np.float32)
    pts[:120] = np.concatenate([a, b])
    mask = np.zeros(256, bool)
    mask[:120] = True
    coarse = euclidean_cluster(
        jnp.asarray(pts), jnp.asarray(mask), tolerance=tol,
        min_size=5, max_size=1000, max_clusters=8)
    exact = euclidean_cluster(
        jnp.asarray(pts), jnp.asarray(mask), tolerance=tol,
        min_size=5, max_size=1000, max_clusters=8, refine=True)
    assert int(coarse.num_clusters) == 1          # voxel bridging
    assert int(exact.num_clusters) == 2           # exact-radius split
    assert np.asarray(exact.sizes[:2]).tolist() == [60, 60]


def test_refine_keeps_within_tolerance_chain_merged():
    # Rows 0.9*tol apart chain into one component under the exact
    # radius even though they cross a cell boundary.
    tol = 0.02
    x = np.linspace(0, 0.3, 60)
    rows = [np.stack([x, np.full(60, 0.001 + k * 0.9 * tol),
                      np.full(60, 0.8)], 1) for k in range(3)]
    pts = np.zeros((256, 3), np.float32)
    pts[:180] = np.concatenate(rows)
    mask = np.zeros(256, bool)
    mask[:180] = True
    cl = euclidean_cluster(
        jnp.asarray(pts), jnp.asarray(mask), tolerance=tol,
        min_size=5, max_size=1000, max_clusters=8, refine=True)
    assert int(cl.num_clusters) == 1
    assert int(cl.sizes[0]) == 180


def test_refine_matches_scipy_exact_radius_oracle():
    from scipy.spatial import cKDTree
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    rng = np.random.RandomState(7)
    pts_list = [blob(rng, [0, 0, 0.5], 80), blob(rng, [0.08, 0, 0.5], 60),
                blob(rng, [0.5, 0.3, 0.7], 70)]
    pts_np = np.concatenate(pts_list).astype(np.float32)
    n = 256
    pts = np.zeros((n, 3), np.float32)
    pts[: len(pts_np)] = pts_np
    mask = np.zeros(n, bool)
    mask[: len(pts_np)] = True
    tol = 0.02
    cl = euclidean_cluster(
        jnp.asarray(pts), jnp.asarray(mask), tolerance=tol,
        min_size=1, max_size=1000, max_clusters=8, refine=True)

    tree = cKDTree(pts_np)
    pairs = tree.query_pairs(tol, output_type="ndarray")
    adj = csr_matrix(
        (np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
        shape=(len(pts_np), len(pts_np)))
    ncomp, lab = connected_components(adj, directed=False)
    assert int(cl.num_clusters) == ncomp
    ours = np.asarray(cl.labels[: len(pts_np)])
    for c in range(ncomp):
        assert len(set(ours[lab == c].tolist())) == 1  # same partition
