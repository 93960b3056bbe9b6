"""The port's clustering library (`deeplearning4j_tpu_torch/clustering/`)
held against the JAX package's on the CPU.

- Every case of tests/test_clustering.py but t-SNE's (those are in
  tests/test_torch_port_tsne.py) on the port.
- The host trees (VP-tree in three metrics, KD-tree, QuadTree, SpTree)
  answer seeded queries exactly as JAX's: the same numpy code, so equal
  indices and bit-equal distances and forces.
- k-means: the k-means++ init bit-equal to JAX's, the assignments equal
  off near-ties (counted: where the two nearest squared distances differ
  by at most KMEANS_TIE_RTOL of |x|^2 + max |c|^2), centroids and cost
  within KMEANS_RTOL, the Lloyd iteration counts equal.
- The REST server: each package's client against the other's server.
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.clustering as JC
from deeplearning4j_tpu.clustering import kmeans as JK
from deeplearning4j_tpu.clustering import server as JS
from deeplearning4j_tpu_torch.clustering import (
    KDTree,
    KMeansClustering,
    QuadTree,
    SpTree,
    VPTree,
)
from deeplearning4j_tpu_torch.clustering import kmeans as PK
from deeplearning4j_tpu_torch.clustering.server import (
    NearestNeighborsClient,
    NearestNeighborsServer,
)

CPU = "cpu"
KMEANS_RTOL = 1e-5
KMEANS_TIE_RTOL = 1e-5


def brute_knn(points, query, k):
    d = np.sqrt(np.sum((points - query[None, :]) ** 2, axis=1))
    order = np.argsort(d)
    return list(order[:k]), list(d[order[:k]])


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(0).standard_normal((300, 8))


# ------------------------------------------------ tests/test_clustering.py
class TestVPTree:
    def test_matches_brute_force(self, points):
        tree = VPTree(points)
        for qi in (0, 7, 123):
            q = points[qi] + 0.01
            got_i, got_d = tree.knn(q, 10)
            want_i, want_d = brute_knn(points, q, 10)
            assert got_i == want_i
            np.testing.assert_allclose(got_d, want_d, rtol=1e-9)

    def test_cosine_distance(self, points):
        tree = VPTree(points, distance="cosine")
        got_i, _ = tree.knn(points[5], 1)
        assert got_i[0] == 5


class TestKDTree:
    def test_matches_brute_force(self, points):
        tree = KDTree(points)
        q = np.random.default_rng(1).standard_normal(8)
        got_i, _ = tree.knn(q, 15)
        want_i, _ = brute_knn(points, q, 15)
        assert got_i == want_i

    def test_range_query(self):
        pts = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [0.5, 0.6]])
        assert sorted(KDTree(pts).range([0.0, 0.0], [1.0, 1.0])) == [0, 1, 3]


class TestTrees:
    def test_quadtree_mass_conservation(self):
        pts = np.random.default_rng(2).standard_normal((100, 2))
        tree = QuadTree.build(pts)
        assert tree.size == 100
        np.testing.assert_allclose(tree.com, pts.mean(axis=0), atol=1e-9)

    def test_sptree_matches_exact_forces_at_theta0(self):
        pts = np.random.default_rng(3).standard_normal((50, 3))
        tree = SpTree.build(pts)
        assert tree.size == 50
        neg = np.zeros(3)
        z = tree.compute_non_edge_forces(pts[7], 0.0, neg)
        diff = pts[7] - np.delete(pts, 7, axis=0)
        q = 1.0 / (1.0 + np.sum(diff ** 2, axis=1))
        np.testing.assert_allclose(z, q.sum(), rtol=1e-6)
        np.testing.assert_allclose(neg, ((q ** 2)[:, None] * diff).sum(0),
                                   rtol=1e-6)


class TestKMeans:
    def test_recovers_separated_clusters(self):
        rng = np.random.default_rng(4)
        pts = np.concatenate([rng.standard_normal((80, 4)) * 0.2 + 5,
                              rng.standard_normal((80, 4)) * 0.2 - 5,
                              rng.standard_normal((80, 4)) * 0.2])
        cs = KMeansClustering(k=3, max_iterations=50,
                              device=CPU).apply_to(pts)
        labels = cs.assignments
        for block in (labels[:80], labels[80:160], labels[160:]):
            assert len(set(block.tolist())) == 1
        assert len({labels[0], labels[80], labels[160]}) == 3
        assert cs.nearest_cluster(np.full(4, 5.0)) == labels[0]

    def test_cluster_set_api(self):
        pts = np.random.default_rng(5).standard_normal((30, 2))
        clusters = KMeansClustering(k=4, device=CPU).apply_to(
            pts).get_clusters()
        assert len(clusters) == 4
        assert sum(len(c.points) for c in clusters) == 30


class TestServer:
    def test_rest_roundtrip(self, points):
        server = NearestNeighborsServer(points).start()
        try:
            client = NearestNeighborsClient(f"http://127.0.0.1:{server.port}")
            assert client.knn(index=3, k=5)["results"][0]["index"] == 3
            q = points[10] + 0.001
            res = client.knn_new(q.astype(np.float32), 4)
            assert [r["index"] for r in res["results"]] == brute_knn(
                points, q, 4)[0]
        finally:
            server.stop()

    @pytest.mark.parametrize("server_pkg", ["jax", "port"])
    def test_each_client_against_the_other_server(self, points, server_pkg):
        """The wire is the same: JSON bodies, vectors as base64 float32."""
        srv_cls, cli_cls = ((JS.NearestNeighborsServer,
                             NearestNeighborsClient) if server_pkg == "jax"
                            else (NearestNeighborsServer,
                                  JS.NearestNeighborsClient))
        ref = JS.NearestNeighborsServer(points).start()
        server = srv_cls(points).start()
        try:
            got = cli_cls(f"http://127.0.0.1:{server.port}")
            want = JS.NearestNeighborsClient(f"http://127.0.0.1:{ref.port}")
            for i in (0, 42, 299):
                assert got.knn(i, 7) == want.knn(i, 7)
                q = (points[i] - 0.01).astype(np.float32)
                assert got.knn_new(q, 6) == want.knn_new(q, 6)
        finally:
            server.stop()
            ref.stop()

    def test_bad_request_is_a_400(self, points):
        import json
        from urllib import error, request
        server = NearestNeighborsServer(points).start()
        try:
            req = request.Request(
                f"http://127.0.0.1:{server.port}/knnnew",
                data=json.dumps({"vector": 5}).encode())
            with pytest.raises(error.HTTPError) as e:
                request.urlopen(req)
            assert e.value.code == 400
        finally:
            server.stop()


# ------------------------------------------------------- trees against JAX
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_vptree_answers_equal_jax(points, metric):
    got, want = (VPTree(points, distance=metric, leaf_size=8, seed=3),
                 JC.VPTree(points, distance=metric, leaf_size=8, seed=3))
    rng = np.random.default_rng(11)
    for q in rng.standard_normal((12, 8)):
        gi, gd = got.knn(q, 9)
        wi, wd = want.knn(q, 9)
        assert gi == wi and gd == wd


def test_kdtree_answers_equal_jax(points):
    got, want = KDTree(points), JC.KDTree(points)
    rng = np.random.default_rng(12)
    for q in rng.standard_normal((10, 8)):
        assert got.knn(q, 11) == want.knn(q, 11)
        lo, hi = q - 0.8, q + 0.8
        assert got.range(lo, hi) == want.range(lo, hi)


@pytest.mark.parametrize("dim", [2, 3])
def test_barnes_hut_trees_equal_jax(dim):
    pts = np.random.default_rng(13 + dim).standard_normal((120, dim))
    got = QuadTree.build(pts) if dim == 2 else SpTree.build(pts)
    want = JC.QuadTree.build(pts) if dim == 2 else JC.SpTree.build(pts)
    assert got.size == want.size and np.array_equal(got.com, want.com)
    for i in (0, 17, 119):
        for theta in (0.0, 0.5, 1.2):
            fg, fw = np.zeros(dim), np.zeros(dim)
            assert (got.compute_non_edge_forces(pts[i], theta, fg)
                    == want.compute_non_edge_forces(pts[i], theta, fw))
            assert np.array_equal(fg, fw)


# ----------------------------------------------------- k-means against JAX
def _jax_kmeans(pts, monkeypatch, **kw):
    """JAX's ClusterSet, the centroids its first Lloyd step received
    (the init) and its number of Lloyd steps."""
    seen, step = [], JK._lloyd_step

    def counted(points, centroids):
        seen.append(np.asarray(centroids))
        return step(points, centroids)

    monkeypatch.setattr(JK, "_lloyd_step", counted)
    cs = JK.KMeansClustering(**kw).apply_to(pts)
    monkeypatch.setattr(JK, "_lloyd_step", step)
    return cs, seen[0], len(seen)


def _blobs(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, 16)) * 4
    return centers[rng.integers(0, 6, 600)] + rng.standard_normal((600, 16))


@pytest.mark.parametrize("case", ["blobs", "noise", "small_k"])
def test_kmeans_matches_jax(case, monkeypatch):
    pts, kw = {
        "blobs": (_blobs(21), dict(k=6, max_iterations=100, seed=2)),
        "noise": (np.random.default_rng(22).standard_normal((500, 8)),
                  dict(k=8, max_iterations=100, seed=5)),
        "small_k": (np.random.default_rng(23).standard_normal((64, 3)),
                    dict(k=2, max_iterations=7, seed=0)),
    }[case]
    want, init, n_steps = _jax_kmeans(pts, monkeypatch, **kw)
    assert np.array_equal(
        PK.kmeans_pp_init(np.asarray(pts, np.float32), kw["k"], kw["seed"]),
        init)
    got = KMeansClustering(**kw, device=CPU).apply_to(pts)
    assert got.assignments.dtype == want.assignments.dtype == np.int32
    assert got.centroids.dtype == np.float32
    x = np.asarray(pts, np.float32).astype(np.float64)
    c = want.centroids.astype(np.float64)
    x2, c2 = (x * x).sum(1), (c * c).sum(1)
    d2 = x2[:, None] - 2 * x @ c.T + c2[None, :]
    apart = np.flatnonzero(got.assignments != want.assignments)
    ties = [i for i in apart
            if abs(d2[i, got.assignments[i]] - d2[i, want.assignments[i]])
            <= KMEANS_TIE_RTOL * (x2[i] + c2.max())]
    assert len(ties) == len(apart), (apart, ties)
    assert got.iterations == n_steps
    scale = np.abs(want.centroids).max()
    assert np.abs(got.centroids - want.centroids).max() <= KMEANS_RTOL * scale
    assert got.cost == pytest.approx(want.cost, rel=KMEANS_RTOL)


def test_kmeans_entry_point_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        KMeansClustering(3)


def test_lloyd_step_sums_by_one_hot_matmul():
    """The centroid sums are a one-hot matmul (no scatter): an empty
    cluster keeps its centroid, a full one takes its mean."""
    pts = torch.tensor([[0.0, 0.0], [2.0, 0.0], [10.0, 10.0]])
    cen = torch.tensor([[1.0, 0.0], [10.0, 10.0], [-50.0, -50.0]])
    new, assign, cost = PK._lloyd_step(pts, cen)
    assert assign.tolist() == [0, 0, 1]
    assert new.tolist() == [[1.0, 0.0], [10.0, 10.0], [-50.0, -50.0]]
    assert float(cost) == 2.0
