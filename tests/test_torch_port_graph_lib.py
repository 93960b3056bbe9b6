"""The port's graph library (`deeplearning4j_tpu_torch/graph/`) held against
the JAX package's (`deeplearning4j_tpu/graph/`) on the CPU: every walker
draws the same walks from the same seed (numpy, in the same order), and
DeepWalk and Node2Vec give the same tables within GRAPH_FIT_ATOL; then
`tests/test_graph_lib.py` and the walker half of
`tests/test_nlp_depth.py`, one for one."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import functools

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as JG
import deeplearning4j_tpu_torch.graph as PG

CPU = torch.device("cpu")
# 15 epochs at lr 0.25 amplify float32 rounding: measured 1.9e-5 apart
# on tables of largest |value| about 1
GRAPH_FIT_ATOL = 1e-4


def barbell_graph(G=PG):
    """Two 6-cliques joined by a single bridge edge."""
    g = G.Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(5, 6)
    return g


def two_communities(G=PG, n_per=8):
    """Two dense cliques joined by a single bridge edge."""
    g = G.Graph(2 * n_per)
    for base in (0, n_per):
        for i in range(n_per):
            for j in range(i + 1, n_per):
                g.add_edge(base + i, base + j, directed=False)
    g.add_edge(n_per - 1, n_per, directed=False)  # bridge
    return g, [0] * n_per + [1] * n_per


def star_graph(G=PG):
    """Vertex 0 is a hub (degree 5); 1..5 are spokes; 5-6-7 a tail."""
    g = G.Graph(8)
    for v in range(1, 6):
        g.add_edge(0, v, directed=False)
    g.add_edge(5, 6, directed=False)
    g.add_edge(6, 7, directed=False)
    return g


def weighted_graph(G):
    g = G.Graph(6)
    rng = np.random.default_rng(4)
    for i in range(6):
        for j in range(i + 1, 6):
            if rng.random() < 0.6:
                g.add_edge(i, j, weight=float(rng.random() * 5 + 0.1))
    return g


# ---------------------------------------------------------- walks, exactly
_WALKERS = {
    "random": lambda G, g: G.RandomWalkIterator(g, 12, seed=3),
    "weighted": lambda G, g: G.WeightedRandomWalkIterator(g, 12, seed=3),
    "node2vec": lambda G, g: G.Node2VecWalkIterator(g, 12, p=0.5, q=2.0,
                                                    seed=7),
    "popularity_max": lambda G, g: G.PopularityWalkIterator(
        g, 6, popularity_mode="maximum", spread=2, seed=1),
    "popularity_avg_prop": lambda G, g: G.PopularityWalkIterator(
        g, 6, popularity_mode="average", spread=3,
        spectrum="proportional", seed=1),
    "nearest_random": lambda G, g: G.NearestVertexWalkIterator(
        g, walk_length=2, seed=5),
    "nearest_median_depth2": lambda G, g: G.NearestVertexWalkIterator(
        g, walk_length=2, depth=2, sampling_mode="median_popularity",
        seed=5),
}


@pytest.mark.parametrize("name", sorted(_WALKERS))
def test_walks_equal_jax(name):
    make = _WALKERS[name]
    for build in (lambda G: two_communities(G)[0], weighted_graph):
        want = list(make(JG, build(JG)))
        got = list(make(PG, build(PG)))
        assert got == want
        assert list(make(PG, build(PG))) == got   # reset replays


def test_loaders_equal_jax(tmp_path):
    p = tmp_path / "w.txt"
    p.write_text("0 1 0.5\n1 2 2.0\n# c\n2 3 1.5\n")
    a = JG.GraphLoader.load_weighted_edge_list(p, 4)
    b = PG.GraphLoader.load_weighted_edge_list(p, 4)
    for v in range(4):
        assert [(e.src, e.dst, e.weight) for e in a.get_edges_out(v)] == \
            [(e.src, e.dst, e.weight) for e in b.get_edges_out(v)]


# ------------------------------------------------------ embeddings vs JAX
_GRAPH_KW = dict(vector_size=16, window_size=4, walk_length=20,
                 walks_per_vertex=6, epochs=15, learning_rate=0.25,
                 batch_size=128, seed=11)


@functools.lru_cache(maxsize=None)
def _fitted(name):
    """(JAX, port) model fitted on the two-community graph from one
    seed (each model once)."""
    out = []
    for G, kw in ((JG, {}), (PG, {"device": CPU})):
        g, _ = two_communities(G)
        m = (G.Node2Vec(p=1.0, q=4.0, **_GRAPH_KW, **kw)
             if name == "node2vec" else G.DeepWalk(**_GRAPH_KW, **kw))
        m.fit_graph(g)
        out.append(m)
    return tuple(out)


@pytest.mark.parametrize("name", ["deepwalk", "node2vec"])
def test_fit_matches_jax(name):
    j, p = _fitted(name)
    assert p.vocab.words() == j.vocab.words()
    for i in range(j.vocab.num_words()):
        a, b = j.vocab.element_at_index(i), p.vocab.element_at_index(i)
        assert (a.codes, a.points) == (b.codes, b.points)
    for t in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_allclose(getattr(p, t), getattr(j, t), rtol=0,
                                   atol=GRAPH_FIT_ATOL)


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_entry_points_default_to_cuda_and_raise_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        PG.DeepWalk()
    with pytest.raises(RuntimeError, match="CUDA"):
        PG.Node2Vec()


# ------------------------------------------ tests/test_graph_lib.py, ported
class TestGraph:
    def test_adjacency(self):
        g = PG.Graph(4)
        g.add_edge(0, 1)
        g.add_edge(1, 2, directed=True)
        assert set(g.get_connected_vertices(0)) == {1}
        assert set(g.get_connected_vertices(1)) == {0, 2}
        assert g.get_connected_vertices(2) == []
        assert g.degree(1) == 2

    def test_loader_edge_list(self, tmp_path):
        p = tmp_path / "edges.txt"
        p.write_text("0 1\n1 2\n# comment\n2 3\n")
        g = PG.GraphLoader.load_edge_list(p, 4)
        assert g.degree(1) == 2

    def test_loader_weighted(self, tmp_path):
        p = tmp_path / "wedges.txt"
        p.write_text("0 1 0.5\n1 2 2.0\n")
        g = PG.GraphLoader.load_weighted_edge_list(p, 3)
        assert g.get_edges_out(1)[1].weight == 2.0

    def test_loader_adjacency(self, tmp_path):
        p = tmp_path / "adj.txt"
        p.write_text("0 1 2\n1 0\n2\n")
        g = PG.GraphLoader.load_adjacency_list(p)
        assert g.num_vertices() == 3
        assert set(g.get_connected_vertices(0)) == {1, 2}


class TestWalks:
    def test_deterministic_given_seed(self):
        g = barbell_graph()
        w1 = list(PG.RandomWalkIterator(g, 10, seed=3))
        w2 = list(PG.RandomWalkIterator(g, 10, seed=3))
        assert w1 == w2
        assert len(w1) == 12 and all(len(w) == 10 for w in w1)

    def test_walk_follows_edges(self):
        g = barbell_graph()
        for walk in PG.RandomWalkIterator(g, 8, seed=1):
            for a, b in zip(walk, walk[1:]):
                assert b in g.get_connected_vertices(a) or b == a

    def test_disconnected_self_loop_vs_exception(self):
        g = PG.Graph(2)
        g.add_edge(0, 0)
        it = PG.RandomWalkIterator(
            g, 5, seed=0,
            no_edge_handling=PG.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED)
        assert all(set(w) == {w[0]} for w in it)
        it2 = PG.RandomWalkIterator(
            g, 5, seed=0,
            no_edge_handling=PG.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)
        with pytest.raises(ValueError):
            list(it2)

    def test_weighted_walk_prefers_heavy_edges(self):
        g = PG.Graph(3)
        g.add_edge(0, 1, weight=100.0)
        g.add_edge(0, 2, weight=0.01)
        counts = {1: 0, 2: 0}
        it = PG.WeightedRandomWalkIterator(g, 2, seed=0)
        for _ in range(50):
            it.reset()
            for w in it:
                if w[0] == 0:
                    counts[w[1]] += 1
        assert counts[1] > counts[2]


class TestDeepWalk:
    def test_embeddings_cluster_by_community(self):
        g = barbell_graph()
        dw = PG.DeepWalk(vector_size=16, window_size=3, walk_length=20,
                         walks_per_vertex=8, epochs=2, learning_rate=0.05,
                         seed=11, device=CPU)
        dw.fit_graph(g)
        assert dw.similarity_vertices(0, 3) > dw.similarity_vertices(0, 9)
        near = dw.vertices_nearest(1, 4)
        assert len(set(near) & {0, 2, 3, 4, 5}) >= 2

    def test_vertex_vector_api(self):
        dw = PG.DeepWalk(vector_size=8, walk_length=10, epochs=1, device=CPU)
        dw.fit_graph(barbell_graph())
        assert dw.get_vertex_vector(0).shape == (8,)


class TestNode2Vec:
    def test_biased_walks_stay_local_with_high_q(self):
        g, labels = two_communities()

        def cross_fraction(it):
            crosses = total = 0
            it.reset()
            for walk in it:
                for a, b in zip(walk, walk[1:]):
                    crosses += labels[a] != labels[b]
                    total += 1
            return crosses / total

        uniform = cross_fraction(PG.RandomWalkIterator(g, 20, seed=1))
        local = np.mean([cross_fraction(
            PG.Node2VecWalkIterator(g, 20, p=1.0, q=8.0, seed=s))
            for s in (1, 2, 3)])
        assert local <= uniform * 1.05

    def test_node2vec_walk_determinism(self):
        g, _ = two_communities()
        w1 = list(PG.Node2VecWalkIterator(g, 10, p=0.5, q=2.0, seed=7))
        w2 = list(PG.Node2VecWalkIterator(g, 10, p=0.5, q=2.0, seed=7))
        assert w1 == w2

    def test_node2vec_separates_communities_and_beats_deepwalk(self):
        _, labels = two_communities()

        def community_score(model):
            vecs = np.stack([np.asarray(model.get_word_vector(str(v)))
                             for v in range(len(labels))])
            vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
            sims = vecs @ vecs.T
            n = len(labels)
            same = [sims[i, j] for i in range(n) for j in range(n)
                    if i < j and labels[i] == labels[j]]
            diff = [sims[i, j] for i in range(n) for j in range(n)
                    if i < j and labels[i] != labels[j]]
            return float(np.mean(same) - np.mean(diff))

        n2v_score = community_score(_fitted("node2vec")[1])
        assert n2v_score > 0.5
        assert n2v_score >= community_score(_fitted("deepwalk")[1]) - 0.05


# ------------------------------- tests/test_nlp_depth.py's walker half
class TestPopularityWalker:
    def test_walks_prefer_popular_nodes(self):
        g = star_graph()
        it = PG.PopularityWalkIterator(
            g, walk_length=4, spread=1,
            popularity_mode=PG.PopularityMode.MAXIMUM, seed=0)
        walks = list(it)
        assert len(walks) == g.num_vertices()
        assert all(len(w) == 4 for w in walks)
        by_start = {w[0]: w for w in walks}
        assert by_start[1][1] == 0
        assert by_start[2][1] == 0

    def test_minimum_mode_avoids_hub(self):
        g = star_graph()
        it = PG.PopularityWalkIterator(
            g, walk_length=2, spread=1,
            popularity_mode=PG.PopularityMode.MINIMUM, seed=0)
        assert {w[0]: w for w in it}[6][1] == 7


class TestNearestVertexWalker:
    def test_unlimited_walk_is_full_neighborhood(self):
        seqs = dict(iter(PG.NearestVertexWalkIterator(
            star_graph(), walk_length=0, shuffle=False)))
        assert sorted(seqs[0]) == [1, 2, 3, 4, 5]
        assert sorted(seqs[6]) == [5, 7]

    def test_max_popularity_sampling(self):
        seqs = dict(iter(PG.NearestVertexWalkIterator(
            star_graph(), walk_length=1, shuffle=False,
            sampling_mode=PG.NearestVertexSamplingMode.MAX_POPULARITY)))
        assert seqs[5] == [0]

    def test_depth_two_merges_neighbors(self):
        seqs = dict(iter(PG.NearestVertexWalkIterator(
            star_graph(), walk_length=0, depth=2, shuffle=False)))
        assert 6 in seqs[0]
