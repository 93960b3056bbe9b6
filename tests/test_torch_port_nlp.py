"""The port's NLP stack (`deeplearning4j_tpu_torch/nlp/`) held against the
JAX package's (`deeplearning4j_tpu/nlp/`) on the CPU.

- Every device function of the SequenceVectors engine gets the same
  numpy inputs (repeated rows, `valid` masks, `trainable_from` > 0) in
  both packages: tables and losses within ENGINE_ATOL.
- Word2Vec in all four modes, ParagraphVectors (DM, DBOW,
  `infer_vector`) and GloVe fitted from one seed in both packages: the
  tables within FIT_ATOL (every draw is numpy, in the same order; only
  float32 rounding differs), the vocab order and Huffman codes equal.
- The rest of `tests/test_nlp.py` and the NLP half of
  `tests/test_nlp_depth.py`, one for one (not the JAX compile-count
  test: the port compiles nothing).
"""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import functools

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as JN
import deeplearning4j_tpu_torch.nlp as PN
from deeplearning4j_tpu.nlp import sequencevectors as J
from deeplearning4j_tpu_torch.nlp import sequencevectors as P

CPU = torch.device("cpu")
ENGINE_ATOL = 1e-6   # one engine step's tables, port against JAX
LOSS_RTOL = 1e-6     # its loss (a sum of ~40 terms: 1e-6 relative)
FIT_ATOL = 1e-6      # a fit's tables, port against JAX (measured 1e-8)


def synthetic_corpus(n=400, seed=0):
    """Two-topic corpus: weather words co-occur, finance words co-occur
    (tests/test_nlp.py's)."""
    rng = np.random.default_rng(seed)
    weather = ["rain", "snow", "storm", "cloud", "wind", "sun"]
    finance = ["bank", "money", "stock", "market", "trade", "price"]
    shared = ["the", "a", "and", "of", "in"]
    sentences = []
    for _ in range(n):
        topic = weather if rng.random() < 0.5 else finance
        words = [topic[rng.integers(len(topic))] for _ in range(8)]
        for i in sorted(rng.integers(0, len(words), 2))[::-1]:
            words.insert(i, shared[rng.integers(len(shared))])
        sentences.append(" ".join(words))
    return sentences


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ENGINE_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# ------------------------------------------------------------ engine steps
class _Inputs:
    """Seeded inputs with repeated rows: V 12 rows for B 16 pairs."""

    V, D, B, K, W2, C = 12, 8, 16, 3, 5, 4

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        V, D, B = self.V, self.D, self.B
        self.syn0 = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
        self.syn1 = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
        self.c = rng.integers(0, V, B).astype(np.int32)
        self.x = rng.integers(0, V, B).astype(np.int32)
        self.n = rng.integers(0, V, (B, self.K)).astype(np.int32)
        self.valid = (rng.random(B) < 0.7).astype(np.float32)
        self.ctx = rng.integers(0, V, (B, self.W2)).astype(np.int32)
        mask = (rng.random((B, self.W2)) < 0.7).astype(np.float32)
        mask[:, 0] = 1.0
        self.mask = mask
        self.points = rng.integers(0, V, (B, self.C)).astype(np.int32)
        self.codes = rng.integers(0, 2, (B, self.C)).astype(np.float32)
        cm = (rng.random((B, self.C)) < 0.7).astype(np.float32)
        cm[:, 0] = 1.0
        self.cmask = cm
        self.lr = np.float32(0.07)


def _plr(lr):
    return P._scalar(lr, CPU)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("trainable_from", [0, 7])
def test_sg_neg_math_matches_jax(valid, trainable_from):
    import jax.numpy as jnp
    d = _Inputs(0)
    v = d.valid if valid else None
    w0, w1, wl = J._sg_neg_math(
        jnp.asarray(d.syn0), jnp.asarray(d.syn1), jnp.asarray(d.c),
        jnp.asarray(d.x), jnp.asarray(d.n), d.lr, trainable_from,
        None if v is None else jnp.asarray(v))
    g0, g1, gl = P._sg_neg_math(_t(d.syn0), _t(d.syn1), _t(d.c), _t(d.x),
                                _t(d.n), _plr(d.lr), trainable_from,
                                None if v is None else _t(v))
    _close(g0, w0)
    _close(g1, w1)
    _close_loss(gl, wl)
    if trainable_from:
        np.testing.assert_array_equal(g1.numpy(), d.syn1)
        np.testing.assert_array_equal(g0.numpy()[:trainable_from],
                                      d.syn0[:trainable_from])


@pytest.mark.parametrize("trainable_from", [0, 7])
def test_sg_neg_scan_matches_jax(trainable_from):
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    d = _Inputs(1)
    k = 3
    c = rng.integers(0, d.V, (k, d.B)).astype(np.int32)
    x = rng.integers(0, d.V, (k, d.B)).astype(np.int32)
    n = rng.integers(0, d.V, (k, d.B, d.K)).astype(np.int32)
    lrs = np.linspace(0.05, 0.03, k, dtype=np.float32)
    w0, w1, wl = J._sg_neg_scan(jnp.asarray(d.syn0), jnp.asarray(d.syn1),
                                jnp.asarray(c), jnp.asarray(x),
                                jnp.asarray(n), jnp.asarray(lrs),
                                trainable_from)
    g0, g1, gl = P._sg_neg_scan(_t(d.syn0), _t(d.syn1), _t(c), _t(x), _t(n),
                                _t(lrs), trainable_from)
    _close(g0, w0)
    _close(g1, w1)
    _close_loss(gl, wl)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("trainable_from", [0, 7])
def test_cbow_neg_math_matches_jax(valid, trainable_from):
    import jax.numpy as jnp
    d = _Inputs(2)
    v = d.valid if valid else None
    w0, w1, wl = J._cbow_neg_math(
        jnp.asarray(d.syn0), jnp.asarray(d.syn1), jnp.asarray(d.ctx),
        jnp.asarray(d.mask), jnp.asarray(d.c), jnp.asarray(d.n), d.lr,
        trainable_from, None if v is None else jnp.asarray(v))
    g0, g1, gl = P._cbow_neg_math(
        _t(d.syn0), _t(d.syn1), _t(d.ctx), _t(d.mask), _t(d.c), _t(d.n),
        _plr(d.lr), trainable_from, None if v is None else _t(v))
    _close(g0, w0)
    _close(g1, w1)
    _close_loss(gl, wl)


def test_hs_path_grads_matches_jax():
    import jax.numpy as jnp
    d = _Inputs(3)
    h = np.random.default_rng(3).standard_normal((d.B, d.D)).astype(
        np.float32)
    want = J._hs_path_grads(jnp.asarray(h), jnp.asarray(d.syn1),
                            jnp.asarray(d.points), jnp.asarray(d.codes),
                            jnp.asarray(d.cmask))
    got = P._hs_path_grads(_t(h), _t(d.syn1), _t(d.points), _t(d.codes),
                           _t(d.cmask))
    _close_loss(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


@pytest.mark.parametrize("valid", [False, True])
def test_sg_hs_math_matches_jax(valid):
    import jax.numpy as jnp
    d = _Inputs(4)
    v = d.valid if valid else None
    want = J._sg_hs_math(jnp.asarray(d.syn0), jnp.asarray(d.syn1),
                         jnp.asarray(d.c), jnp.asarray(d.points),
                         jnp.asarray(d.codes), jnp.asarray(d.cmask), d.lr,
                         None if v is None else jnp.asarray(v))
    got = P._sg_hs_math(_t(d.syn0), _t(d.syn1), _t(d.c), _t(d.points),
                        _t(d.codes), _t(d.cmask), _plr(d.lr),
                        None if v is None else _t(v))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    _close_loss(got[2], want[2])


@pytest.mark.parametrize("valid", [False, True])
def test_cbow_hs_math_matches_jax(valid):
    import jax.numpy as jnp
    d = _Inputs(5)
    v = d.valid if valid else None
    want = J._cbow_hs_math(jnp.asarray(d.syn0), jnp.asarray(d.syn1),
                           jnp.asarray(d.ctx), jnp.asarray(d.mask),
                           jnp.asarray(d.c), jnp.asarray(d.points),
                           jnp.asarray(d.codes), jnp.asarray(d.cmask), d.lr,
                           None if v is None else jnp.asarray(v))
    got = P._cbow_hs_math(_t(d.syn0), _t(d.syn1), _t(d.ctx), _t(d.mask),
                          _t(d.c), _t(d.points), _t(d.codes), _t(d.cmask),
                          _plr(d.lr), None if v is None else _t(v))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    _close_loss(got[2], want[2])


@pytest.mark.parametrize("trainable_from", [0, 7])
def test_mesh_step_matches_jax_global_step(trainable_from):
    """The sharded step over `["cpu"] * 8` (row counts over the global
    batch, the shards' row sums added across replicas) against JAX's
    global-view step, which is `_sg_neg_math` on the whole batch."""
    import jax.numpy as jnp
    d = _Inputs(6)
    w0, w1, wl = J._sg_neg_math(
        jnp.asarray(d.syn0), jnp.asarray(d.syn1), jnp.asarray(d.c),
        jnp.asarray(d.x), jnp.asarray(d.n), d.lr, trainable_from)
    g0, g1, gl = P._sg_neg_mesh(_t(d.syn0), _t(d.syn1), _t(d.c), _t(d.x),
                                _t(d.n), _plr(d.lr), trainable_from,
                                [CPU] * 8)
    _close(g0, w0)
    _close(g1, w1)
    _close_loss(gl, wl)


# -------------------------------------------------------- whole trainers
_MODES = ["sg_neg", "cbow", "hs", "cbow_hs"]


def _w2v_kw(mode):
    hs = mode in ("hs", "cbow_hs")
    return dict(sentence_iterator=synthetic_corpus(), layer_size=24,
                window_size=4, min_word_frequency=2,
                negative_sample=0 if hs else 5, use_hierarchic_softmax=hs,
                cbow=mode in ("cbow", "cbow_hs"), learning_rate=0.05,
                epochs=3, batch_size=512, seed=7)


@functools.lru_cache(maxsize=None)
def _w2v_pair(mode):
    """(JAX, port) Word2Vec fitted from one seed (each mode once)."""
    return (JN.Word2Vec(**_w2v_kw(mode)).fit(),
            PN.Word2Vec(**_w2v_kw(mode), device=CPU).fit())


class TestWord2Vec:
    @pytest.mark.parametrize("mode", _MODES)
    def test_fit_matches_jax(self, mode):
        j, p = _w2v_pair(mode)
        assert p.vocab.words() == j.vocab.words()
        for i in range(j.vocab.num_words()):
            a, b = j.vocab.element_at_index(i), p.vocab.element_at_index(i)
            assert (a.codes, a.points) == (b.codes, b.points)
        for t in ("syn0", "syn1neg", "syn1"):
            assert isinstance(getattr(p, t), np.ndarray)
            _close(getattr(p, t), getattr(j, t), FIT_ATOL)
        assert p.last_loss == pytest.approx(j.last_loss, abs=1e-5)

    @pytest.mark.parametrize("mode", _MODES)
    def test_topic_clustering(self, mode):
        _, w2v = _w2v_pair(mode)
        in_topic = w2v.similarity("rain", "snow")
        cross = w2v.similarity("rain", "money")
        assert in_topic > cross, f"{mode}: {in_topic} <= {cross}"
        near = w2v.words_nearest("stock", top_n=4)
        finance = {"bank", "money", "market", "trade", "price"}
        assert len(finance.intersection(near)) >= 2, near

    def test_words_nearest_matches_jax(self):
        j, p = _w2v_pair("sg_neg")
        for w in j.vocab.words():
            assert p.words_nearest(w, 5) == j.words_nearest(w, 5)

    def test_word_vector_api(self):
        w2v = PN.Word2Vec(sentence_iterator=["a b c", "a c"], layer_size=8,
                          epochs=1, min_word_frequency=1, device=CPU)
        w2v.fit()
        assert w2v.has_word("a") and not w2v.has_word("zzz")
        assert w2v.get_word_vector("a").shape == (8,)
        assert w2v.get_word_vector("zzz") is None

    def test_one_copy_per_array_a_group_and_ragged_tails(self):
        """A fused group goes to the device in one `_upload` of its four
        arrays; a ragged tail runs at its own length."""
        seqs = [[f"w{t}" for t in np.random.default_rng(s).integers(0, 30,
                                                                    40)]
                for s in range(20)]
        m = PN.Word2Vec(layer_size=8, window_size=3, negative_sample=4,
                        batch_size=64, device=CPU)
        m.conf.steps_per_flush = 4
        calls = []
        up = m._upload
        m._upload = lambda *a: (calls.append([x.shape for x in a]),
                                up(*a))[1]
        m.fit(seqs)
        groups = [c for c in calls if len(c) == 4]
        assert groups and all(c[0] == (4, 64) and c[2] == (4, 64, 4)
                              for c in groups)
        singles = [c for c in calls if len(c) == 3]
        assert singles and 0 < singles[-1][0][0] < 64


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.Word2Vec()
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.SequenceVectors()
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.ParagraphVectors()
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.Glove()
    from deeplearning4j_tpu_torch.nlp.word2vec import load_packaged_word2vec
    with pytest.raises(RuntimeError, match="CUDA"):
        load_packaged_word2vec()
    m = PN.Word2Vec(sentence_iterator=["a b c"], layer_size=4,
                    device=CPU).fit()
    PN.WordVectorSerializer.write_binary(m, tmp_path / "v.bin")
    PN.WordVectorSerializer.write_text(m, tmp_path / "v.txt")
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.WordVectorSerializer.read_binary(tmp_path / "v.bin")
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.WordVectorSerializer.read_text(tmp_path / "v.txt")


# ------------------------------------------------- tests/test_nlp.py, ported
class TestTokenization:
    def test_default_tokenizer_and_preprocessor(self):
        fac = PN.DefaultTokenizerFactory(PN.CommonPreprocessor())
        toks = fac.create("Hello, World! 42 times").get_tokens()
        assert toks == JN.DefaultTokenizerFactory(
            JN.CommonPreprocessor()).create("Hello, World! 42 times"
                                            ).get_tokens()
        assert toks in (["hello", "world", "time"],
                        ["hello", "world", "times"])

    def test_ngram_tokenizer(self):
        fac = PN.NGramTokenizerFactory(min_n=1, max_n=2)
        toks = fac.create("a b c").get_tokens()
        assert "a b" in toks and "b c" in toks and "a" in toks
        assert toks == JN.NGramTokenizerFactory(min_n=1, max_n=2).create(
            "a b c").get_tokens()


class TestSentenceIterators:
    def test_collection_iterator_resets(self):
        it = PN.CollectionSentenceIterator(["one", "two"])
        assert list(it) == ["one", "two"]
        assert list(it) == ["one", "two"]

    def test_line_iterator(self, tmp_path):
        p = tmp_path / "corpus.txt"
        p.write_text("first line\nsecond line\n")
        it = PN.BasicLineIterator(p)
        assert list(it) == ["first line", "second line"]


class TestVocab:
    def test_construction_and_frequency_order(self):
        cache = PN.VocabConstructor().build([["b", "a", "a"], ["a", "c"]])
        assert cache.num_words() == 3
        assert cache.word_at_index(0) == "a"  # most frequent first
        assert cache.word_frequency("a") == 3

    def test_min_frequency_pruning(self):
        cache = PN.VocabConstructor(min_word_frequency=2).build(
            [["a", "a", "b"], ["c", "a"]])
        assert cache.contains_word("a") and not cache.contains_word("b")

    def test_huffman_codes_prefix_free(self):
        cache = PN.VocabConstructor().build(
            [["a"] * 8 + ["b"] * 4 + ["c"] * 2 + ["d"]])
        codes = {w: "".join(map(str, cache.word_for(w).codes))
                 for w in ["a", "b", "c", "d"]}
        vals = list(codes.values())
        for i, c1 in enumerate(vals):
            for j, c2 in enumerate(vals):
                if i != j:
                    assert not c2.startswith(c1)
        assert len(codes["a"]) <= len(codes["d"])

    def test_order_and_huffman_equal_jax_with_ties(self):
        """Index order (frequency, then word) and the Huffman tree (heap
        ties broken by the insertion counter) equal JAX's on a zipf
        corpus full of frequency ties."""
        rng = np.random.default_rng(5)
        seqs = [[f"w{t}" for t in rng.zipf(1.5, 50) % 300]
                for _ in range(40)]
        a = JN.VocabConstructor().build(seqs)
        b = PN.VocabConstructor().build(seqs)
        assert a.words() == b.words()
        assert a.total_word_count == b.total_word_count
        for i in range(a.num_words()):
            x, y = a.element_at_index(i), b.element_at_index(i)
            assert (x.index, x.frequency, x.codes, x.points) == \
                (y.index, y.frequency, y.codes, y.points)


class TestSerialization:
    def _small_model(self):
        w2v = PN.Word2Vec(sentence_iterator=["alpha beta gamma",
                                             "alpha gamma"],
                          layer_size=6, epochs=1, device=CPU)
        return w2v.fit()

    def test_binary_roundtrip(self, tmp_path):
        w2v = self._small_model()
        path = tmp_path / "vecs.bin"
        PN.WordVectorSerializer.write_binary(w2v, path)
        loaded = PN.WordVectorSerializer.read_binary(path, device=CPU)
        for w in ["alpha", "beta", "gamma"]:
            np.testing.assert_array_equal(loaded.get_word_vector(w),
                                          w2v.get_word_vector(w))

    def test_text_roundtrip(self, tmp_path):
        w2v = self._small_model()
        path = tmp_path / "vecs.txt"
        PN.WordVectorSerializer.write_text(w2v, path)
        loaded = PN.WordVectorSerializer.read_text(path, device=CPU)
        for w in ["alpha", "beta", "gamma"]:
            np.testing.assert_allclose(loaded.get_word_vector(w),
                                       w2v.get_word_vector(w), atol=1e-5)

    @pytest.mark.parametrize("fmt", ["binary", "text"])
    def test_each_package_reads_the_others_file(self, tmp_path, fmt):
        """JAX's write, the port's read, and the other way round: the
        same bytes each way, the same vocab and table."""
        j = JN.Word2Vec(sentence_iterator=synthetic_corpus(30),
                        layer_size=8, epochs=1, seed=2).fit()
        p = PN.Word2Vec(sentence_iterator=synthetic_corpus(30),
                        layer_size=8, epochs=1, seed=2, device=CPU).fit()
        jw = getattr(JN.WordVectorSerializer, f"write_{fmt}")
        pw = getattr(PN.WordVectorSerializer, f"write_{fmt}")
        jw(j, tmp_path / "j")
        pw(p, tmp_path / "p")
        pr = getattr(PN.WordVectorSerializer, f"read_{fmt}")(
            tmp_path / "j", device=CPU)
        jr = getattr(JN.WordVectorSerializer, f"read_{fmt}")(tmp_path / "p")
        assert pr.vocab.words() == getattr(
            JN.WordVectorSerializer, f"read_{fmt}")(tmp_path / "j"
                                                    ).vocab.words()
        np.testing.assert_array_equal(
            pr.syn0, getattr(JN.WordVectorSerializer, f"read_{fmt}")(
                tmp_path / "j").syn0)
        np.testing.assert_array_equal(
            jr.syn0, getattr(PN.WordVectorSerializer, f"read_{fmt}")(
                tmp_path / "p", device=CPU).syn0)
        # and each writer gives the other's bytes for the same vectors
        pw(pr, tmp_path / "p_again")
        jw(getattr(JN.WordVectorSerializer, f"read_{fmt}")(tmp_path / "j"),
           tmp_path / "j_again")
        assert (tmp_path / "p_again").read_bytes() == \
            (tmp_path / "j_again").read_bytes()

    def test_warm_start_training_after_load(self, tmp_path):
        w2v = self._small_model()
        path = tmp_path / "vecs.bin"
        PN.WordVectorSerializer.write_binary(w2v, path)
        loaded = PN.WordVectorSerializer.read_binary(path, device=CPU)
        assert loaded._neg_table is None        # nothing built yet
        reinits = []
        orig_init = loaded._init_tables
        loaded._init_tables = lambda *a, **k: (reinits.append(1),
                                               orig_init(*a, **k))
        loaded.conf.epochs = 1
        loaded.fit([["alpha", "beta"], ["gamma", "alpha"]])
        assert not reinits, "warm start must not re-randomize syn0"
        assert loaded._neg_table is not None    # aux state rebuilt lazily
        assert loaded.syn1neg is not None
        assert np.isfinite(loaded.get_word_vector("alpha")).all()

    def test_warm_start_hs_actually_trains(self, tmp_path):
        w2v = self._small_model()
        path = tmp_path / "vecs.bin"
        PN.WordVectorSerializer.write_binary(w2v, path)
        loaded = PN.WordVectorSerializer.read_binary(path, device=CPU)
        loaded.conf.use_hierarchic_softmax = True
        loaded.conf.negative = 0
        loaded.conf.epochs = 2
        loaded.fit([["alpha", "beta", "gamma"], ["gamma", "alpha"]])
        V = loaded.vocab.num_words()
        assert any(len(loaded.vocab.element_at_index(i).codes)
                   for i in range(V))
        assert np.abs(np.asarray(loaded.syn1)).max() > 0, \
            "HS warm-start training changed nothing (masked no-op)"

    def test_warm_start_with_extra_rows_keeps_vectors(self, tmp_path):
        w2v = self._small_model()
        path = tmp_path / "vecs.bin"
        PN.WordVectorSerializer.write_binary(w2v, path)
        loaded = PN.WordVectorSerializer.read_binary(path, device=CPU)
        V = loaded.vocab.num_words()
        before = np.asarray(loaded.syn0).copy()
        loaded.conf.learning_rate = 1e-9
        loaded.conf.min_learning_rate = 1e-12
        loaded.conf.epochs = 1
        loaded.fit([["alpha", "beta"]], extra_rows=2)
        assert loaded.syn0.shape[0] == V + 2
        np.testing.assert_allclose(np.asarray(loaded.syn0)[:V], before,
                                   atol=1e-5)


def _pv_docs(n=200):
    corpus = synthetic_corpus(n)
    return [(s, [f"DOC_{i}"]) for i, s in enumerate(corpus)], corpus


@functools.lru_cache(maxsize=None)
def _pv_pair(dm, epochs):
    docs, _ = _pv_docs()
    return tuple(N.ParagraphVectors(
        documents=[N.LabelledDocument(s, l) for s, l in docs], layer_size=16,
        epochs=epochs, min_word_frequency=2, dm=dm, seed=3, **kw).fit()
        for N, kw in ((JN, {}), (PN, {"device": CPU})))


class TestParagraphVectors:
    @pytest.mark.parametrize("dm", [False, True])
    def test_fit_matches_jax(self, dm):
        j, p = _pv_pair(dm, 3)
        assert p.labels == j.labels
        _close(p.syn0, j.syn0, FIT_ATOL)
        _close(p.syn1neg, j.syn1neg, FIT_ATOL)

    def test_infer_vector_matches_jax(self):
        j, p = _pv_pair(False, 2)
        _close(p.infer_vector("rain snow storm wind"),
               j.infer_vector("rain snow storm wind"), FIT_ATOL)

    @pytest.mark.parametrize("dm", [False, True])
    def test_doc_vectors_cluster_by_topic(self, dm):
        _, corpus = _pv_docs()
        _, pv = _pv_pair(dm, 3)
        weather_docs = [i for i, s in enumerate(corpus)
                        if "rain" in s and "bank" not in s]
        finance_docs = [i for i, s in enumerate(corpus)
                        if "bank" in s and "rain" not in s]
        if len(weather_docs) >= 2 and len(finance_docs) >= 2:
            same = pv.similarity_doc(f"DOC_{weather_docs[0]}",
                                     f"DOC_{weather_docs[1]}")
            diff = pv.similarity_doc(f"DOC_{weather_docs[0]}",
                                     f"DOC_{finance_docs[0]}")
            assert same > diff

    def test_infer_vector(self):
        docs, _ = _pv_docs()
        pv = PN.ParagraphVectors(
            documents=[PN.LabelledDocument(s, l) for s, l in docs],
            layer_size=16, epochs=2, min_word_frequency=2, seed=3,
            device=CPU)
        pv.fit()
        rows_before = pv.syn0.shape[0]
        vec = pv.infer_vector("rain snow storm wind")
        assert vec.shape == (16,)
        assert pv.syn0.shape[0] == rows_before  # scratch row popped

        def cos(a, b):
            return float(np.dot(a, b) / (np.linalg.norm(a)
                                         * np.linalg.norm(b) + 1e-9))
        assert cos(vec, pv.get_word_vector("rain")) > cos(
            vec, pv.get_word_vector("bank"))
        syn1neg_before = pv.syn1neg.copy()
        pv.infer_vector("rain snow storm wind")
        np.testing.assert_array_equal(syn1neg_before, np.asarray(pv.syn1neg))

    def test_duplicate_labels_share_one_row(self):
        docs = [PN.LabelledDocument("rain snow storm", ["weather"]),
                PN.LabelledDocument("wind cloud sun rain", ["weather"]),
                PN.LabelledDocument("bank money stock", ["finance"])]
        pv = PN.ParagraphVectors(documents=docs, layer_size=8, epochs=2,
                                 min_word_frequency=1, seed=1, device=CPU)
        pv.fit()
        assert pv.labels == ["weather", "finance"]
        assert pv.syn0.shape[0] == pv.vocab.num_words() + 2
        assert np.isnan(pv.similarity_doc("weather", "nope"))


@functools.lru_cache(maxsize=None)
def _glove_pair():
    seqs = [s.split() for s in synthetic_corpus(300)]
    kw = dict(layer_size=16, window=4, min_word_frequency=2, epochs=20,
              learning_rate=0.05, seed=5)
    return JN.Glove(**kw).fit(seqs), PN.Glove(**kw, device=CPU).fit(seqs)


class TestGlove:
    def test_fit_matches_jax(self):
        j, p = _glove_pair()
        # 20 epochs of AdaGrad: measured 2.8e-7 apart
        _close(p.syn0, j.syn0, 1e-5)
        assert p.last_loss == pytest.approx(j.last_loss, rel=1e-5)

    def test_topic_clustering(self):
        _, g = _glove_pair()
        assert g.similarity("rain", "snow") > g.similarity("rain", "money")


class TestBagOfWords:
    def test_count_vectorizer(self):
        cv = PN.CountVectorizer()
        X = cv.fit_transform(["a b a", "b c"])
        assert X.shape == (2, 3)
        assert X[0, cv.vocab.index_of("a")] == 2
        np.testing.assert_array_equal(
            X, JN.CountVectorizer().fit_transform(["a b a", "b c"]))

    def test_tfidf_downweights_common_terms(self):
        tv = PN.TfidfVectorizer()
        docs = ["common rare1", "common rare2", "common rare3"]
        X = tv.fit_transform(docs)
        ci = tv.vocab.index_of("common")
        ri = tv.vocab.index_of("rare1")
        assert X[0, ci] < X[0, ri]  # idf(common)=log(1)=0
        np.testing.assert_array_equal(
            X, JN.TfidfVectorizer().fit_transform(docs))


class TestCnnSentenceIterator:
    def test_batch_shapes_and_mask(self):
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        w2v = PN.Word2Vec(sentence_iterator=["deep learning rocks",
                                             "learning is fun"],
                          layer_size=4, epochs=1, device=CPU)
        w2v.fit()
        it = PN.CnnSentenceDataSetIterator(
            ["deep learning", "fun"], [0, 1], w2v, num_classes=2,
            batch_size=2)
        ds = next(iter(it))
        assert isinstance(ds, DataSet)
        assert ds.features.shape[0] == 2
        assert ds.features.shape[3] == 1
        assert ds.labels.shape == (2, 2)
        assert ds.features_mask[1].sum() == 1  # "fun" → one token


class TestDistributedSequenceVectors:
    """Mesh-sharded embedding training on `["cpu"] * 8`: the sharded run
    must match the single-device run (JAX's own bar)."""

    def _corpus(self):
        rng = np.random.default_rng(11)
        vocab = [f"w{i}" for i in range(50)]
        return [[vocab[t] for t in rng.integers(0, 50, 60)]
                for _ in range(30)]

    def test_mesh_matches_single_device(self):
        from deeplearning4j_tpu_torch.parallel.mesh import (
            MeshSpec, make_mesh)
        seqs = self._corpus()
        kw = dict(layer_size=16, window_size=3, negative_sample=3,
                  min_word_frequency=1, epochs=2, batch_size=64, seed=5,
                  device=CPU)
        single = PN.Word2Vec(**kw)
        single.build_vocab(seqs)
        single.fit(seqs)
        sharded = PN.Word2Vec(**kw)
        sharded.mesh = make_mesh(MeshSpec.of(data=8), devices=["cpu"] * 8)
        sharded.build_vocab(seqs)
        sharded.fit(seqs)
        np.testing.assert_allclose(sharded.syn0, single.syn0,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sharded.syn1neg, single.syn1neg,
                                   rtol=1e-4, atol=1e-5)
        jax_single = JN.Word2Vec(**{k: v for k, v in kw.items()
                                    if k != "device"})
        jax_single.build_vocab(seqs)
        jax_single.fit(seqs)
        _close(single.syn0, jax_single.syn0, FIT_ATOL)

    def test_fused_flush_trains(self):
        rng = np.random.default_rng(3)
        seqs = []
        for _ in range(120):
            s = []
            for _ in range(30):
                s.extend(["sun", "moon"] if rng.random() < 0.5
                         else ["cat", "dog"])
            seqs.append(s)
        w2v = PN.Word2Vec(layer_size=24, window_size=2, negative_sample=4,
                          epochs=3, batch_size=256, seed=1, device=CPU)
        w2v.conf.steps_per_flush = 4
        w2v.build_vocab(seqs)
        w2v.fit(seqs)
        assert w2v.similarity("sun", "moon") > w2v.similarity("sun", "dog")


def _dense_grads(loss_fn, syn0, syn1):
    a = torch.tensor(syn0, requires_grad=True)
    b = torch.tensor(syn1, requires_grad=True)
    loss = loss_fn(a, b)
    g0, g1 = torch.autograd.grad(loss, (a, b))
    return loss.detach(), g0.numpy(), g1.numpy()


def _counts(V, *sets):
    c = np.zeros(V, np.float32)
    for s in sets:
        if isinstance(s, tuple):
            np.add.at(c, s[0].reshape(-1), s[1].reshape(-1))
        else:
            np.add.at(c, s.reshape(-1), 1.0)
    return np.clip(c, 1.0, None)[:, None]


class TestSparseUpdateParity:
    """The closed-form scatter updates equal the dense autodiff gradient
    of the loss divided by each row's count."""

    def test_matches_autodiff_dense(self):
        import torch.nn.functional as F
        d = _Inputs(7)
        c, x, n = (torch.from_numpy(a.astype(np.int64))
                   for a in (d.c, d.x, d.n))

        def loss_fn(s0, s1):
            v, up, un = s0[c], s1[x], s1[n]
            pos = F.logsigmoid((v * up).sum(-1))
            neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, un)).sum(-1)
            return -(pos + neg).sum()

        loss_ref, g0, g1 = _dense_grads(loss_fn, d.syn0, d.syn1)
        want0 = d.syn0 - d.lr * g0 / _counts(d.V, d.c)
        want1 = d.syn1 - d.lr * g1 / _counts(d.V, d.x, d.n)
        got0, got1, loss = P._sg_neg_math(_t(d.syn0), _t(d.syn1), _t(d.c),
                                          _t(d.x), _t(d.n), _plr(d.lr), 0)
        np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-5, atol=1e-6)
        assert abs(float(loss) * d.B - float(loss_ref)) < 1e-3

    def test_inference_mode_freezes_rows(self):
        rng = np.random.default_rng(1)
        syn0 = rng.standard_normal((10, 4)).astype(np.float32)
        syn1 = rng.standard_normal((10, 4)).astype(np.float32)
        got0, got1, _ = P._sg_neg_math(
            _t(syn0), _t(syn1), _t(np.int32([2, 8, 9])),
            _t(np.int32([1, 3, 4])), _t(np.int32([[5], [6], [7]])),
            _plr(0.1), 8)
        np.testing.assert_array_equal(got1.numpy(), syn1)
        np.testing.assert_array_equal(got0.numpy()[:8], syn0[:8])
        assert not np.allclose(got0.numpy()[8:], syn0[8:])


class TestSparseCbowHsParity:
    """CBOW-NS / SG-HS / CBOW-HS closed-form scatters vs autodiff."""

    @staticmethod
    def _h(s0, ctx, mask):
        m = mask[..., None]
        return (s0[ctx] * m).sum(1) / mask.sum(1, keepdim=True).clamp(
            min=1.0)

    @staticmethod
    def _hs_loss(h, s1, points, codes, cmask):
        import torch.nn.functional as F
        sign = 1.0 - 2.0 * codes
        logits = torch.einsum("bd,bcd->bc", h, s1[points]) * sign
        return -(F.logsigmoid(logits) * cmask).sum()

    def test_cbow_neg_matches_autodiff(self):
        import torch.nn.functional as F
        d = _Inputs(8)
        ctx, c, n = (torch.from_numpy(a.astype(np.int64))
                     for a in (d.ctx, d.c, d.n))
        mask = torch.from_numpy(d.mask)

        def loss_fn(s0, s1):
            h = self._h(s0, ctx, mask)
            pos = F.logsigmoid((h * s1[c]).sum(-1))
            neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", h, s1[n])).sum(-1)
            return -(pos + neg).sum()

        _, g0, g1 = _dense_grads(loss_fn, d.syn0, d.syn1)
        want0 = d.syn0 - d.lr * g0 / _counts(d.V, (d.ctx, d.mask))
        want1 = d.syn1 - d.lr * g1 / _counts(d.V, d.c, d.n)
        got0, got1, _ = P._cbow_neg_math(
            _t(d.syn0), _t(d.syn1), _t(d.ctx), _t(d.mask), _t(d.c), _t(d.n),
            _plr(d.lr), 0)
        np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-5, atol=1e-6)

    def test_sg_hs_matches_autodiff(self):
        d = _Inputs(9)
        c, pts = (torch.from_numpy(a.astype(np.int64))
                  for a in (d.c, d.points))
        codes, cm = torch.from_numpy(d.codes), torch.from_numpy(d.cmask)
        _, g0, g1 = _dense_grads(
            lambda s0, s1: self._hs_loss(s0[c], s1, pts, codes, cm),
            d.syn0, d.syn1)
        want0 = d.syn0 - d.lr * g0 / _counts(d.V, d.c)
        want1 = d.syn1 - d.lr * g1 / _counts(d.V, (d.points, d.cmask))
        got0, got1, _ = P._sg_hs_math(_t(d.syn0), _t(d.syn1), _t(d.c),
                                      _t(d.points), _t(d.codes),
                                      _t(d.cmask), _plr(d.lr))
        np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-5, atol=1e-6)

    def test_cbow_hs_matches_autodiff(self):
        d = _Inputs(10)
        ctx, pts = (torch.from_numpy(a.astype(np.int64))
                    for a in (d.ctx, d.points))
        mask = torch.from_numpy(d.mask)
        codes, cm = torch.from_numpy(d.codes), torch.from_numpy(d.cmask)
        _, g0, g1 = _dense_grads(
            lambda s0, s1: self._hs_loss(self._h(s0, ctx, mask), s1, pts,
                                         codes, cm), d.syn0, d.syn1)
        want0 = d.syn0 - d.lr * g0 / _counts(d.V, (d.ctx, d.mask))
        want1 = d.syn1 - d.lr * g1 / _counts(d.V, (d.points, d.cmask))
        got0, got1, _ = P._cbow_hs_math(
            _t(d.syn0), _t(d.syn1), _t(d.ctx), _t(d.mask), _t(d.c),
            _t(d.points), _t(d.codes), _t(d.cmask), _plr(d.lr))
        np.testing.assert_allclose(got0.numpy(), want0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-5, atol=1e-6)


def _pad(a, B):
    out = np.zeros((B,) + a.shape[1:], a.dtype)
    out[:len(a)] = a
    return out


class TestMaskedTailParity:
    """A batch padded to B with a `valid` mask equals the ragged batch
    (the masked math changes nothing numerically)."""

    B = 16

    def _tables(self, rng, V, D):
        return ((rng.standard_normal((V, D)) * 0.1).astype(np.float32),
                (rng.standard_normal((V, D)) * 0.1).astype(np.float32))

    def _valid(self, n):
        v = np.zeros(self.B, np.float32)
        v[:n] = 1.0
        return v

    def _same(self, got, want):
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7)
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)

    def test_sg_neg_masked_equals_ragged(self):
        rng = np.random.default_rng(0)
        V, D, n, K = 50, 8, 11, 5
        s0, s1 = self._tables(rng, V, D)
        c = rng.integers(0, V, n).astype(np.int32)
        x = rng.integers(0, V, n).astype(np.int32)
        ng = rng.integers(0, V, (n, K)).astype(np.int32)
        want = P._sg_neg_math(_t(s0), _t(s1), _t(c), _t(x), _t(ng),
                              _plr(0.05), 0)
        got = P._sg_neg_math(_t(s0), _t(s1), _t(_pad(c, self.B)),
                             _t(_pad(x, self.B)), _t(_pad(ng, self.B)),
                             _plr(0.05), 0, _t(self._valid(n)))
        self._same(got, want)

    def test_sg_hs_masked_equals_ragged(self):
        rng = np.random.default_rng(1)
        V, D, n, C = 50, 8, 9, 6
        s0, s1 = self._tables(rng, V, D)
        c = rng.integers(0, V, n).astype(np.int32)
        pts = rng.integers(0, V, (n, C)).astype(np.int32)
        codes = rng.integers(0, 2, (n, C)).astype(np.float32)
        cm = (rng.random((n, C)) < 0.7).astype(np.float32)
        cm[:, 0] = 1.0
        want = P._sg_hs_math(_t(s0), _t(s1), _t(c), _t(pts), _t(codes),
                             _t(cm), _plr(0.05))
        got = P._sg_hs_math(_t(s0), _t(s1), *(_t(_pad(a, self.B))
                                              for a in (c, pts, codes, cm)),
                            _plr(0.05), _t(self._valid(n)))
        self._same(got, want)

    def test_cbow_neg_masked_equals_ragged(self):
        rng = np.random.default_rng(3)
        V, D, n, K, W2 = 50, 8, 10, 5, 6
        s0, s1 = self._tables(rng, V, D)
        ctx = rng.integers(0, V, (n, W2)).astype(np.int32)
        mask = (rng.random((n, W2)) < 0.8).astype(np.float32)
        mask[:, 0] = 1.0
        c = rng.integers(0, V, n).astype(np.int32)
        ng = rng.integers(0, V, (n, K)).astype(np.int32)
        want = P._cbow_neg_math(_t(s0), _t(s1), _t(ctx), _t(mask), _t(c),
                                _t(ng), _plr(0.05), 0)
        got = P._cbow_neg_math(_t(s0), _t(s1), *(_t(_pad(a, self.B)) for a
                                                 in (ctx, mask, c, ng)),
                               _plr(0.05), 0, _t(self._valid(n)))
        self._same(got, want)

    def test_cbow_hs_masked_equals_ragged(self):
        rng = np.random.default_rng(4)
        V, D, n, C, W2 = 50, 8, 7, 6, 6
        s0, s1 = self._tables(rng, V, D)
        ctx = rng.integers(0, V, (n, W2)).astype(np.int32)
        mask = (rng.random((n, W2)) < 0.8).astype(np.float32)
        mask[:, 0] = 1.0
        c = rng.integers(0, V, n).astype(np.int32)
        pts = rng.integers(0, V, (n, C)).astype(np.int32)
        codes = rng.integers(0, 2, (n, C)).astype(np.float32)
        cm = (rng.random((n, C)) < 0.7).astype(np.float32)
        cm[:, 0] = 1.0
        want = P._cbow_hs_math(_t(s0), _t(s1), _t(ctx), _t(mask), _t(c),
                               _t(pts), _t(codes), _t(cm), _plr(0.05))
        got = P._cbow_hs_math(
            _t(s0), _t(s1), *(_t(_pad(a, self.B))
                              for a in (ctx, mask, c, pts, codes, cm)),
            _plr(0.05), _t(self._valid(n)))
        self._same(got, want)


# ----------------------------------- tests/test_nlp_depth.py's NLP half
class TestStopWords:
    def test_default_list_filters(self):
        sw = PN.StopWords.default()
        assert "the" in sw and "and" in sw
        assert "tensor" not in sw
        assert sw.filter(["the", "quick", "fox", "and", "hound"]) == \
            ["quick", "fox", "hound"]
        assert PN.StopWords.get_stop_words() == \
            JN.StopWords.get_stop_words()

    def test_case_insensitive_by_default(self):
        assert PN.StopWords.default().is_stop_word("The")

    def test_custom_list_and_file(self, tmp_path):
        p = tmp_path / "sw.txt"
        p.write_text("foo\nbar\n")
        sw = PN.StopWords.from_file(str(p))
        assert sw.is_stop_word("foo") and not sw.is_stop_word("the")

    def test_remover_in_tokenizer_factory(self):
        tf = PN.DefaultTokenizerFactory()
        tf.set_token_pre_processor(PN.StopWordsRemover())
        assert tf.create("the quick brown fox").get_tokens() == \
            ["quick", "brown", "fox"]


class TestInvertedIndex:
    def test_postings_and_frequencies(self):
        idx = PN.InvertedIndex()
        idx.add_doc("the cat sat".split())
        idx.add_doc("the cat ran".split())
        idx.add_doc("dogs run".split())
        assert idx.documents("cat") == [0, 1]
        assert idx.documents("dogs") == [2]
        assert idx.document_frequency("the") == 2
        assert idx.term_frequency("the", 0) == 1
        assert idx.total_words() == 8
        assert idx.num_documents() == 3
        assert idx.document(1) == ["the", "cat", "ran"]

    def test_add_word_to_doc_and_batches(self):
        idx = PN.InvertedIndex()
        for w in ["a", "b", "a"]:
            idx.add_word_to_doc(0, w)
        assert idx.term_frequency("a", 0) == 2
        idx.add_doc(["c"], labels=["doc1"])
        assert idx.doc_labels(1) == ["doc1"]
        assert list(idx.batch_doc_ids(1)) == [[0], [1]]


class TestDocumentIterators:
    def _tree(self, tmp_path):
        (tmp_path / "pos").mkdir()
        (tmp_path / "neg").mkdir()
        (tmp_path / "pos" / "a.txt").write_text("good movie")
        (tmp_path / "pos" / "b.txt").write_text("great film")
        (tmp_path / "neg" / "c.txt").write_text("bad plot")
        return tmp_path

    def test_collection_iterator(self):
        it = PN.CollectionDocumentIterator(["doc one", "doc two"])
        assert list(it) == ["doc one", "doc two"]
        assert list(it) == ["doc one", "doc two"]  # reset works

    def test_file_document_iterator(self, tmp_path):
        self._tree(tmp_path)
        docs = list(PN.FileDocumentIterator(str(tmp_path)))
        assert docs == list(JN.FileDocumentIterator(str(tmp_path)))
        assert sorted(docs) == ["bad plot", "good movie", "great film"]

    def test_file_label_aware(self, tmp_path):
        self._tree(tmp_path)
        docs = list(PN.FileLabelAwareIterator(str(tmp_path)))
        assert {d.labels[0] for d in docs} == {"pos", "neg"}
        assert {d.content: d.labels[0] for d in docs}["bad plot"] == "neg"

    def test_filenames_label_aware(self, tmp_path):
        self._tree(tmp_path)
        docs = list(PN.FilenamesLabelAwareIterator(str(tmp_path)))
        assert {d.labels[0] for d in docs} == {"a", "b", "c"}


class TestStopwordsInWord2VecPipeline:
    def test_stopwords_never_enter_vocab(self):
        tf = PN.DefaultTokenizerFactory()
        tf.set_token_pre_processor(PN.StopWordsRemover())
        w2v = PN.Word2Vec(sentence_iterator=["the cat and the hat",
                                             "a cat for the hat"],
                          tokenizer_factory=tf, layer_size=8, epochs=1,
                          min_word_frequency=1, device=CPU)
        w2v.fit()
        assert w2v.has_word("cat") and w2v.has_word("hat")
        assert not w2v.has_word("the")
        assert not w2v.has_word("and")


class TestPackagedWord2Vec:
    """The packaged doc-trained vectors, read in place through the
    port's manifest → sha256 → serializer path."""

    def test_loads_and_has_structure(self):
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            load_packaged_word2vec)
        vecs = load_packaged_word2vec(device=CPU)
        assert vecs.vocab.num_words() >= 200
        assert vecs.conf.vector_length == 64
        rel = np.mean([vecs.similarity("ring", "attention"),
                       vecs.similarity("mesh", "sharding"),
                       vecs.similarity("keras", "import")])
        vocab = vecs.vocab.words()
        rng = np.random.default_rng(0)
        rand = np.mean([
            vecs.similarity(vocab[i], vocab[j])
            for i, j in zip(rng.integers(0, len(vocab), 100),
                            rng.integers(0, len(vocab), 100))
            if vocab[i] != vocab[j]])
        assert rel > rand + 0.1
        near = vecs.words_nearest("attention", top_n=5)
        assert len(near) == 5 and "attention" not in near

    def test_equals_jax_read_bit_for_bit(self):
        from deeplearning4j_tpu.nlp.word2vec import (
            load_packaged_word2vec as jax_load)
        from deeplearning4j_tpu_torch.nlp.word2vec import (
            load_packaged_word2vec)
        p, j = load_packaged_word2vec(device=CPU), jax_load()
        assert p.vocab.words() == j.vocab.words()
        np.testing.assert_array_equal(p.syn0, j.syn0)
        for w in p.vocab.words()[:50]:
            assert p.words_nearest(w, 10) == j.words_nearest(w, 10)

    def test_checksum_tamper_rejected(self, monkeypatch):
        from deeplearning4j_tpu_torch.nlp import word2vec as w2v_mod
        from deeplearning4j_tpu_torch.zoo import base as zoo_base
        real = zoo_base.packaged_weight_entry("word2vec_docs.bin")
        assert real is not None
        tampered = dict(real, sha256="0" * 64)
        monkeypatch.setattr(zoo_base, "packaged_weight_entry",
                            lambda name: tampered)
        with pytest.raises(ValueError, match="checksum"):
            w2v_mod.load_packaged_word2vec(device=CPU)


class TestAsyncProducer:
    """The pair packer on a producer thread must be bit-equal to the
    inline path (the negatives stream is flush-side, the packing stream
    producer-side)."""

    def _train(self, async_on):
        rng = np.random.default_rng(3)
        words = [f"w{i}" for i in range(50)]
        corp = [" ".join(words[j] for j in rng.integers(0, 50, 12))
                for _ in range(200)]
        w2v = PN.Word2Vec(sentence_iterator=corp, layer_size=16,
                          window_size=3, min_word_frequency=1,
                          negative_sample=5, learning_rate=0.05, epochs=2,
                          batch_size=256, seed=12, device=CPU)
        w2v.conf.async_producer = async_on
        return w2v.fit()

    def test_async_matches_sync_bitwise(self):
        a = self._train(True)
        s = self._train(False)
        np.testing.assert_array_equal(a.syn0, s.syn0)
        np.testing.assert_array_equal(a.syn1neg, s.syn1neg)
        assert a.etl_stats["mode"] == "async"
        assert s.etl_stats["mode"] == "sync"

    def test_wait_accounting_populated(self):
        a = self._train(True)
        assert a.etl_stats["producer_wait_ms"] >= 0.0
        assert a.etl_stats["consumer_wait_ms"] >= 0.0

    def test_producer_error_propagates(self):
        sv = PN.SequenceVectors(PN.SequenceVectorsConfig(
            vector_length=8, window=2, batch_size=64, epochs=1,
            min_word_frequency=1), device=CPU)
        seqs = [["a", "b", "c"] * 10] * 5

        class Boom(Exception):
            pass

        def bad_iter():
            yield from seqs
            raise Boom("producer died")

        sv.build_vocab(seqs)
        with pytest.raises(Boom):
            sv.fit(bad_iter(), total_words=150)
        assert isinstance(sv.syn0, np.ndarray)   # tables back on the host
