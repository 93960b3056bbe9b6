"""The rest of the port's data plane (`deeplearning4j_tpu_torch/datasets/
{dataset,records,parallel,fetchers}.py`, `AsyncDataSetIterator`) against
the JAX package's on the same files and seeds: the readers', the
parallel iterators' and the fetchers' arrays are equal; the
`DevicePrefetchIterator` path of `fit` trains bit-equal to the plain
iterator and checks token ids on the host before any copy."""

import torch_port_threads  # noqa: F401  (caps torch's threads under xdist)

import gzip
import struct

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets.dataset as jds
import deeplearning4j_tpu.datasets.fetchers as jfetch
import deeplearning4j_tpu.datasets.iterator as jit
import deeplearning4j_tpu.datasets.parallel as jpar
import deeplearning4j_tpu.datasets.records as jrec
import deeplearning4j_tpu_torch.datasets.fetchers as pfetch
import deeplearning4j_tpu_torch.datasets.parallel as ppar
import deeplearning4j_tpu_torch.datasets.records as prec
from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.datasets import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
    DataSet,
    DevicePrefetchIterator,
)
from deeplearning4j_tpu_torch.datasets.iterator import DataSet as ReExported
from deeplearning4j_tpu_torch.monitor.registry import MetricsRegistry
from deeplearning4j_tpu_torch.zoo.transformer import TransformerLM


def _same(port_batches, jax_batches):
    port_batches, jax_batches = list(port_batches), list(jax_batches)
    assert len(port_batches) == len(jax_batches)
    for a, b in zip(port_batches, jax_batches):
        if a is None or b is None:
            assert a is None and b is None
            continue
        for f in ("features", "labels", "features_mask", "labels_mask"):
            u, v = getattr(a, f), getattr(b, f)
            assert (u is None) == (v is None), f
            if u is not None:
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                              err_msg=f)


def _arrays(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
            (rng.random((n, 4)) < 0.5).astype(np.float32))


def test_dataset_methods_match_jax():
    x, y, m = _arrays()
    md = [f"r{i}" for i in range(10)]
    p = DataSet(x.copy(), y.copy(), labels_mask=m.copy(),
                example_metadata=list(md))
    j = jds.DataSet(x.copy(), y.copy(), labels_mask=m.copy(),
                    example_metadata=list(md))
    assert ReExported is DataSet
    _same(p.split_test_and_train(6), j.split_test_and_train(6))
    assert p.split_test_and_train(6)[1].example_metadata == md[6:]
    _same(p.batch_by(4), j.batch_by(4))
    p.shuffle(3)
    j.shuffle(3)
    _same([p], [j])
    assert p.example_metadata == j.example_metadata
    _same([DataSet.merge([p, p])], [jds.DataSet.merge([j, j])])


def _csv(tmp_path, name, rows):
    path = tmp_path / name
    path.write_text("\n".join(",".join(str(v) for v in r) for r in rows))
    return path


@pytest.mark.parametrize("mode", ["classification", "regression",
                                  "features_only"])
def test_record_reader_iterator_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(1)
    rows = [["h1", "h2", "h3", "h4"]] + [
        [*np.round(rng.standard_normal(3), 4), int(rng.integers(0, 3))]
        for _ in range(11)]
    path = _csv(tmp_path, "d.csv", rows)
    kw = {"classification": dict(label_index=3, num_classes=3),
          "regression": dict(label_index=-1, regression=True),
          "features_only": {}}[mode]
    port = prec.RecordReaderDataSetIterator(
        prec.CSVRecordReader(path, skip_lines=1), 4, **kw)
    jax_ = jrec.RecordReaderDataSetIterator(
        jrec.CSVRecordReader(path, skip_lines=1), 4, **kw)
    _same(port, jax_)
    _same(port, jax_)       # a second pass resets the reader


def test_sequence_reader_iterator_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for i, T in enumerate((3, 5, 2, 7, 4)):
        rows = [[*np.round(rng.standard_normal(2), 3),
                 int(rng.integers(0, 3))] for _ in range(T)]
        paths.append(_csv(tmp_path, f"s{i}.csv", rows))
    for kw in (dict(num_classes=3), dict(bucket_boundaries=[4, 6],
                                         num_classes=3)):
        port = prec.SequenceRecordReaderDataSetIterator(
            prec.CSVSequenceRecordReader(paths), None, 2, **kw)
        jax_ = jrec.SequenceRecordReaderDataSetIterator(
            jrec.CSVSequenceRecordReader(paths), None, 2, **kw)
        _same(port, jax_)
        assert port.truncated_count == jax_.truncated_count


def test_image_record_reader_matches_jax(tmp_path):
    """Pixels and labels from the directory names (PIL, imported only
    when the first image is read)."""
    from PIL import Image
    rng = np.random.default_rng(4)
    paths = []
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            p = tmp_path / cls / f"{i}.png"
            Image.fromarray(rng.integers(0, 255, (6, 5, 3), np.uint8)).save(p)
            paths.append(p)
    port = prec.RecordReaderDataSetIterator(
        prec.ImageRecordReader(4, 4, 3, paths), 3, label_index=-1,
        num_classes=2)
    jax_ = jrec.RecordReaderDataSetIterator(
        jrec.ImageRecordReader(4, 4, 3, paths), 3, label_index=-1,
        num_classes=2)
    _same(port, jax_)


def _producers(pkg_it, sizes):
    return [pkg_it.ArrayDataSetIterator(*_arrays(n, seed=i)[:2],
                                        batch_size=2)
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("mode", ["stop_everyone", "relocate", "reset",
                                  "pass_null"])
def test_joint_parallel_iterator_matches_jax(mode):
    import deeplearning4j_tpu_torch.datasets.iterator as pit
    port = ppar.JointParallelDataSetIterator(_producers(pit, (6, 2, 4)),
                                             mode, prefetch=2)
    jax_ = jpar.JointParallelDataSetIterator(_producers(jit, (6, 2, 4)),
                                             mode, prefetch=2)
    _same(port, jax_)


def test_file_split_parallel_iterator_matches_jax(tmp_path):
    for i in range(5):
        np.save(tmp_path / f"part{i}.npy", _arrays(4, seed=i)[0])

    def load(pkg):
        return lambda p: pkg.DataSet(np.load(p))
    port = ppar.FileSplitParallelDataSetIterator(str(tmp_path), "*.npy",
                                                 load(ppar), num_producers=2)
    jax_ = jpar.FileSplitParallelDataSetIterator(str(tmp_path), "*.npy",
                                                 load(jds),
                                                 num_producers=2)
    assert port.paths == jax_.paths
    _same(port, jax_)


def test_async_iterator_order_cursor_and_early_stop():
    x, y, _ = _arrays(10)
    base = ArrayDataSetIterator(x, y, batch_size=3, shuffle=True, seed=5)
    ref = [ds.features for ds in ArrayDataSetIterator(x, y, batch_size=3,
                                                      shuffle=True, seed=5)]
    it = AsyncDataSetIterator(base, prefetch=2)
    got = []
    for ds in it:
        got.append(ds.features)
        if len(got) == 2:
            assert it.cursor()["batch"] == 2
            break
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)

    class Broken(ArrayDataSetIterator):
        def __iter__(self):
            yield from list(super().__iter__())[:1]
            raise RuntimeError("disk gone")
    with pytest.raises(RuntimeError, match="disk gone"):
        list(AsyncDataSetIterator(Broken(x, y, batch_size=3)))


LM = dict(vocab_size=32, d_model=32, n_layers=2, n_heads=2, max_len=16)


def _lm_windows(n, seed=3):
    seq = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                               (n, LM["max_len"]))
    return (seq[:, :-1].astype(np.float32),
            np.eye(LM["vocab_size"], dtype=np.float32)[seq[:, 1:]])


def test_prefetch_fit_is_bit_equal_and_checks_ids_on_the_host():
    x, y = _lm_windows(8)
    plain = TransformerLM(**LM).init(device="cpu")
    plain.fit(ArrayDataSetIterator(x, y, batch_size=2), epochs=2)
    net = TransformerLM(**LM).init(device="cpu")
    pre = DevicePrefetchIterator(ArrayDataSetIterator(x, y, batch_size=2),
                                 depth=2, device="cpu")
    losses = []
    net.add_listener(type("L", (), dict(
        iteration_done=lambda s, m, i, e, score, **k: losses.append(score),
        **{n: lambda *a, **k: None for n in (
            "on_epoch_start", "on_epoch_end", "on_fit_start",
            "on_fit_end")}))())
    net.fit(pre, epochs=2)
    assert len(losses) == 8
    for (k, a), (_, b) in zip(plain.param_table().items(),
                              net.param_table().items()):
        assert torch.equal(a, b), k
    # the bound iterator hands over the net's host conversion: int64 ids
    ds = next(iter(pre))
    assert ds.features.dtype == torch.int64
    bad = x.copy()
    bad[1, 3] = LM["vocab_size"]
    with pytest.raises(ValueError, match="token ids must be in"):
        net.fit(DevicePrefetchIterator(ArrayDataSetIterator(bad, y,
                                                            batch_size=2),
                                       device="cpu"))
    # sharding= (a mesh's data axis) lands each replica's row block on
    # its device, converted as the net converts
    from deeplearning4j_tpu_torch.parallel import MeshSpec, make_mesh
    from deeplearning4j_tpu_torch.parallel.placement import ReplicaBatch
    sh = DevicePrefetchIterator(ArrayDataSetIterator(x, y, batch_size=4),
                                sharding=make_mesh(MeshSpec.of(data=2),
                                                   devices=["cpu"] * 2))
    sh.bind_model(net)
    ds = next(iter(sh))
    assert isinstance(ds.features, ReplicaBatch)
    assert ds.num_examples() == 4
    assert [tuple(t.shape) for t in ds.features.shards] == [(2, 15)] * 2
    assert ds.features.shards[0].dtype == torch.int64
    assert torch.equal(torch.cat(ds.labels.shards),
                       torch.as_tensor(y[:4]))


def _idx_gz(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_fetchers_match_jax_surrogates_and_read_the_cache(tmp_path,
                                                          monkeypatch):
    # the JAX fetcher downloads when its cache is empty: it must never
    # reach the network from a test, and both read an empty cache here
    monkeypatch.setattr(jfetch, "_try_download", lambda url, dest: False)
    monkeypatch.setattr(jfetch, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(pfetch, "CACHE_DIR", tmp_path)
    for (a, b) in ((pfetch.load_mnist(True, 64), jfetch.load_mnist(True, 64)),
                   (pfetch.load_emnist("letters", False, 32),
                    jfetch.load_emnist("letters", False, 32)),
                   (pfetch.load_cifar10(True, 8), jfetch.load_cifar10(True, 8)),
                   (pfetch.load_lfw(8, image_size=16),
                    jfetch.load_lfw(8, image_size=16))):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        assert a[-1] is True
    for u, v in zip(pfetch.load_iris(), jfetch.load_iris()):
        np.testing.assert_array_equal(u, v)
    it = pfetch.MnistDataSetIterator(16, num_examples=32, flatten=False)
    assert it.is_synthetic and next(iter(it)).features.shape == (16, 28,
                                                                  28, 1)
    # a cached copy is read first, in both packages
    rng = np.random.default_rng(6)
    (tmp_path / "mnist").mkdir()
    _idx_gz(tmp_path / "mnist" / "test_images.gz",
            rng.integers(0, 255, (5, 28, 28)))
    _idx_gz(tmp_path / "mnist" / "test_labels.gz", rng.integers(0, 10, 5))
    a, b = pfetch.load_mnist(False), jfetch.load_mnist(False)
    assert a[2] is False and b[2] is False
    for u, v in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(u, v)


def test_prefetch_counts_its_copies_only_on_a_card():
    """On the CPU the prefetcher converts and hands over without a copy,
    so no h2d transfer is counted."""
    reg = MetricsRegistry()
    monitor.enable(registry=reg)
    try:
        x, y = _lm_windows(4)
        list(DevicePrefetchIterator(ArrayDataSetIterator(x, y, batch_size=2),
                                    device="cpu"))
        assert reg.counter("jax_transfers_total", direction="h2d").value == 0
    finally:
        monitor.disable()
