"""The port's streaming datasets against the JAX package's.

The counterparts of ``tests/test_streaming.py`` run on the port's
``Dataset``/``StreamingDataset`` and ``Trainer``; then two parities: the
port's ``batches()`` equal the JAX package's bit for bit for one factory
and seed (ordered, windowed shuffle, lazy ``map``, ragged tail), and a
2-layer TransformerLM (d 64) fitted from a ``from_batch_iterable``
stream follows the JAX package's fit from the same stream (per-step
losses within 1e-5 relative, f32 on the CPU).
"""

import os
import tracemalloc

import numpy as np
import pytest

from analytics_zoo_tpu_torch.data.dataset import Dataset, StreamingDataset


def _chunks(sizes, dim=4, label=True, log=None):
    rng = np.random.default_rng(0)
    start = 0
    for s in sizes:
        if log is not None:
            log.append(s)
        x = np.arange(start, start + s, dtype=np.float32)[:, None].repeat(
            dim, 1)
        y = rng.integers(0, 3, s).astype(np.int32) if label else None
        start += s
        yield (x, y) if label else x


def test_rebatching_preserves_order_and_sizes():
    ds = Dataset.from_batch_iterable(
        lambda: _chunks([5, 3, 8, 2, 6]), size=24)
    assert isinstance(ds, StreamingDataset)
    batches = list(ds.batches(6, drop_remainder=False))
    assert [len(b[0]) for b in batches] == [6, 6, 6, 6]
    got = np.concatenate([b[0] for b in batches])
    np.testing.assert_array_equal(got[:, 0], np.arange(24, dtype=np.float32))
    ds2 = Dataset.from_batch_iterable(lambda: _chunks([5, 4]), size=9)
    assert [len(b[0]) for b in ds2.batches(4)] == [4, 4]


def test_windowed_shuffle_randomizes_order():
    ds = Dataset.from_batch_iterable(
        lambda: _chunks([7, 9, 8, 6, 10, 8]), size=48, shuffle_buffer=16)
    ordered = np.concatenate(
        [b[0][:, 0] for b in ds.batches(8, shuffle=False)])
    shuf1 = np.concatenate(
        [b[0][:, 0] for b in ds.batches(8, shuffle=True, seed=1, epoch=0)])
    shuf1b = np.concatenate(
        [b[0][:, 0] for b in ds.batches(8, shuffle=True, seed=1, epoch=0)])
    shuf2 = np.concatenate(
        [b[0][:, 0] for b in ds.batches(8, shuffle=True, seed=1, epoch=1)])
    assert not np.array_equal(shuf1, ordered)
    np.testing.assert_array_equal(shuf1, shuf1b)
    assert not np.array_equal(shuf1, shuf2)
    np.testing.assert_array_equal(np.sort(shuf1), np.sort(ordered))
    xs, ys = zip(*ds.batches(8, shuffle=True, seed=3, epoch=0))
    x_all = np.concatenate([x[:, 0] for x in xs]).astype(int)
    y_all = np.concatenate(ys)
    _, y_ref = zip(*ds.batches(8, shuffle=False))
    np.testing.assert_array_equal(y_all, np.concatenate(y_ref)[x_all])


def test_windowed_shuffle_bounded_window():
    n, window = 4000, 256
    ds = Dataset.from_batch_iterable(
        lambda: _chunks([40] * 100), size=n, shuffle_buffer=window)
    out = np.concatenate(
        [b[0][:, 0] for b in ds.batches(32, shuffle=True, seed=0)])
    displacement = np.abs(out - np.arange(len(out)))
    assert displacement.max() <= 2 * window + 80, displacement.max()
    assert (displacement > 0).mean() > 0.9


def test_shuffle_buffer_none_replays_source_order():
    ds = Dataset.from_batch_iterable(
        lambda: _chunks([8, 8, 8]), size=24, shuffle_buffer=None)
    a = np.concatenate([b[0][:, 0] for b in ds.batches(8, shuffle=True)])
    np.testing.assert_array_equal(a, np.arange(24, dtype=np.float32))


def test_stream_is_pulled_lazily():
    log = []
    ds = Dataset.from_batch_iterable(
        lambda: _chunks([8] * 100, log=log), size=800)
    it = ds.batches(16)
    next(it), next(it)
    assert len(log) <= 5, log


def test_streaming_memory_bounded():
    chunk = 64 * 32 * 32 * 3 * 4

    def make():
        rng = np.random.default_rng(0)
        for _ in range(60):
            yield (rng.normal(size=(64, 32, 32, 3)).astype(np.float32),
                   rng.integers(0, 4, 64).astype(np.int32))

    ds = Dataset.from_batch_iterable(make, size=60 * 64)
    tracemalloc.start()
    tracemalloc.reset_peak()
    n = sum(len(b[0]) for b in ds.batches(128, drop_remainder=False))
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert n == 3840
    if peak < chunk:  # numpy allocations not traced in this build
        pytest.skip("tracemalloc does not see numpy buffers here")
    assert peak < 12 * chunk, f"peak {peak / 1e6:.1f}MB for a streamed pass"


def test_streaming_lazy_map():
    ds = Dataset.from_batch_iterable(lambda: _chunks([4, 4]), size=8)
    doubled = ds.map(lambda b: (b[0] * 2, b[1]), batched=True)
    got = np.concatenate([b[0] for b in doubled.batches(4)])
    np.testing.assert_array_equal(got[:, 0], np.arange(8) * 2.0)
    per_sample = ds.map(lambda s: (s[0] + 1.0, s[1]), batched=False)
    got2 = np.concatenate([b[0] for b in per_sample.batches(4)])
    np.testing.assert_array_equal(got2[:, 0], np.arange(8) + 1.0)


def _write_image_folder(root, n_per_class=12, size=(10, 10)):
    from PIL import Image
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 255, size + (3,)).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.png"))


def test_image_loader_uint8_defers_normalization(tmp_path):
    from analytics_zoo_tpu_torch.data.image_loader import ImageLoader
    _write_image_folder(str(tmp_path), n_per_class=4)
    loader = ImageLoader.from_folder(str(tmp_path), batch_size=4,
                                     size=(10, 10), out_dtype="uint8")
    x, y = next(iter(loader))
    assert x.dtype == np.uint8 and x.shape == (4, 10, 10, 3)
    assert x.max() > 1
    f32 = ImageLoader.from_folder(str(tmp_path), batch_size=4,
                                  size=(10, 10), scale=1 / 255.0)
    x2, _ = next(iter(f32))
    np.testing.assert_allclose(x.astype(np.float32) / 255.0, x2,
                               atol=1e-6)
    with pytest.raises(ValueError):
        ImageLoader([], out_dtype="float16")


def test_fit_streams_from_image_folder(tmp_path):
    """ImageLoader folder -> Dataset.from_loader -> Trainer.fit, nothing
    materialized; evaluate and predict read the stream too."""
    from analytics_zoo_tpu_torch.data.image_loader import ImageLoader
    from analytics_zoo_tpu_torch.pipeline.api.keras import (
        Sequential, objectives, optimizers)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D, Dense, Flatten)
    from analytics_zoo_tpu_torch.pipeline.api.keras.metrics import Accuracy
    from analytics_zoo_tpu_torch.train import triggers
    from analytics_zoo_tpu_torch.train.trainer import Trainer

    _write_image_folder(str(tmp_path))
    loader = ImageLoader.from_folder(
        str(tmp_path), batch_size=6, size=(10, 10), scale=1 / 255.0)
    ds = Dataset.from_loader(loader)
    assert ds.size == 24
    assert ds.steps_per_epoch(8) == 3
    m = Sequential(device="cpu")
    m.add(Convolution2D(4, 3, 3, input_shape=(10, 10, 3),
                        activation="relu"))
    m.add(Flatten())
    m.add(Dense(2))
    trainer = Trainer(m, objectives.get("sparse_categorical_crossentropy"),
                      optimizers.get({"name": "sgd", "lr": 0.01}),
                      metrics=[Accuracy()])
    hist = trainer.fit(ds, batch_size=8, end_trigger=triggers.MaxEpoch(2))
    assert len(hist["loss"]) == 6
    assert np.isfinite(hist["loss"]).all()
    res = trainer.evaluate(ds, batch_size=8)
    assert "accuracy" in res and np.isfinite(res["loss"])
    assert trainer.predict(ds, batch_size=8).shape == (24, 2)


# ---- the port against the JAX package --------------------------------------

def _ragged(n, seed=0):
    """A factory of (x, y) chunks of ragged sizes 1-6 over n rows."""
    def make():
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        y = rng.integers(0, 5, n).astype(np.int32)
        start = 0
        while start < n:
            size = int(rng.integers(1, 7))
            yield x[start:start + size], y[start:start + size]
            start += size
    return make


@pytest.mark.parametrize("case", ["ordered", "shuffled", "map", "tail",
                                  "map_batched_shuffled"])
def test_batches_equal_jax_bit_for_bit(case):
    """Same factory, same seed: the same batches in the same order."""
    from analytics_zoo_tpu.data.dataset import Dataset as JDataset
    make = _ragged(157)
    ours = Dataset.from_batch_iterable(make, shuffle_buffer=40)
    ref = JDataset.from_batch_iterable(make, shuffle_buffer=40)
    kw = dict(shuffle=case in ("shuffled", "map_batched_shuffled"),
              seed=7, epoch=2, drop_remainder=case != "tail")
    if case == "map":
        ours = ours.map(lambda s: (s[0] * 3.0, s[1] + 1))
        ref = ref.map(lambda s: (s[0] * 3.0, s[1] + 1))
    if case == "map_batched_shuffled":
        ours = ours.map(lambda b: (b[0] - 1.0, b[1]), batched=True)
        ref = ref.map(lambda b: (b[0] - 1.0, b[1]), batched=True)
    got = list(ours.batches(16, **kw))
    want = list(ref.batches(16, **kw))
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert ours.size == ref.size == 157  # learned after the pass
    assert ours.steps_per_epoch(16) == ref.steps_per_epoch(16) == 9


def test_stream_surface_matches_jax():
    """Every public name of the JAX module, the size/steps errors and the
    shard_by_process refusal."""
    import analytics_zoo_tpu.data.dataset as jd
    import analytics_zoo_tpu_torch.data.dataset as td
    public = {n for n in dir(jd) if not n.startswith("_")
              and getattr(getattr(jd, n), "__module__", "") == jd.__name__}
    assert public <= set(dir(td)), public - set(dir(td))
    ds = Dataset.from_batch_iterable(_ragged(20))
    assert ds.size is None
    with pytest.raises(ValueError, match="unknown stream length"):
        ds.steps_per_epoch(4)
    assert Dataset.from_batch_iterable(
        _ragged(20), steps_per_epoch=3).steps_per_epoch(4) == 3
    with pytest.raises(NotImplementedError, match="at the source"):
        ds.shard_by_process(0, 2)
    pairs = [(np.full(2, i, np.float32), i) for i in range(5)]
    a, b = Dataset.from_iterable(pairs), jd.Dataset.from_rdd(pairs)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    mapped = a.map(lambda s: (s[0] + 1, s[1] * 2), batched=True,
                   batch_size=2)
    np.testing.assert_array_equal(mapped.y, np.arange(5) * 2)


def test_no_shuffle_warning_once(monkeypatch):
    from analytics_zoo_tpu_torch.observability import log as log_lib
    seen = []
    monkeypatch.setattr(StreamingDataset, "_warned_no_shuffle", False)
    monkeypatch.setattr(log_lib.StructuredLogger, "warning",
                        lambda self, msg, **kw: seen.append(msg))
    ds = Dataset.from_batch_iterable(lambda: _chunks([8, 8]), size=16,
                                     shuffle_buffer=None)
    for _ in range(2):
        list(ds.batches(8, shuffle=True))
    assert len(seen) == 1 and "replays the source order" in seen[0]


LM = dict(vocab_size=16, seq_len=16, n_layers=2, d_model=64, n_heads=2)


def _periodic_factory(n=48, vocab=16, seq=16, seed=0, chunk=3):
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 4, n)
    start = rng.integers(0, vocab, n)
    toks = (start[:, None] + steps[:, None]
            * np.arange(seq + 1)[None, :]) % vocab
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def make():
        for i in range(0, n, chunk):
            yield x[i:i + chunk], y[i:i + chunk]
    return make


def test_transformer_lm_fit_from_stream_follows_jax():
    """A 2-layer TransformerLM (d 64) fitted for two epochs from a
    ``from_batch_iterable`` stream (ragged chunks of 3, a windowed
    shuffle of 16 rows) follows the JAX package's fit from the same
    stream: per-step losses within 1e-5 relative."""
    from analytics_zoo_tpu.data.dataset import Dataset as JDataset
    from analytics_zoo_tpu.models import TransformerLM as JaxLM
    from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
    make = _periodic_factory()
    jm = JaxLM(**LM)
    jm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll")
    tm = TransformerLM(**LM, device="cpu")
    from_jax_params(tm, jm.get_weights())
    tm.compile(optimizer={"name": "adam", "lr": 3e-3}, loss="class_nll")
    ref = jm.fit(JDataset.from_batch_iterable(make, shuffle_buffer=16),
                 batch_size=8, nb_epoch=2)
    out = tm.fit(Dataset.from_batch_iterable(make, shuffle_buffer=16),
                 batch_size=8, nb_epoch=2)
    assert len(out["loss"]) == len(ref["loss"]) == 12
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5, atol=0)
    assert out["loss"][-1] < out["loss"][0]
