"""The ``torch.profiler`` trace behind ``set_tensorboard(profile=True)``.

Counterparts of the 2 cases of ``tests/test_profiler_trace.py``: one
trace a fit, of its first ``profile_steps`` steps, under
``<log_dir>/<app_name>/plugins/profile/<run>/`` beside the scalars, and
none unless asked.  On the card the trace also holds the CUDA activity
(chip_smoke's ``observe`` phase finds the three flash kernels in it).
"""

import glob
import json

import numpy as np


def _model(out):
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    m = Sequential(device="cpu", seed=0)
    m.add(L.Dense(8, activation="relu", input_shape=(4,)))
    m.add(L.Dense(out))
    return m


def test_fit_emits_profiler_trace(tmp_path):
    m = _model(2)
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    m.set_tensorboard(str(tmp_path), "run1", profile=True, profile_steps=2)
    rs = np.random.RandomState(0)
    x = rs.rand(32, 4).astype(np.float32)
    y = rs.randint(0, 2, 32).astype(np.int32)
    plain = _model(2)
    plain.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    want = plain.fit(x, y, batch_size=8, nb_epoch=1)["loss"]
    got = m.fit(x, y, batch_size=8, nb_epoch=1)["loss"]
    assert got == want  # profiling changes no number
    assert glob.glob(str(tmp_path / "run1" / "train" / "events*"))
    traces = glob.glob(str(tmp_path / "run1" / "plugins" / "profile"
                           / "*" / "*.pt.trace.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)
    # the first two of the fit's four steps: 5 matmuls a step (2 Dense
    # forwards, the input gradient of the second, both weight gradients)
    assert sum(1 for e in events if e.get("name") == "aten::mm") == 2 * 5


def test_profile_off_by_default(tmp_path):
    m = _model(4)
    m.compile(optimizer="sgd", loss="mean_squared_error")
    m.set_tensorboard(str(tmp_path), "run2")
    rs = np.random.RandomState(0)
    m.fit(rs.rand(16, 4).astype(np.float32),
          rs.rand(16, 4).astype(np.float32), batch_size=8, nb_epoch=1)
    assert glob.glob(str(tmp_path / "run2" / "train" / "events*"))
    assert not glob.glob(str(tmp_path / "run2" / "plugins" / "profile"
                             / "*"))
