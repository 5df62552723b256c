"""The port's model examples (``examples/*/*_torch.py``: LeNet, the
autograd DSL, ONNX, nnframes, the recommenders, text and image
classification, object detection) at their JAX tests' arguments
(``tests/test_examples.py``) where the JAX example has one, else at
small ones, with their contract lines, in process on the CPU
(``--device cpu``)."""

import os
import re

import numpy as np
import pytest

from torch_programs import REPO, fresh_context, run_main  # noqa: F401


def run_example(rel, *args):
    """``main([*args, "--device", "cpu"])`` of the example at
    ``examples/<rel>``, in process; returns what it printed."""
    return run_main(os.path.join("examples", rel), *args)


def test_torch_lenet_train_then_evaluate(tmp_path, monkeypatch):
    import analytics_zoo_tpu_torch as zoo
    ckpt = str(tmp_path / "ckpt")
    out = run_example("lenet/train_lenet_torch.py", "--epochs", "1",
                      "--samples", "64", "--batch-size", "32",
                      "--checkpoint", ckpt)
    assert "context: NNContext(app='train_lenet', platform=cpu" in out
    assert "validation:" in out and f"checkpoints under {ckpt}" in out
    zoo.reset_nncontext()
    # the checkpoint is whole on disk when train returns
    monkeypatch.syspath_prepend(os.path.join(REPO, "examples", "lenet"))
    out = run_example("lenet/evaluate_lenet_torch.py",
                      "--checkpoint", ckpt, "--samples", "64")
    assert "evaluation" in out
    m = re.search(r"'accuracy': ([0-9.]+)", out)
    assert m and 0.0 <= float(m.group(1)) <= 1.0


def test_torch_customloss_example():
    out = run_example("autograd/customloss_torch.py",
                      "--epochs", "2")
    assert "final train MAE" in out


def test_torch_custom_layer_example():
    out = run_example("autograd/custom_torch.py", "--epochs", "2",
                      "--samples", "64")
    pred = re.search(r"pred: \[([^\]]*)\]", out)
    true = re.search(r"true: \[([^\]]*)\]", out)
    assert pred and true, out
    assert len(pred.group(1).split()) == len(true.group(1).split()) == 4


def test_torch_onnx_example(tmp_path):
    out = run_example("onnx/load_onnx_example_torch.py",
                      "--model", str(tmp_path / "m.onnx"))
    assert "row sums" in out and "generated" in out
    sums = re.search(r"row sums: \[([^\]]*)\]", out).group(1).split()
    np.testing.assert_allclose([float(s) for s in sums], 1.0, atol=1e-5)


def test_torch_onnx_example_default_file_is_fresh_and_temporary(
        tmp_path, monkeypatch):
    """Without ``--model`` the example writes its file anew in a
    directory of its own under the temporary root (``TMPDIR``), and
    removes it after the run."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    outs = [run_example("onnx/load_onnx_example_torch.py")
            for _ in range(2)]
    paths = [re.search(r"generated (\S+)", out).group(1) for out in outs]
    assert paths[0] != paths[1]
    for path in paths:
        assert os.path.dirname(os.path.dirname(path)) == str(tmp_path)
        assert not os.path.exists(path)
    assert list(tmp_path.iterdir()) == []


def test_torch_estimator_example():
    out = run_example("nnframes/estimator_example_torch.py",
                      "--epochs", "2")
    acc = float(re.search(r"transform accuracy: ([0-9.]+)", out).group(1))
    assert 0.0 <= acc <= 1.0
    assert "prediction" in out


def test_torch_ncf_example():
    out = run_example("recommendation/ncf_example_torch.py",
                      "--epochs", "2")
    assert "train metrics:" in out
    assert len(re.findall(r"user \d+: item \d+ rating \d", out)) == 6


@pytest.mark.parametrize("model_type", ["wide", "deep", "wide_n_deep"])
def test_torch_wide_and_deep_example(model_type):
    out = run_example("recommendation/wide_and_deep_example_torch.py",
                       "--epochs", "1", "--model-type", model_type)
    assert "train metrics:" in out


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_torch_text_classification_example(encoder):
    out = run_example("textclassification/text_classification_torch.py",
                       "--encoder", encoder, "--epochs", "1",
                      "--samples", "64", "--sequence-length", "20")
    assert "train metrics:" in out


def test_torch_image_classification_example():
    out = run_example("imageclassification/predict_torch.py",
                      "--size", "48", "--top-k", "2")
    rows = re.findall(r"image (\d): \[(.*)\]", out)
    assert [int(i) for i, _ in rows] == list(range(8))
    assert all(r.count("(") == 2 for _, r in rows)


def test_torch_object_detection_example(tmp_path):
    png = tmp_path / "det.png"
    out = run_example("objectdetection/predict_torch.py",
                      "--out", str(png))
    assert re.search(r"image 0: \d+ detections", out)
    assert re.search(r"image 1: \d+ detections", out)
    assert png.exists() and f"wrote {png}" in out
