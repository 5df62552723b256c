"""The port's tutorial pages (``docs/tutorials_torch/*.md``) stay
runnable: every ```python block of a page, concatenated in order, runs
as one script, in process on the CPU (``--device cpu``), and prints the
JAX pages' contract lines (``tests/test_tutorials.py``) with their own
assertions holding (the digits CNN above 0.90, transfer above 0.80, the
LM above 0.8 next-token accuracy, its greedy continuation above 0.9, the
ring within 0.02 of full attention).  The long-context page also runs on
a 4-rank gloo pod under the launcher, its sequence split four ways, with
a process-group and a subprocess timeout.  Its TransformerLM, at the
page's widths, is held to the JAX package's with the same weights:
log-probabilities within 1e-5 of their largest entry (f32), the same
greedy continuation, and the ring layout's forward equal to full
attention's.  Without ``--device`` every page asks for the card and
raises where there is none.
"""

import os
import re

import numpy as np
import pytest
import jax
import torch

from analytics_zoo_tpu.models import TransformerLM as JTransformerLM
from analytics_zoo_tpu_torch.models import TransformerLM, from_jax_params
from chip_smoke import page_script
from torch_programs import REPO, fresh_context, run_page, run_pod  # noqa: F401

PAGES = os.path.join(REPO, "docs", "tutorials_torch")
LONG_CONTEXT = "docs/tutorials_torch/long-context.md"
TOL = 1e-5


def test_torch_tutorial_pages_mirror_the_jax_pages_and_are_linked():
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    pages = sorted(os.listdir(PAGES))
    assert pages == sorted(os.listdir(os.path.join(REPO, "docs",
                                                   "tutorials")))
    for page in pages:
        assert f"docs/tutorials_torch/{page}" in readme, \
            f"{page} not linked from README.md"


@pytest.mark.parametrize("page", sorted(os.listdir(PAGES)))
def test_torch_tutorial_pages_run_on_the_card_by_default(page):
    """Without ``--device`` a page asks for the card, and where there is
    none it raises: it never carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_page(f"docs/tutorials_torch/{page}")


def test_torch_train_your_first_model_tutorial():
    out = run_page("docs/tutorials_torch/train-your-first-model.md",
                   "--device", "cpu")
    assert "reloaded model reproduces predictions" in out
    acc = float(re.search(r"accuracy ([0-9.]+)", out).group(1))
    assert acc > 0.90, out


def test_torch_transfer_learning_tutorial():
    out = run_page("docs/tutorials_torch/transfer-learning.md",
                   "--device", "cpu")
    assert "fine-tuned" in out
    assert "from scratch" in out
    acc = float(re.search(r"fine-tuned: ([0-9.]+)", out).group(1))
    assert acc > 0.80, out


def test_torch_long_context_tutorial():
    out = run_page(LONG_CONTEXT, "--device", "cpu")
    assert "continuation matches the true cycle" in out
    assert "sequence-parallel attention" in out
    assert "1-device mesh" in out


def test_torch_long_context_tutorial_pod(tmp_path):
    script = tmp_path / "long_context.py"
    script.write_text(page_script(LONG_CONTEXT))
    out = run_pod(script, 4)
    # every rank runs the page and checks its own assertions
    assert out.count("continuation matches the true cycle") == 4
    assert out.count("4-device mesh") == 4
    assert out.count("trained one epoch with sequence-parallel "
                     "attention") == 4
    accs = {float(a) for a in re.findall(r"ring-attention accuracy: "
                                         r"([0-9.]+)", out)}
    assert len(accs) == 1, out  # the ranks agree


def test_torch_long_context_model_matches_jax():
    """The page's LM (vocab 16, seq 64, 2 layers, d 64, 4 heads) from the
    JAX model's weights, on the page's cycles."""
    from analytics_zoo_tpu_torch.parallel.mesh import create_mesh
    hyper = dict(vocab_size=16, seq_len=64, n_layers=2, d_model=64,
                 n_heads=4)
    rs = np.random.RandomState(0)
    phase = rs.randint(0, 10, size=(16, 1))
    stride = rs.randint(1, 4, size=(16, 1))
    x = ((phase + stride * np.arange(64)[None, :]) % 10).astype(np.int32)
    jm = JTransformerLM(**hyper)
    weights = jax.device_get(jm.get_weights())
    tm = TransformerLM(**hyper, device="cpu")
    from_jax_params(tm, weights)
    ref = np.asarray(jm.predict(x, batch_size=8))
    out = tm.predict(x, batch_size=8)
    assert out.shape == ref.shape == (16, 64, 16)
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    assert err <= TOL, err
    prompt = x[:4, :8]
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=24, temperature=0.0),
        np.asarray(jm.generate(prompt, max_new_tokens=24, temperature=0.0)))

    ring = TransformerLM(**hyper, implementation="ring", device="cpu")
    ring.compile("adam", "class_nll",
                 mesh=create_mesh({"data": 1, "seq": 1}, device="cpu"))
    ring.transfer_weights_from(tm)
    got = ring.predict(x, batch_size=8)
    assert float(np.abs(got - out).max() / np.abs(out).max()) <= TOL
