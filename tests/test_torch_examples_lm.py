"""The port's language-model, serving and pod examples
(``examples/*/*_torch.py``) at their JAX tests' arguments
(``tests/test_examples.py``) and contract lines, in process on the CPU
(``--device cpu``); the pod examples also under the launcher on a
4-rank gloo pod, bounded by a process-group and a subprocess timeout."""

import os
import re

import pytest

from torch_programs import REPO, fresh_context, run_main, run_pod  # noqa: F401


def run_example(rel, *args):
    """``main([*args, "--device", "cpu"])`` of the example at
    ``examples/<rel>``, in process; returns what it printed."""
    return run_main(os.path.join("examples", rel), *args)


def test_torch_transformer_lm_example():
    out = run_example("longcontext/transformer_lm_example_torch.py",
                      "--epochs", "3", "--seq-len", "16")
    assert "transformer lm example done" in out
    assert "next-token accuracy" in out
    acc = float(re.search(r"next-token accuracy: ([0-9.]+)", out).group(1))
    assert acc > 0.5, acc  # the unigram floor is 1/16
    for line in ("greedy continuation:", "top-k sample:",
                 "beam-4 continuation:"):
        assert line in out


def test_torch_char_lm_on_real_source():
    """The text-generation family on the port's own source: short
    training already compresses well below the uniform bits/char, and
    generate() samples through the KV cache."""
    out = run_example("textgeneration/char_lm_source_torch.py",
                      "--epochs", "2", "--limit-seqs", "1024",
                      "--max-new", "60")
    assert "char lm on real source done" in out
    m = re.search(r"bits/char (\d+\.\d+) \(uniform (\d+\.\d+)\)", out)
    assert m, out[-500:]
    bpc, uniform = float(m.group(1)), float(m.group(2))
    assert bpc < uniform - 1.0, (bpc, uniform)
    assert re.search(r"sample:\ndef ", out), out[-300:]


@pytest.mark.parametrize("flag", ["--quantize", "--coalesce"])
def test_torch_serving_example(flag):
    out = run_example("inference/serving_example_torch.py", flag)
    assert "served 8 concurrent requests" in out
    assert "output shape (8, 4)" in out
    assert f"quantized={flag == '--quantize'}" in out


def test_torch_ring_attention_example():
    out = run_example("longcontext/ring_attention_example_torch.py",
                      "--seq-len", "1024")
    assert "ring attention OK: seq 1024 split 1 ways" in out


def test_torch_ring_attention_example_pod():
    out = run_pod(os.path.join(REPO, "examples", "longcontext",
                               "ring_attention_example_torch.py"), 4,
                  "--seq-len", "1024")
    assert "ring attention OK: seq 1024 split 4 ways (256 per device)" in out
    assert out.count("ring attention OK") == 1  # rank 0 reports


def test_torch_spmd_blocks_example():
    out = run_example("parallelism/spmd_blocks_torch.py",
                      "--steps", "10")
    assert "spmd blocks OK" in out
    assert "moe sharded vs single-device" in out


def test_torch_spmd_blocks_example_pod():
    out = run_pod(os.path.join(REPO, "examples", "parallelism",
                               "spmd_blocks_torch.py"), 4, "--steps", "10")
    assert "spmd blocks OK" in out
    assert "moe sharded vs single-device" in out
    assert "(experts sharded over {expert:4})" in out
    assert "(over {pipe:4})" in out
