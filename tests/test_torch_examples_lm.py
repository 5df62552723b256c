"""The port's language-model, serving and pod examples
(``examples/*/*_torch.py``) at their JAX tests' arguments
(``tests/test_examples.py``) and contract lines, in process on the CPU
(``--device cpu``); the pod examples also under the launcher on a
4-rank gloo pod, bounded by a process-group and a subprocess timeout."""

import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(rel, capsys, *args):
    """``main([*args, "--device", "cpu"])`` of an example, in process;
    returns what it printed."""
    path = os.path.join(REPO, "examples", rel)
    spec = importlib.util.spec_from_file_location(
        "example_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main([*args, "--device", "cpu"])
    return capsys.readouterr().out


@pytest.fixture(autouse=True)
def fresh_context():
    """Each example starts its own session; the gloo world of one its
    context joined is left after it."""
    import analytics_zoo_tpu_torch as zoo
    had_group = torch.distributed.is_initialized()
    zoo.reset_nncontext()
    yield
    zoo.reset_nncontext()
    if not had_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def run_pod(rel, ranks, *args, timeout=240):
    """The example on a ``ranks``-process gloo pod under the launcher."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", str(ranks),
         os.path.join(REPO, "examples", rel), *args, "--device", "cpu",
         "--timeout", "60"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        f"{rel} failed:\n{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}"
    return proc.stdout


def test_torch_transformer_lm_example(capsys):
    out = run_example("longcontext/transformer_lm_example_torch.py", capsys,
                      "--epochs", "3", "--seq-len", "16")
    assert "transformer lm example done" in out
    assert "next-token accuracy" in out
    acc = float(re.search(r"next-token accuracy: ([0-9.]+)", out).group(1))
    assert acc > 0.5, acc  # the unigram floor is 1/16
    for line in ("greedy continuation:", "top-k sample:",
                 "beam-4 continuation:"):
        assert line in out


def test_torch_char_lm_on_real_source(capsys):
    """The text-generation family on the port's own source: short
    training already compresses well below the uniform bits/char, and
    generate() samples through the KV cache."""
    out = run_example("textgeneration/char_lm_source_torch.py", capsys,
                      "--epochs", "2", "--limit-seqs", "1024",
                      "--max-new", "60")
    assert "char lm on real source done" in out
    m = re.search(r"bits/char (\d+\.\d+) \(uniform (\d+\.\d+)\)", out)
    assert m, out[-500:]
    bpc, uniform = float(m.group(1)), float(m.group(2))
    assert bpc < uniform - 1.0, (bpc, uniform)
    assert re.search(r"sample:\ndef ", out), out[-300:]


@pytest.mark.parametrize("flag", ["--quantize", "--coalesce"])
def test_torch_serving_example(capsys, flag):
    out = run_example("inference/serving_example_torch.py", capsys, flag)
    assert "served 8 concurrent requests" in out
    assert "output shape (8, 4)" in out
    assert f"quantized={flag == '--quantize'}" in out


def test_torch_ring_attention_example(capsys):
    out = run_example("longcontext/ring_attention_example_torch.py", capsys,
                      "--seq-len", "1024")
    assert "ring attention OK: seq 1024 split 1 ways" in out


def test_torch_ring_attention_example_pod():
    out = run_pod("longcontext/ring_attention_example_torch.py", 4,
                  "--seq-len", "1024")
    assert "ring attention OK: seq 1024 split 4 ways (256 per device)" in out
    assert out.count("ring attention OK") == 1  # rank 0 reports


def test_torch_spmd_blocks_example(capsys):
    out = run_example("parallelism/spmd_blocks_torch.py", capsys,
                      "--steps", "10")
    assert "spmd blocks OK" in out
    assert "moe sharded vs single-device" in out


def test_torch_spmd_blocks_example_pod():
    out = run_pod("parallelism/spmd_blocks_torch.py", 4, "--steps", "10")
    assert "spmd blocks OK" in out
    assert "moe sharded vs single-device" in out
    assert "(experts sharded over {expert:4})" in out
    assert "(over {pipe:4})" in out
