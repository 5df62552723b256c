"""Helpers of the tests that run the port's user programs (the apps and
examples, ``*_torch.py``, and the pages under ``docs/tutorials_torch/``)
on the CPU: load a program by path and run its ``main`` in process, run
a page's script (``chip_smoke.page_script``) in process, run a script on
a gloo pod under the launcher, and give each program a session of its
own."""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from chip_smoke import load_file, page_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_program(rel):
    """The module at ``rel`` (from the repo's root), loaded by path."""
    return load_file(rel, "program_" + os.path.basename(rel)[:-3])


def run_main(rel, *args):
    """``main([*args, "--device", "cpu"])`` of the program at ``rel``, in
    process; returns what it printed."""
    mod = load_program(rel)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main([*args, "--device", "cpu"])
    return out.getvalue()


def run_page(rel, *args):
    """The page's script run in process as ``__main__`` with ``args`` on
    its command line; returns what it printed."""
    script = page_script(rel)
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [rel, *args]
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(script, rel, "exec"), {"__name__": "__main__"})
    finally:
        sys.argv = argv
    return out.getvalue()


def run_pod(script_path, ranks, *args, timeout=240):
    """The script on a ``ranks``-process gloo pod under the launcher, each
    collective bounded by ``--timeout 60`` and the pod by ``timeout``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", str(ranks), str(script_path), *args,
         "--device", "cpu", "--timeout", "60"],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, \
        f"{script_path} failed:\n{proc.stdout[-1500:]}\n{proc.stderr[-1500:]}"
    return proc.stdout


@pytest.fixture(autouse=True)
def fresh_context():
    """Each program starts its own session; the gloo world of one its
    context joined is left after it.  It runs on one CPU thread: the test
    run's workers share the cores, and torch's intra-op threads of
    several workers at once oversubscribe them (a page that trains in 4 s
    alone took minutes)."""
    import analytics_zoo_tpu_torch as zoo
    had_group = torch.distributed.is_initialized()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    zoo.reset_nncontext()
    yield
    zoo.reset_nncontext()
    torch.set_num_threads(threads)
    if not had_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
