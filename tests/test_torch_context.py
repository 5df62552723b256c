"""The port's session context (``analytics_zoo_tpu_torch.common.context``)
held against the JAX package's in the same process: the config's
fields and defaults, getOrCreate, a bare string as the app name, reset,
``repr`` and the axis sizes of the same ``mesh_axes`` over the same
device count (the port's side an 8-rank gloo pod under the launcher, the
JAX side its 8 virtual CPU devices).  A ``fit`` computes the same bits
with and without a context made first, the top-level exports import
cheaply, the shell binds the session as ``ctx``, and the public
initializers ``zero``/``one`` equal the JAX package's."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import analytics_zoo_tpu as jzoo
import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu_torch.common import context as tctx
from chip_smoke import CONTEXT_KINDS, context_fit_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the mesh_axes the pod and the JAX package both build, over 8 devices
MESH_AXES = [None, {"data": 2, "tensor": -1}, {"seq": 8},
             {"fsdp": 2, "expert": 2, "pipe": 2}]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("ZOO_TPU_", "ZOO_RESUME", "ZOO_FAULT_"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture
def fresh():
    """No context before or after the test; a process group the test's
    context joined (a gloo world of one) is left again."""
    had_group = torch.distributed.is_initialized()
    tzoo.reset_nncontext()
    jzoo.reset_nncontext()
    yield
    tzoo.reset_nncontext()
    jzoo.reset_nncontext()
    if not had_group and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_config_fields_and_defaults_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tctx.ZooTpuConfig) == fields(jctx.ZooTpuConfig)


def test_top_level_exports_match_jax_and_import_lazily():
    code = textwrap.dedent("""
        import sys
        import analytics_zoo_tpu_torch as zoo
        before = sorted(m for m in sys.modules
                        if m.startswith("analytics_zoo_tpu_torch."))
        from analytics_zoo_tpu_torch import (init_nncontext, NNContext,
            ZooTpuConfig, Input, Variable, GraphModule, Layer, Dataset,
            initNNContext, get_nncontext, reset_nncontext)
        from analytics_zoo_tpu_torch.core.graph import Input as I
        assert Input is I and initNNContext is init_nncontext
        print("MODULES", ",".join(before))
        print("KERNELS", "analytics_zoo_tpu_torch.ops._kernels"
              in sys.modules)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-800:]
    modules = proc.stdout.split("MODULES ")[1].split()[0].split(",")
    # the context alone at import: no graph, data, kernels or CUDA
    assert modules == ["analytics_zoo_tpu_torch.common",
                       "analytics_zoo_tpu_torch.common.context"]
    assert "KERNELS False" in proc.stdout
    jnames = {"NNContext", "ZooTpuConfig", "init_nncontext",
              "initNNContext", "get_nncontext", "reset_nncontext", "Input",
              "Variable", "GraphModule", "Layer", "Dataset"}
    assert jnames <= set(dir(jzoo)) and jnames <= set(tzoo.__all__)
    from analytics_zoo_tpu_torch import common
    assert {"check_version"} | (jnames - {"Input", "Variable",
                                          "GraphModule", "Layer",
                                          "Dataset"}) <= set(dir(common))


def test_no_device_raises_without_a_card(fresh):
    if torch.cuda.is_available():
        pytest.skip("a card is present: init_nncontext() takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init_nncontext("no card")
    assert tzoo.get_nncontext() is None


def test_get_or_create_name_and_reset_match_jax(fresh):
    jc = jzoo.init_nncontext("Session App")
    tc = tzoo.init_nncontext("Session App", device="cpu")
    assert tc.app_name == jc.app_name == "Session App"
    assert tc.conf.app_name == jc.conf.app_name
    # getOrCreate: a second call, whatever it passes, is the same context
    assert jzoo.init_nncontext("other") is jc
    assert tzoo.init_nncontext("other", device="cpu") is tc
    assert tzoo.initNNContext() is tc and tzoo.get_nncontext() is tc
    assert tc.device == torch.device("cpu")
    assert (tc.device_count, tc.devices) == (1, [torch.device("cpu")])
    assert repr(tc) == "NNContext(app='Session App', platform=cpu, " \
                       "mesh={'data': 1})"
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    assert mesh_lib.get_default_mesh() is tc.mesh
    assert mesh_lib.get_active_mesh() is tc.mesh
    # a config and an app name together: the name wins, as in JAX
    tzoo.reset_nncontext()
    jzoo.reset_nncontext()
    assert tzoo.get_nncontext() is None and jzoo.get_nncontext() is None
    assert mesh_lib.get_active_mesh() is None
    conf = tzoo.ZooTpuConfig(log_level="WARNING", version_check=True)
    tc2 = tzoo.init_nncontext(conf, app_name="named", device="cpu")
    jc2 = jzoo.init_nncontext(jzoo.ZooTpuConfig(log_level="WARNING"),
                              app_name="named")
    assert tc2 is not tc and tc2.conf is conf
    assert tc2.app_name == jc2.app_name == "named"
    assert tctx.check_version() == jctx.check_version() == "0.1.0"


POD = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from analytics_zoo_tpu_torch.parallel import distributed
    import analytics_zoo_tpu_torch as zoo
    distributed.maybe_initialize_distributed("cpu", timeout_s=60)
    out = []
    for axes in json.loads(sys.argv[2]):
        ctx = zoo.init_nncontext(zoo.ZooTpuConfig(mesh_axes=axes),
                                 app_name="pod", device="cpu")
        assert zoo.init_nncontext("again", device="cpu") is ctx
        from analytics_zoo_tpu_torch.parallel.mesh import axis_sizes
        out.append(dict(repr=repr(ctx), sizes=ctx.axis_sizes(),
                        all_sizes=axis_sizes(ctx.mesh),
                        count=ctx.device_count,
                        devices=[str(d) for d in ctx.devices]))
        zoo.reset_nncontext()
    if distributed.process_index() == 0:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
""")


def test_pod_axis_sizes_and_repr_match_jax(fresh, tmp_path):
    script = tmp_path / "pod.py"
    script.write_text(POD)
    out = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.launcher",
         "--num-processes", "8", str(script), str(out),
         json.dumps(MESH_AXES)],
        capture_output=True, text=True, timeout=150, env=_env(), cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-800:], proc.stderr[-1500:])
    got = json.loads(out.read_text())
    import jax
    assert len(jax.devices()) == 8
    for axes, pod in zip(MESH_AXES, got):
        jzoo.reset_nncontext()
        jc = jzoo.init_nncontext(jzoo.ZooTpuConfig(mesh_axes=axes),
                                 app_name="pod")
        assert pod["sizes"] == dict(jc.mesh.shape), axes
        assert pod["repr"] == repr(jc), axes
        assert pod["count"] == jc.device_count == 8
        assert pod["devices"] == ["cpu"] * 8
        # the port's mesh names the other axes at size 1
        assert set(pod["all_sizes"]) == {"data", "fsdp", "tensor", "seq",
                                         "expert", "pipe"}
        assert all(v == 1 for k, v in pod["all_sizes"].items()
                   if k not in pod["sizes"])


@pytest.mark.parametrize("kind", CONTEXT_KINDS)
def test_fit_same_bits_with_and_without_context(fresh, kind):
    plain, plain_mesh = context_fit_weights(kind, "cpu")
    tzoo.init_nncontext("bits", device="cpu")
    assert torch.distributed.is_initialized()
    under, under_mesh = context_fit_weights(kind, "cpu")
    assert not plain_mesh and not under_mesh  # one process: no mesh
    assert len(plain) == len(under)
    for a, b in zip(plain, under):
        assert torch.equal(a, b)


def test_shell_binds_ctx_with_app_name():
    code = (
        "import sys, io\n"
        "import unittest.mock as mock\n"
        "with mock.patch.dict(sys.modules, {'IPython': None}):\n"
        "    sys.stdin = io.StringIO('print(\"CTX\", ctx.app_name, "
        "ctx.device.type, ctx is zoo.get_nncontext())\\n')\n"
        "    from analytics_zoo_tpu_torch.launcher import shell_main\n"
        "    sys.exit(shell_main(['--device', 'cpu', '--app-name', "
        "'my-shell']))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "CTX my-shell cpu True" in proc.stdout
    assert "bound: zoo, ctx, torch, np, device" in proc.stdout


@pytest.mark.parametrize("name", ["zero", "one"])
def test_public_zero_and_one_equal_jax(name):
    import jax
    from analytics_zoo_tpu.core import initializers as jinit
    from analytics_zoo_tpu_torch.core import initializers as tinit
    shape = (3, 5)
    want = np.asarray(getattr(jinit, name)(jax.random.PRNGKey(0), shape))
    got = getattr(tinit, name)(shape, torch.Generator("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tinit.get(name) is getattr(tinit, name)
