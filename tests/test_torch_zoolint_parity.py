"""The port's zoolint held against the JAX package's on the CPU.

* **Kept rules.**  For every code the port keeps (ZL401, ZL501, ZL502,
  ZL601, ZL701, ZL702, ZL721, ZL731 and the ZL8xx family) the two
  linters give equal (code, line, symbol) triples over the JAX
  package's own fixtures (``tests/zoolint_fixtures/``, read and never
  edited), file by file and over the whole directory at once (the
  project-wide passes).  ZL402 is re-aimed — its blocking calls are
  torch's — so it is compared too, with its one named difference.
* **Contracts.**  The port's ``ContractIndex`` over
  ``analytics_zoo_tpu_torch`` against the JAX package's committed
  ``contracts_snapshot.json``: wire ops, error codes, env-var names and
  metric families equal, every difference listed below by name with
  its reason.

Both linters are stdlib AST, so this imports no jax.
"""

import glob
import json
import os

import pytest

from analytics_zoo_tpu.tools.zoolint import lint_paths as jax_lint
from analytics_zoo_tpu_torch.tools.zoolint import FATES
from analytics_zoo_tpu_torch.tools.zoolint import lint_paths as port_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(REPO, "tests", "zoolint_fixtures")
FILES = sorted(os.path.basename(p) for p in
               glob.glob(os.path.join(JAX_FIXTURES, "zl*.py")))
KEPT = tuple(sorted(c for c, (fate, _) in FATES.items()
                    if fate == "kept"))
COMPARED = KEPT + ("ZL402",)
#: (file, code, line, symbol) findings only one linter gives, and why
DIFFERENCES = {
    # jax.block_until_ready under a lock: ZL402 names torch's blocking
    # calls in the port (synchronize/.item()/.tolist()/.cpu()), and the
    # port's own zl402_pos.py holds the torch shape
    ("zl402_pos.py", "ZL402", 15, "Server.refresh"): "jax",
}


def _triples(findings, codes):
    return sorted((f.code, f.line, f.symbol) for f in findings
                  if f.code in codes)


def test_kept_codes_match_the_catalog_fates():
    assert set(KEPT) == {"ZL401", "ZL501", "ZL502", "ZL601", "ZL701",
                         "ZL702", "ZL721", "ZL731", "ZL801", "ZL802",
                         "ZL811", "ZL812", "ZL821"}


@pytest.mark.parametrize("name", FILES)
def test_kept_rules_agree_on_jax_fixture(name):
    path = os.path.join(JAX_FIXTURES, name)
    jax = _triples(jax_lint([path], root=REPO), COMPARED)
    port = _triples(port_lint([path], root=REPO), COMPARED)
    only = {(name,) + t: "jax" for t in set(jax) - set(port)}
    only.update({(name,) + t: "port" for t in set(port) - set(jax)})
    expected = {k: v for k, v in DIFFERENCES.items() if k[0] == name}
    assert only == expected
    # a fixture of a kept code is not vacuous: its positive fires
    code = name[:5].upper()
    if code in KEPT and name.endswith("_pos.py"):
        assert any(t[0] == code for t in port)


def test_kept_rules_agree_over_the_whole_fixture_tree():
    jax = _triples(jax_lint([JAX_FIXTURES], root=REPO), COMPARED)
    port = _triples(port_lint([JAX_FIXTURES], root=REPO), COMPARED)
    diff = set(jax) ^ set(port)
    assert diff == {(c, line, s) for (_, c, line, s) in DIFFERENCES}


# ------------------------------------------------------------ contracts
#: differences between the port's index and contracts_snapshot.json
METRICS_ONLY_JAX = {
    # jax's other monitoring events by key; torch has no such stream
    # (docs/dev/zoolint_torch.md, "Families the port does not emit")
    "zoo_xla_events_total",
}
ENV_DESCRIPTIONS_DIFFER = {
    # the launcher's process-group variables join torch.distributed
    "ZOO_TPU_COORDINATOR", "ZOO_TPU_NUM_PROCESSES",
}


@pytest.fixture(scope="module")
def snapshots():
    from analytics_zoo_tpu_torch.tools.zoolint import ContractIndex
    from analytics_zoo_tpu_torch.tools.zoolint.context import ModuleContext
    from analytics_zoo_tpu_torch.tools.zoolint.engine import _iter_py_files
    ctxs = []
    for fp in _iter_py_files([os.path.join(REPO,
                                           "analytics_zoo_tpu_torch")]):
        with open(fp, encoding="utf-8") as f:
            ctxs.append(ModuleContext(os.path.relpath(fp, REPO),
                                      f.read()))
    with open(os.path.join(REPO, "contracts_snapshot.json"),
              encoding="utf-8") as f:
        jax = json.load(f)
    return jax, ContractIndex(ctxs).snapshot()


def test_contract_ops_and_errors_equal_the_jax_snapshot(snapshots):
    jax, port = snapshots
    assert port["ops"] == jax["ops"]
    assert port["errors"] == jax["errors"]


def test_contract_metric_families_equal_but_named(snapshots):
    jax, port = snapshots
    assert set(jax["metrics"]) - set(port["metrics"]) == METRICS_ONLY_JAX
    assert set(port["metrics"]) <= set(jax["metrics"])
    for name, fam in port["metrics"].items():
        assert fam == jax["metrics"][name], name


def test_contract_env_vars_equal_but_named(snapshots):
    jax, port = snapshots
    assert set(port["env"]) == set(jax["env"])
    differ = {k for k in port["env"] if port["env"][k] != jax["env"][k]}
    assert differ == ENV_DESCRIPTIONS_DIFFER
    for k in differ:
        assert "torch.distributed" in port["env"][k]
        assert "jax.distributed" in jax["env"][k]


def test_port_snapshot_file_is_the_live_index(snapshots):
    _, port = snapshots
    with open(os.path.join(REPO, "contracts_snapshot_torch.json"),
              encoding="utf-8") as f:
        assert json.load(f) == port
