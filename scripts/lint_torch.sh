#!/usr/bin/env bash
# zoolint gate for the port: the torch-aware static analyzer over
# analytics_zoo_tpu_torch, against the checked-in baseline of justified
# suppressions, then the committed contract snapshot.
#
# Exit 0  = clean modulo zoolint_baseline_torch.json, snapshot matches
# Exit 2  = usage — bad arguments, a broken baseline file (bad JSON /
#           empty justification) or a missing snapshot
# Exit 3  = findings (fix them, or baseline WITH a justification — see
#           docs/dev/zoolint_torch.md for the workflow) or contract drift
#
# The analyzer runs in --format json and this script renders each
# finding plus the per-code summary line CI logs key off.  Pure AST:
# neither jax nor torch is imported by the lint.
set -euo pipefail
cd "$(dirname "$0")/.."
out=$(python -m analytics_zoo_tpu_torch.tools.zoolint \
    analytics_zoo_tpu_torch --baseline zoolint_baseline_torch.json \
    --format json "$@") && rc=0 || rc=$?
if [ "$rc" -ne 0 ] && [ "$rc" -ne 3 ]; then
    # usage / broken baseline: the error already went to stderr and
    # stdout is not a JSON payload — don't try to summarize it
    [ -n "$out" ] && printf '%s\n' "$out"
    exit "$rc"
fi
case "$out" in
    "{"*) ;;
    *)
        # non-JSON output: forwarded modes like --update-baseline or
        # --explain print plain text — pass it through untouched
        printf '%s\n' "$out"
        exit "$rc"
        ;;
esac
ZOOLINT_JSON="$out" python - <<'PY'
import json
import os

data = json.loads(os.environ["ZOOLINT_JSON"])
for f in data["findings"]:
    print("{path}:{line}:{col}: {code} [{symbol}] {message}"
          .format(**f))
s = data["summary"]
by = " ".join(f"{c}={n}" for c, n in sorted(s["by_code"].items())) \
    or "none"
print(f"zoolint summary: total={s['total']} "
      f"suppressed={s['suppressed']} stale={s['stale']} by_code: {by}")
PY
if [ "$rc" -ne 0 ]; then
    exit "$rc"
fi
# committed-contract gate: the live ContractIndex (wire ops, error
# codes, env vars, metric families) must match
# contracts_snapshot_torch.json.  Drift: `zoolint contracts --update`
# + commit.
if python -m analytics_zoo_tpu_torch.tools.zoolint contracts --check \
    > /dev/null; then
    echo "zoolint summary: contracts=ok"
else
    crc=$?
    echo "zoolint summary: contracts=drift"
    python -m analytics_zoo_tpu_torch.tools.zoolint contracts --check \
        || true
    exit "$crc"
fi
echo "zoolint OK"
