"""Persistent executable store, under the JAX package's module name.

Counterpart of ``analytics_zoo_tpu/serving/execstore.py``.  The store
itself (:class:`ExecStore`, :func:`configure`, :func:`disable`,
:func:`current`, :func:`tag_builds`, ``ZOO_EXECSTORE_DIR``) lives in
``common/execstore.py``, below the kernel build that reads through it;
this module re-exports it and carries the CLI
(``python -m analytics_zoo_tpu_torch.serving.execstore`` with
``stat [--by-model] [--by-mesh]`` or ``gc [--budget BYTES]``).

The port's entries are kernel libraries: ``common/execstore.py`` says
why, and what a hit, a miss and a corrupt entry do.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

from .. import envcontract
from ..common.execstore import (ENV_BUDGET, ENV_DIR, ExecStore,
                                StoreEntry, build_tag, configure, current,
                                disable, tag_builds)

__all__ = ["ENV_BUDGET", "ENV_DIR", "ExecStore", "StoreEntry", "build_tag",
           "configure", "current", "disable", "main", "tag_builds"]


# ---- CLI --------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    """``python -m analytics_zoo_tpu_torch.serving.execstore gc|stat``."""
    import argparse
    # --root is accepted on both sides of the subcommand: SUPPRESS on the
    # shared parent keeps an absent sub-level flag from clobbering a
    # top-level one
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--root", default=argparse.SUPPRESS,
                        help=f"store directory (default: ${ENV_DIR})")
    parser = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.execstore",
        description="inspect / garbage-collect the persistent "
                    "executable store")
    parser.add_argument("--root", default=None,
                        help=f"store directory (default: ${ENV_DIR})")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_stat = sub.add_parser("stat", parents=[common],
                            help="print store contents and counters")
    p_stat.add_argument("--by-model", action="store_true",
                        help="aggregate entries/bytes per model tag "
                             "(the deploy each build was made for)")
    p_stat.add_argument("--by-mesh", action="store_true",
                        help="aggregate entries/bytes per mesh layout "
                             "(axes x strategy; '-' = none)")
    p_gc = sub.add_parser("gc", parents=[common],
                          help="LRU-evict down to a byte budget")
    p_gc.add_argument("--budget", type=int, default=None,
                      help=f"byte budget (default: ${ENV_BUDGET})")
    args = parser.parse_args(argv)
    root = args.root or envcontract.env_str(ENV_DIR)
    if not root:
        parser.error(f"no store: pass --root or set ${ENV_DIR}")
    store = ExecStore(root)
    if args.cmd == "stat":
        s = store.stats()
        print(f"execstore {s['root']}: {s['entries']} entries, "
              f"{s['bytes']:,} bytes"
              + (f" (budget {s['byte_budget']:,})"
                 if s["byte_budget"] else ""))
        if getattr(args, "by_model", False) \
                or getattr(args, "by_mesh", False):
            # largest first: "what is eating the store", top-down
            table = store.by_mesh() if getattr(args, "by_mesh", False) \
                else store.by_model()
            agg = sorted(table.items(), key=lambda kv: -kv[1]["bytes"])
            for tag, row in agg:
                print(f"  {tag:<24} {row['entries']:>5} entries  "
                      f"{row['bytes']:>12,} B")
            return 0
        for e in store.entries():
            age = time.time() - e["mtime"]
            print(f"  {e['fingerprint'][:16]}  {e['bytes']:>10,} B  "
                  f"{age:>8.0f}s old  {e['kind']}  {e['model']}  "
                  f"{e['mesh']}")
        return 0
    budget = args.budget
    if budget is None:
        env_budget = envcontract.env_str(ENV_BUDGET)
        if env_budget is None:
            parser.error(f"gc needs --budget or ${ENV_BUDGET}")
        budget = int(env_budget)
    res = store.gc(byte_budget=budget)
    print(f"execstore gc: evicted {res['evicted']} entries "
          f"({res['freed_bytes']:,} B freed), {res['entries']} kept "
          f"({res['bytes']:,} B)")
    return 0


if __name__ == "__main__":  # pragma: no cover — tested via main()
    import sys
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stat | head closed the pipe: a normal way to read a long table
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
