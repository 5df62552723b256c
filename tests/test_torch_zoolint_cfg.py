"""Port counterpart of ``tests/test_zoolint_cfg.py``: the port's zoolint
CFG builder (``analytics_zoo_tpu_torch/tools/zoolint/cfg.py``), its
exception-edge construction pinned on edge lists (not rule outcomes — a
rule can mask a miswired graph).

Node labels are ``L<lineno>:<StmtType>`` plus the virtual
``entry``/``exit``/``raise`` nodes and the synthetic
``L<lineno>:finally`` / ``L<lineno>:except-dispatch`` nodes, so each
test pins the exact edges a construct must (and must NOT) produce:

* ``try/finally`` — implicit exception edges from body statements into
  the finally, a ``reraise`` edge (post-state: the finally RAN) from
  the finally out to ``raise``, and ``return`` routed through the
  finally to ``exit``;
* ``with`` — the header raises like any statement when protected; the
  body adds no exception machinery of its own;
* nested handlers — an exception unmatched by the inner ``except``
  propagates to the OUTER dispatch, and handler bodies are protected
  by the outer try, not their own;
* ``else`` — runs after the body, NOT protected by this try's
  handlers;
* catch-all discipline — ``except Exception`` leaves the uncaught
  edge in place (KeyboardInterrupt walks past it — the admission
  ``_acquire`` lesson);
  ``except BaseException`` removes it.
"""

import ast
import textwrap

from analytics_zoo_tpu_torch.tools.zoolint.cfg import CFG, build_cfg


def _cfg(src: str) -> CFG:
    tree = ast.parse(textwrap.dedent(src))
    fd = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef))
    return build_cfg(fd)


def test_linear_function_edges():
    cfg = _cfg("""\
        def f(x):
            a = x
            return a
        """)
    edges = cfg.describe()
    assert ("entry", "L2:Assign", "normal") in edges
    assert ("L2:Assign", "L3:Return", "normal") in edges
    assert ("L3:Return", "exit", "return") in edges
    # no protected region: no implicit exception edges at all
    assert not [e for e in edges if e[2] == "exc"]


def test_raise_outside_try_goes_to_raise_exit():
    cfg = _cfg("""\
        def f(x):
            if x:
                raise ValueError(x)
            return x
        """)
    edges = cfg.describe()
    assert ("L2:If", "L3:Raise", "true") in edges
    assert ("L3:Raise", "raise", "raise") in edges
    assert ("L2:If", "L4:Return", "false") in edges


def test_try_finally_exception_and_return_route_through_finally():
    cfg = _cfg("""\
        def f(sem, work):
            sem.acquire()
            try:
                return work()
            finally:
                sem.release()
        """)
    edges = cfg.describe()
    # the body statement can raise -> into the finally (pre-state edge)
    assert ("L4:Return", "L3:finally", "exc") in edges
    # its return is ROUTED through the finally too
    assert ("L4:Return", "L3:finally", "return") in edges
    assert ("L4:Return", "exit", "return") not in edges
    # the finally completed: reraise (post-state) out, return to exit
    assert ("L6:Expr", "raise", "reraise") in edges
    assert ("L6:Expr", "exit", "return") in edges


def test_handlers_else_and_uncaught_propagation():
    cfg = _cfg("""\
        def f(a, b, c, d):
            try:
                a()
            except ValueError:
                b()
            else:
                c()
            d()
        """)
    edges = cfg.describe()
    # body raises into the dispatch; dispatch fans to the handler AND
    # onward (except ValueError is not a catch-all)
    assert ("L3:Expr", "L2:except-dispatch", "exc") in edges
    assert ("L2:except-dispatch", "L5:Expr", "exc") in edges
    assert ("L2:except-dispatch", "raise", "exc") in edges
    # else runs after a clean body and is NOT protected by the
    # handlers: no exc edge from it to the dispatch (it has nowhere
    # local to go here, so none at all)
    assert ("L3:Expr", "L7:Expr", "normal") in edges
    assert ("L7:Expr", "L2:except-dispatch", "exc") not in edges
    assert not [e for e in edges if e[0] == "L7:Expr" and e[2] == "exc"]
    # both the else and the handler continue to the statement after
    assert ("L7:Expr", "L8:Expr", "normal") in edges
    assert ("L5:Expr", "L8:Expr", "normal") in edges


def test_catch_all_baseexception_stops_propagation():
    cfg = _cfg("""\
        def f(a, b):
            try:
                a()
            except BaseException:
                b()
        """)
    edges = cfg.describe()
    assert ("L3:Expr", "L2:except-dispatch", "exc") in edges
    assert ("L2:except-dispatch", "L5:Expr", "exc") in edges
    assert ("L2:except-dispatch", "raise", "exc") not in edges


def test_nested_handlers_propagate_to_outer_dispatch():
    cfg = _cfg("""\
        def f(a, b, c):
            try:
                try:
                    a()
                except ValueError:
                    b()
            except KeyError:
                c()
        """)
    edges = cfg.describe()
    # inner body -> inner dispatch -> (unmatched) outer dispatch
    assert ("L4:Expr", "L3:except-dispatch", "exc") in edges
    assert ("L3:except-dispatch", "L6:Expr", "exc") in edges
    assert ("L3:except-dispatch", "L2:except-dispatch", "exc") in edges
    # the INNER handler body is protected by the OUTER try only
    assert ("L6:Expr", "L2:except-dispatch", "exc") in edges
    assert ("L6:Expr", "L3:except-dispatch", "exc") not in edges
    # outer is not catch-all either
    assert ("L2:except-dispatch", "raise", "exc") in edges


def test_with_header_and_body_protected_inside_try():
    cfg = _cfg("""\
        def f(lk, io):
            try:
                with lk:
                    io()
            except Exception:
                pass
        """)
    edges = cfg.describe()
    # __enter__ can raise: the with HEADER gets the exc edge
    assert ("L3:With", "L2:except-dispatch", "exc") in edges
    # so does the protected body statement
    assert ("L4:Expr", "L2:except-dispatch", "exc") in edges
    # the with adds no exception machinery of its own: header -> body
    assert ("L3:With", "L4:Expr", "normal") in edges
    # except Exception is NOT a catch-all (KeyboardInterrupt escapes)
    assert ("L2:except-dispatch", "raise", "exc") in edges


def test_with_outside_try_has_no_exception_edges():
    cfg = _cfg("""\
        def f(lk, io):
            with lk:
                io()
        """)
    assert not [e for e in cfg.describe() if e[2] == "exc"]


def test_loop_break_continue_and_back_edge():
    cfg = _cfg("""\
        def f(q):
            while q.pending():
                if q.bad():
                    break
                q.step()
            q.done()
        """)
    edges = cfg.describe()
    assert ("L2:While", "L3:If", "true") in edges
    assert ("L3:If", "L4:Break", "true") in edges
    assert ("L4:Break", "L6:Expr", "break") in edges   # past the loop
    assert ("L5:Expr", "L2:While", "loop") in edges    # back edge
    assert ("L2:While", "L6:Expr", "false") in edges   # loop exit
    assert ("L6:Expr", "exit", "fallthrough") in edges


def test_break_chains_through_nested_finallys():
    """A break routed through an inner finally must ALSO traverse
    every enclosing finally before landing past the loop — a release
    performed in the outer finally is on that path."""
    cfg = _cfg("""\
        def f(q, inner, outer):
            while q.pending():
                try:
                    try:
                        break
                    finally:
                        inner()
                finally:
                    outer()
            q.done()
        """)
    edges = cfg.describe()
    assert ("L5:Break", "L4:finally", "break") in edges
    # inner finally body (L7) chains into the OUTER finally (L3),
    # never straight past the loop
    assert ("L7:Expr", "L3:finally", "break") in edges
    assert ("L7:Expr", "L10:Expr", "break") not in edges
    # the outer finally body (L9) is what lands past the loop
    assert ("L9:Expr", "L10:Expr", "break") in edges


def test_break_inside_try_finally_routes_through_finally():
    cfg = _cfg("""\
        def f(q, cleanup):
            while q.pending():
                try:
                    break
                finally:
                    cleanup()
            q.done()
        """)
    edges = cfg.describe()
    assert ("L4:Break", "L3:finally", "break") in edges
    # the finally ran, THEN the break lands past the loop
    assert ("L6:Expr", "L7:Expr", "break") in edges
    assert ("L4:Break", "L7:Expr", "break") not in edges
