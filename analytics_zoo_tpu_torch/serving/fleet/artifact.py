"""The fleet deploy artifact: one model version persisted ONCE on the
shared directory, activated by every worker.

Counterpart of ``analytics_zoo_tpu/serving/fleet/artifact.py``, with
the same layout and spec keys, so each package reads the other's
directories::

    <share>/deploys/<model>/v<version>/
        weights.npz   # flat {name: ndarray}
        spec.json     # builder + args + registry deploy kwargs (THE
                      # COMMIT POINT: written last, atomic rename)

A worker listing versions never sees a half-written artifact: the
weights of an uncommitted deploy stay invisible until its spec renames
in.  The spec's ``builder`` is a ``module:callable`` path resolved IN
THE WORKER and called as ``builder(args, params, device=...)``; it
returns the ``ModelRegistry.deploy`` keywords for this version
(``{"fn": fn, "params": params}``, ``{"net": lm, ...}`` or ``{"model":
handle}``).  A spec written by the JAX package names a builder of that
package, which this package never resolves.  The artifact carries no
compiled code: the kernel libraries live in the execstore.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ...observability.flightrec import atomic_write
from .protocol import _host_array

_SPEC = "spec.json"
_WEIGHTS = "weights.npz"
_VDIR_RE = re.compile(r"^v(\d+)$")
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")
#: the JAX package's top-level name: its builders are never resolved here
_FOREIGN = "analytics_zoo_tpu"


def deploys_root(share_dir: str) -> str:
    return os.path.join(share_dir, "deploys")


def _version_dir(share_dir: str, model: str, version: int) -> str:
    if not _NAME_RE.match(model) or model in (".", ".."):
        # model names become path components: reject traversal early
        raise ValueError(f"invalid model name {model!r}")
    return os.path.join(deploys_root(share_dir), model, f"v{version}")


def _saveable(v: Any) -> np.ndarray:
    a = _host_array(v)
    return np.asarray(v) if a is None else a


def publish(share_dir: str, model: str, version: int,
            params: Optional[Dict[str, Any]], spec: Dict[str, Any]
            ) -> str:
    """Persist one version's artifact; returns its directory.  The spec
    lands LAST by atomic rename: its presence IS the commit.
    ``params`` is a flat ``{name: array}`` dict (None for a builder
    that needs no weights); a torch tensor is saved from the host."""
    d = _version_dir(share_dir, model, version)
    os.makedirs(d, exist_ok=True)
    if params is not None:
        tmp = os.path.join(d, f"{_WEIGHTS}.tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, **{k: _saveable(v) for k, v in params.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, _WEIGHTS))
    spec = {"model": model, "version": version,
            "has_weights": params is not None, **spec}
    atomic_write(os.path.join(d, _SPEC), json.dumps(spec, indent=2))
    return d


def load(share_dir: str, model: str, version: int
         ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """One committed artifact: ``(spec, params)``."""
    d = _version_dir(share_dir, model, version)
    with open(os.path.join(d, _SPEC)) as f:
        spec = json.load(f)
    params = None
    if spec.get("has_weights"):
        with np.load(os.path.join(d, _WEIGHTS)) as z:
            params = {k: z[k] for k in z.files}
    return spec, params


def versions(share_dir: str, model: str) -> Dict[int, str]:
    """Committed versions on disk, ``{version: dir}``: only directories
    whose spec has landed (an in-flight publish is invisible)."""
    base = os.path.join(deploys_root(share_dir), model)
    out: Dict[int, str] = {}
    try:
        names = os.listdir(base)
    except OSError:
        return out
    for name in names:
        m = _VDIR_RE.match(name)
        d = os.path.join(base, name)
        if m and os.path.exists(os.path.join(d, _SPEC)):
            out[int(m.group(1))] = d
    return out


def resolve_builder(path: str) -> Callable:
    """``"package.module:callable"`` to the callable.  The worker trusts
    the share as much as the execstore (an operator-owned path: the
    spec names code to run).  A path into the JAX package is refused:
    its builders return that package's handles, which this package
    cannot serve."""
    if ":" not in path:
        raise ValueError(
            f"builder {path!r} must be 'module:callable'")
    mod_name, attr = path.split(":", 1)
    if mod_name.split(".")[0] == _FOREIGN:
        raise ValueError(
            f"builder {path!r} belongs to the JAX package; this "
            "package resolves only its own builders (e.g. "
            f"'analytics_zoo_tpu_torch.serving.fleet.builders:{attr}')")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr, None)
    if not callable(fn):
        raise ValueError(f"builder {path!r} did not resolve to a "
                         "callable")
    return fn


def build_deploy_kwargs(spec: Dict[str, Any],
                        params: Optional[Dict[str, Any]],
                        device: str = "cuda") -> Dict[str, Any]:
    """Run the spec's builder on ``device``: the ``ModelRegistry.deploy``
    keywords for this version, plus what the spec pins for every worker
    alike (``deploy_kwargs``, ``warmup_shapes``, ``mesh``), so all of
    them pad to the same buckets and build the same kernels."""
    builder = resolve_builder(spec["builder"])
    kwargs = dict(builder(spec.get("args") or {}, params, device=device))
    for k, v in (spec.get("deploy_kwargs") or {}).items():
        kwargs.setdefault(k, v)
    if spec.get("warmup_shapes") is not None:
        kwargs.setdefault("warmup_shapes",
                          tuple(spec["warmup_shapes"]))
    if spec.get("mesh") is not None:
        kwargs.setdefault("mesh", spec["mesh"])
    return kwargs
