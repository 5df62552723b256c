"""Small host-side utilities.

Counterpart of ``analytics_zoo_tpu/common/utils.py`` (reference
zoo/.../common/Utils.scala:32-70: ``listLocalFiles``, ``saveBytes``,
``logUsageErrorAndThrowException``; and nncontext.py:37-38's
log-redirection helpers, which here manage the framework's own logger).
:func:`pad_leading` takes numpy arrays and torch tensors alike.
"""

from __future__ import annotations

import logging
import os
from typing import List

import numpy as np
import torch

log = logging.getLogger("analytics_zoo_tpu_torch")


def pad_leading(batch, pad: int):
    """Zero-pad the leading (batch) axis of every array of ``batch`` (an
    array or tensor, or a tuple or list of them) by ``pad`` rows, keeping
    the dtype (integer ids stay integer) and, for a tensor, the device.
    The padding helper of the trainer's masked tail and the serving
    bucket cache."""
    if pad == 0:
        return batch

    def one(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        a = np.asarray(a)
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    if isinstance(batch, (tuple, list)):
        return tuple(one(a) for a in batch)
    return one(batch)


def list_local_files(path: str) -> List[str]:
    """Every file under ``path``, recursively, in a fixed order
    (Utils.scala:32 listLocalFiles)."""
    out: List[str] = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for f in sorted(files):
            out.append(os.path.join(root, f))
    return out


def save_bytes(data: bytes, path: str, is_overwrite: bool = False):
    """Write bytes to a local file (Utils.scala:52 saveBytes); an
    existing file is replaced only when ``is_overwrite``."""
    if os.path.exists(path) and not is_overwrite:
        raise FileExistsError(
            f"{path} already exists (pass is_overwrite=True to replace)")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def log_usage_error_and_throw(message: str):
    """Log, then raise ``ValueError``: the one funnel of user-facing
    usage errors (Utils.scala:56)."""
    log.error(message)
    raise ValueError(message)


def redirect_logs(path: str, level: int = logging.INFO):
    """Send the framework's logs to a file (the reference's
    redire_spark_logs); returns the handler."""
    handler = logging.FileHandler(path)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    log.addHandler(handler)
    # an unset logger inherits the root's WARNING and would drop INFO
    # before the handler sees it
    if log.level == logging.NOTSET or log.level > level:
        log.setLevel(level)
    return handler


def show_info_logs():
    """Framework logs at INFO on stderr (the reference's
    show_bigdl_info_logs)."""
    log.setLevel(logging.INFO)
    # a FileHandler is a StreamHandler too: only a console one counts
    if not any(type(h) is logging.StreamHandler for h in log.handlers):
        log.addHandler(logging.StreamHandler())
