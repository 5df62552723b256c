"""Structured serving errors.

Counterpart of ``analytics_zoo_tpu/serving/errors.py``: the same classes,
codes, HTTP statuses and ``to_dict()`` payloads.

Every control-plane rejection is an explicit, typed, immediately-raised
error — never a late timeout.  Each carries machine-readable ``details``
and an ``http_status`` so a web frontend can map it to a response code
without string-matching (the web-service sample does exactly that).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class ServingError(RuntimeError):
    """Base class for control-plane errors.

    ``code`` is a stable machine-readable name (the class name),
    ``details`` a flat JSON-serializable dict of context fields.
    """

    http_status = 500

    def __init__(self, message: str, **details: Any):
        super().__init__(message)
        self.message = message
        self.details: Dict[str, Any] = details

    @property
    def code(self) -> str:
        return type(self).__name__

    def to_dict(self) -> Dict[str, Any]:
        return {"error": self.code, "message": self.message,
                **self.details}

    def __str__(self):
        extra = ", ".join(f"{k}={v}" for k, v in self.details.items())
        return self.message + (f" ({extra})" if extra else "")


class ModelNotFound(ServingError):
    """No deployed model under that name (or that version)."""

    http_status = 404


class Overloaded(ServingError):
    """Admission rejected the request: the model's bounded queue is
    full (or the controller is draining).  Back off and retry —
    queueing it anyway would only grow latency without bound."""

    http_status = 429


class DeadlineExceeded(ServingError):
    """The request's deadline cannot (or could not) be met.

    Raised at ADMISSION time when predicted queue wait + service time
    already overruns the deadline (``details['shed']`` is True — the
    request never consumed a slot), or while waiting for a concurrency
    slot when the deadline lapses.  Either way the caller learns
    immediately instead of timing out late."""

    http_status = 504


class ColdStartTimeout(ServingError):
    """A request to a paged-out (cold) model queued for its fault-in
    but the deadline lapsed before the weights/executables were
    resident again.

    Cold-start handling is admission-integrated: a faulting request
    QUEUES under its own deadline (it is legitimate, promised work —
    never shed for merely being cold) and only past that deadline does
    it fail, with this structured 503 instead of a generic late
    timeout.  The fault-in itself keeps running — the model still
    becomes resident for the next caller, so a retry after the
    suggested backoff normally lands hot."""

    http_status = 503


class WorkerUnavailable(ServingError):
    """No live, routable worker could take the request (whole plane
    restarting or dead).  503: back off and retry.

    Raised by the fleet router; it lives here with the other serving
    errors so the wire protocol can register it in its envelope
    round-trip table without importing the router."""

    http_status = 503


class DeployError(ServingError):
    """A deploy failed before the swap (build or warmup error).  The
    previously active version is untouched and keeps serving — this is
    the rollback path, and ``details`` names the version still live."""

    http_status = 500


def error_response(exc: BaseException) -> tuple[int, Dict[str, Any]]:
    """(http_status, json_payload) for any exception — structured for
    ServingErrors, a generic 400 otherwise."""
    if isinstance(exc, ServingError):
        return exc.http_status, exc.to_dict()
    return 400, {"error": type(exc).__name__, "message": str(exc)}
