"""Fleet wire protocol: length-prefixed, CRC32-framed envelopes over a
localhost socket, carrying the registry's serving envelope across
processes.

Counterpart of ``analytics_zoo_tpu/serving/fleet/protocol.py``.  For the
same envelope the frames are byte for byte those of the JAX package
(the same header, JSON separators, ``__nd__`` and binary layouts, magic
and alignment), so a router of one package talks to a worker of the
other.

One frame = an 8-byte little-endian header (payload length, CRC32 of
the payload) followed by the payload, sent with ONE ``sendall``: a
worker SIGKILLed mid-reply leaves the reader a torn frame it detects,
never a shorter document parsed as the truth.

* requests: ``{"op", "id", ...}`` where the op fields are the
  ``predict_ex``/``generate_ex`` keyword surface (``model``,
  ``deadline_ms``, ``trace_id``, ``priority_class``, and for generate
  ``temperature``/``top_k``/``top_p``/``seed`` as JSON scalars) plus the
  fleet's control ops (``hello``, ``activate``, ``promote``,
  ``undeploy``, ``metrics``, ``ping``, ``shutdown``);
* replies: ``{"id", "ok": true, "result", "info"}`` or ``{"id", "ok":
  false, "error": <ServingError.to_dict()>}``, each with the worker's
  ``load`` piggyback (in-flight count, resident models) and, for a
  traced request, its ``trace`` summary (``observability/tracefleet``).
  :func:`decode_error` rebuilds the CONCRETE serving exception class.

Two payload encodings share the framing.  JSON carries arrays as
``{"__nd__": {dtype, shape, b64}}`` (raw bytes, bit-exact, a third
larger).  The binary payload (:func:`encode_binary` /
:func:`decode_binary`) carries arrays out of band: a magic prefix, a
compact JSON header with each array replaced by a slot reference and a
``[dtype, shape, offset, nbytes]`` table, then the raw buffers, 8-byte
aligned; decoding gives read-only ``np.frombuffer`` views over the
received bytes (no copy: the consumer that moves rows to the device
copies them there once).  The first payload byte tells the encodings
apart (``0xff`` never begins a JSON text); which one a peer may be SENT
is negotiated per connection with ``hello``.

A torch tensor reaching the encoder is turned into a numpy array on the
host (never pickled).  Frames are bounded by ``ZOO_FLEET_MAX_FRAME``
bytes (default 256 MiB).
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import sys
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ... import envcontract
from .. import errors as _errors

_HEADER = struct.Struct("<II")  # payload length, CRC32(payload)

#: hard frame bound: a fleet request is a batch of rows, not a dataset;
#: a corrupt length prefix must not allocate gigabytes before the CRC
#: can convict it
MAX_FRAME_BYTES = 256 << 20

#: wire versions a connection can negotiate (``hello`` op)
WIRE_JSON = 1
WIRE_BINARY = 2

#: binary payloads open with a byte no JSON text can start with
BIN_MAGIC = b"\xffZB2\x00"
_BIN_HLEN = struct.Struct("<I")
_BIN_ALIGN = 8  # array buffers land 8-byte aligned for frombuffer


def max_frame_bytes() -> int:
    """The frame bound: ``ZOO_FLEET_MAX_FRAME`` (bytes) when set and
    parseable, else :data:`MAX_FRAME_BYTES`.  Read per call, so a
    worker's environment applies without plumbing."""
    v = envcontract.env_int("ZOO_FLEET_MAX_FRAME")
    return v if v > 0 else MAX_FRAME_BYTES


class FrameError(ConnectionError):
    """A torn, short, corrupt or oversized frame: the stream is no
    longer trustworthy and the connection is dropped (the router treats
    it as a worker death).  ``attempted_bytes`` is set on the
    OVERSIZE-send flavor, where no byte reached the socket: the worker
    turns that one into a structured error reply carrying the size."""

    def __init__(self, message: str,
                 attempted_bytes: Optional[int] = None):
        super().__init__(message)
        self.attempted_bytes = attempted_bytes


def _oversize(n: int) -> None:
    cap = max_frame_bytes()
    if n > cap:
        raise FrameError(f"frame of {n} bytes exceeds the {cap} byte "
                         "bound", attempted_bytes=n)


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Serialize and send one JSON frame with a single ``sendall``."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    _oversize(len(payload))
    sock.sendall(_HEADER.pack(len(payload),
                              zlib.crc32(payload) & 0xffffffff)
                 + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes; None on a clean EOF before the first byte (a
    peer closing between frames), :class:`FrameError` on EOF inside
    the buffer (a torn frame)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise FrameError(f"short read: {got}/{n} bytes then EOF")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_payload(sock: socket.socket) -> Optional[bytes]:
    """One frame's CRC-checked payload (either encoding), or None on a
    clean EOF at a frame boundary."""
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    length, crc = _HEADER.unpack(head)
    cap = max_frame_bytes()
    if length > cap:
        raise FrameError(f"frame length {length} exceeds the "
                         f"{cap} byte bound")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise FrameError(f"EOF between header and {length}-byte payload")
    if zlib.crc32(payload) & 0xffffffff != crc:
        raise FrameError("frame CRC mismatch")
    return payload


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """One JSON frame, or None on a clean EOF at a frame boundary;
    :class:`FrameError` on a torn frame, a CRC mismatch, an oversized
    length or an undecodable payload."""
    payload = _recv_payload(sock)
    if payload is None:
        return None
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable frame payload: {e}") from e


# -------------------------------------------------------------- arrays
def _host_array(v: Any) -> Optional[np.ndarray]:
    """``v`` as a contiguous host ndarray when it is an array (a numpy
    array, a torch tensor on any device, or anything with
    ``__array__``), else None.  torch is looked up, not imported: a
    tensor can only exist once torch is loaded."""
    if isinstance(v, np.ndarray):
        return np.ascontiguousarray(v)
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(v, torch.Tensor):
        return np.ascontiguousarray(v.detach().cpu().numpy())
    if hasattr(v, "__array__") and not isinstance(
            v, (str, bytes, bool, int, float)):
        return np.ascontiguousarray(np.asarray(v))
    return None


def encode_array(a) -> Dict[str, Any]:
    """One array as a JSON-safe dict (raw bytes, bit-exact)."""
    a = _host_array(a)
    if a is None:
        raise TypeError("encode_array takes an array")
    return {"__nd__": {"dtype": str(a.dtype), "shape": list(a.shape),
                       "b64": base64.b64encode(a.tobytes()).decode()}}


def decode_array(obj: Dict[str, Any]) -> np.ndarray:
    nd = obj["__nd__"]
    return np.frombuffer(
        base64.b64decode(nd["b64"]),
        dtype=np.dtype(nd["dtype"])).reshape(nd["shape"]).copy()


def _scalar_or(v: Any, on_array) -> Any:
    """The walk both encoders share: numpy scalars to Python numbers,
    containers recursed, arrays handed to ``on_array``."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_scalar_or(x, on_array) for x in v]
    if isinstance(v, dict):
        return {k: _scalar_or(x, on_array) for k, x in v.items()}
    a = _host_array(v)
    if a is not None:
        return on_array(a)
    return v


def encode_value(v: Any) -> Any:
    """Arrays (and lists/tuples/dicts holding them) to the JSON wire
    form; everything JSON-native passes through."""
    return _scalar_or(v, encode_array)


def decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__nd__" in v:
            return decode_array(v)
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


# ------------------------------------------------------- binary frames
def _binary_parts(obj: Dict[str, Any]) -> Tuple[List[Any], int, int]:
    """The binary payload as buffers ready for one join and sendall:
    ``[magic, header_len, header_json, pad?, buf0, pad?, buf1, ...]``,
    with ``(parts, total_len, crc32)``; the CRC accumulates over the
    parts so the payload is built once."""
    arrays: List[np.ndarray] = []

    def slot(a: np.ndarray) -> Dict[str, int]:
        arrays.append(a)
        return {"__ndslot__": len(arrays) - 1}

    env = _scalar_or(obj, slot)
    nd = []
    off = 0
    for a in arrays:
        off += (-off) % _BIN_ALIGN
        nd.append([str(a.dtype), list(a.shape), off, a.nbytes])
        off += a.nbytes
    header = json.dumps({"env": env, "nd": nd},
                        separators=(",", ":")).encode("utf-8")
    parts: List[Any] = [BIN_MAGIC, _BIN_HLEN.pack(len(header)), header]
    pos = 0
    for a in arrays:
        pad = (-pos) % _BIN_ALIGN
        if pad:
            parts.append(b"\x00" * pad)
        parts.append(a.data if a.nbytes else b"")
        pos += pad + a.nbytes
    total = len(BIN_MAGIC) + _BIN_HLEN.size + len(header) + pos
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return parts, total, crc & 0xffffffff


def encode_binary(obj: Dict[str, Any]) -> bytes:
    """One envelope as the binary payload."""
    parts, _, _ = _binary_parts(obj)
    return b"".join(parts)


def decode_binary(payload: bytes) -> Dict[str, Any]:
    """The binary payload back into an envelope.  Arrays come back as
    read-only ``np.frombuffer`` views over ``payload`` (no copy; the
    views keep the buffer alive)."""
    try:
        hlen, = _BIN_HLEN.unpack_from(payload, len(BIN_MAGIC))
        base = len(BIN_MAGIC) + _BIN_HLEN.size
        header = json.loads(payload[base:base + hlen].decode("utf-8"))
        body = base + hlen
        mv = memoryview(payload)
        views = []
        for dtype, shape, off, nbytes in header["nd"]:
            start = body + off
            views.append(np.frombuffer(
                mv[start:start + nbytes],
                dtype=np.dtype(dtype)).reshape(shape))
    except (struct.error, KeyError, IndexError, ValueError,
            TypeError, UnicodeDecodeError) as e:
        raise FrameError(f"undecodable binary payload: "
                         f"{type(e).__name__}: {e}") from e

    def _dec(v: Any) -> Any:
        if isinstance(v, dict):
            if "__ndslot__" in v:
                return views[v["__ndslot__"]]
            return {k: _dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [_dec(x) for x in v]
        return v

    return _dec(header["env"])


# ------------------------------------------------------ envelope wire
def send_envelope(sock: socket.socket, obj: Dict[str, Any],
                  binary: bool = False) -> int:
    """Send one envelope in the requested encoding with ONE
    ``sendall``; returns the frame's wire bytes.  The oversize check
    fires before any byte reaches the socket, so the connection stays
    usable and the caller can send a structured error instead."""
    if not binary:
        payload = json.dumps(encode_value(obj),
                             separators=(",", ":")).encode("utf-8")
        _oversize(len(payload))
        sock.sendall(_HEADER.pack(len(payload),
                                  zlib.crc32(payload) & 0xffffffff)
                     + payload)
        return _HEADER.size + len(payload)
    parts, total, crc = _binary_parts(obj)
    _oversize(total)
    sock.sendall(b"".join([_HEADER.pack(total, crc)] + parts))
    return _HEADER.size + total


def recv_envelope(sock: socket.socket
                  ) -> Optional[Tuple[Dict[str, Any], int, str]]:
    """One envelope of EITHER encoding: ``(envelope, wire_bytes,
    "binary"|"json")``, or None on a clean EOF at a frame boundary.
    Arrays come back as ndarrays either way (copies from JSON, views
    from binary)."""
    payload = _recv_payload(sock)
    if payload is None:
        return None
    nbytes = _HEADER.size + len(payload)
    if payload.startswith(BIN_MAGIC):
        return decode_binary(payload), nbytes, "binary"
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable frame payload: {e}") from e
    return decode_value(obj), nbytes, "json"


# -------------------------------------------------------------- errors
_ERROR_CLASSES = {
    "ModelNotFound": _errors.ModelNotFound,
    "Overloaded": _errors.Overloaded,
    "DeadlineExceeded": _errors.DeadlineExceeded,
    "DeployError": _errors.DeployError,
    "ServingError": _errors.ServingError,
    # a structured serving error is never retried on a sibling, so a
    # worker's cold-start miss reaches the client as the concrete 503
    "ColdStartTimeout": _errors.ColdStartTimeout,
    "WorkerUnavailable": _errors.WorkerUnavailable,
}


def _json_safe(v: Any) -> Any:
    """A detail value that JSON cannot carry degrades to its repr: an
    error envelope must always be sendable."""
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def encode_error(exc: BaseException) -> Dict[str, Any]:
    """An exception as the wire error envelope: a ServingError's
    ``to_dict()`` (code, message, details), anything else the generic
    ``{"error": type name, "message"}`` (``errors.error_response``'s
    contract)."""
    if isinstance(exc, _errors.ServingError):
        return {k: _json_safe(v) for k, v in exc.to_dict().items()}
    return {"error": type(exc).__name__, "message": str(exc)}


def decode_error(payload: Dict[str, Any]) -> BaseException:
    """The wire error envelope back into an exception: known codes
    rebuild the concrete class with its details; unknown codes become a
    ``ServingError`` that keeps the original code in
    ``details["error"]``."""
    payload = dict(payload)
    code = payload.pop("error", "ServingError")
    message = payload.pop("message", code)
    cls = _ERROR_CLASSES.get(code)
    if cls is None:
        err = _errors.ServingError(message, **payload)
        err.details["error"] = code
        return err
    return cls(message, **payload)
