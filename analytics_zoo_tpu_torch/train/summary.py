"""Training/validation summaries (TensorBoard-compatible scalars).

Counterpart of ``analytics_zoo_tpu/train/summary.py`` (a copy: the port
imports nothing of the JAX package).  ``set_tensorboard(log_dir,
app_name)`` gives a model a TrainSummary (Loss per step, Throughput per
epoch) and a ValidationSummary (each validation metric per epoch),
written as native TensorBoard event files (record framing and masked
CRC32c per the TFRecord spec) plus a ``scalars.jsonl`` beside them.
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Dict, List, Tuple


def _crc32c(data: bytes) -> int:
    """Software CRC32C (Castagnoli), table-driven."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC_TABLE = None


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _scalar_event_proto(step: int, tag: str, value: float,
                        wall_time: float) -> bytes:
    """Hand-encode an Event{wall_time, step, summary{value{tag,
    simple_value}}} protobuf (schema: tensorflow/core/util/event.proto)."""
    tag_b = tag.encode("utf-8")
    sv = _tag(1, 2) + _varint(len(tag_b)) + tag_b  # Summary.Value.tag = 1
    sv += _tag(2, 5) + struct.pack("<f", value)    # simple_value = 2
    summary = _tag(1, 2) + _varint(len(sv)) + sv   # Summary.value = 1
    event = _tag(1, 1) + struct.pack("<d", wall_time)  # Event.wall_time = 1
    event += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)  # Event.step = 2
    event += _tag(5, 2) + _varint(len(summary)) + summary     # summary = 5
    return event


class SummaryWriter:
    """Append-only tfevents + jsonl scalar writer."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.zoo_torch"
        self._events_path = os.path.join(log_dir, fname)
        self._events = open(self._events_path, "ab")
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._history: Dict[str, List[Tuple[int, float]]] = {}
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, tag: str, trigger) -> "SummaryWriter":
        """Throttle how often a tag is recorded — parity with BigDL
        ``TrainSummary.setSummaryTrigger`` (used by the reference
        recommendation notebooks: ``set_summary_trigger("Loss",
        SeveralIteration(1))``).  ``trigger`` is any
        ``analytics_zoo_tpu_torch.train.triggers.Trigger``; it gates
        ``add_scalar`` for that tag, whatever the tag is."""
        self._triggers[tag] = trigger
        return self

    def should_log(self, tag: str, step: int) -> bool:
        trig = self._triggers.get(tag)
        if trig is None:
            return True
        return bool(trig({"iteration": int(step)}))

    def add_scalar(self, tag: str, value: float, step: int):
        if not self.should_log(tag, step):
            return
        wall = time.time()
        record = _scalar_event_proto(step, tag, float(value), wall)
        header = struct.pack("<Q", len(record))
        self._events.write(header)
        self._events.write(struct.pack("<I", _masked_crc(header)))
        self._events.write(record)
        self._events.write(struct.pack("<I", _masked_crc(record)))
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall_time": wall}) + "\n")
        self._history.setdefault(tag, []).append((int(step), float(value)))

    def flush(self):
        self._events.flush()
        self._jsonl.flush()

    def close(self):
        self._events.close()
        self._jsonl.close()

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """Mirror of the reference's TrainSummary.readScalar."""
        return list(self._history.get(tag, []))


def read_scalars(log_dir: str, app_name: str, tag: str,
                 split: str = "train") -> List[Tuple[int, float]]:
    """Read a PAST run's scalars back from disk (the reference's
    TrainSummary.readScalar works on saved logs; the in-memory
    ``read_scalar`` only covers the live writer).  Reads the jsonl
    sidecar, so no TF dependency is needed to plot a finished run."""
    path = os.path.join(log_dir, app_name, split, "scalars.jsonl")
    out: List[Tuple[int, float]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line from a crashed writer
            if rec.get("tag") == tag:
                out.append((int(rec["step"]), float(rec["value"])))
    return out


class TrainSummary(SummaryWriter):
    """Scalars: Loss, LearningRate, Throughput (parity with BigDL)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "train"))
        self.app_name = app_name


class ValidationSummary(SummaryWriter):
    def __init__(self, log_dir: str, app_name: str):
        super().__init__(os.path.join(log_dir, app_name, "validation"))
        self.app_name = app_name
