"""Minimal TensorBoard event-file writer — no tensorflow dependency (own
copy of ``deepsense6g_tii_tpu/utils/tb_events.py``; the same scalars give
the same bytes).

A training run's scalar log is a TensorBoard event file.  Importing
tensorflow just to emit scalars costs ~10 s and hundreds of MB on
the training host, so this hand-encodes the two formats involved:

* the TFRecord framing: ``[len u64][masked-crc32c(len) u32][payload]
  [masked-crc32c(payload) u32]`` with the Castagnoli CRC and TensorFlow's
  rotate-and-add masking, and
* the ``Event`` protobuf wire format (double wall_time=1, int64 step=2,
  string file_version=3, Summary summary=5; Summary.value: string tag=1,
  float simple_value=2) — the only message shapes scalar logging needs.

Files are named ``events.out.tfevents.<ts>.<host>`` so TensorBoard discovers
them.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterable

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TensorFlow's masked CRC (record_writer.cc)."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = struct.pack("<Bd", 0x09, wall_time)          # field 1, double
    if step:
        msg += b"\x10" + _varint(step)                 # field 2, varint
    if file_version:
        msg += _field_bytes(3, file_version.encode())  # field 3, string
    if summary:
        msg += _field_bytes(5, summary)                # field 5, Summary
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = (_field_bytes(1, tag.encode())
           + struct.pack("<Bf", 0x15, value))          # field 2, float
    return _field_bytes(1, val)                        # Summary.value


class EventFileWriter:
    """Append-only TensorBoard scalar event file in ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        ts = time.time()
        name = f"events.out.tfevents.{int(ts)}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, name), "ab")
        self._record(_event(ts, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=int(step),
                            summary=_scalar_summary(tag, float(value))))
        self._f.flush()

    def scalars(self, items: Iterable) -> None:
        for tag, value, step in items:
            self.scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
