"""Scalar TensorBoard event writer, with no tensorboard package (PyTorch
port of ``vln_ver_tpu/utils/tensorboard.py``, byte for byte the same
files).

The reference registers a TensorboardLoggerHook (vocc.py:286-291).  The
event file format is written directly: TFRecord framing (length + masked
CRC32C) around hand-encoded ``tensorflow.Event`` protobuf messages with
scalar ``Summary.Value`` entries.  The files load in stock TensorBoard.

Only scalars are supported, exactly what the reference hook logs.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# -- CRC32C (Castagnoli, reflected poly 0x82F63B78) ----------------------
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding -------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _str_field(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: field 1 = tag (string), field 2 = simple_value (float)
    v = (_str_field(1, tag.encode())
         + _tag(2, 5) + struct.pack("<f", float(value)))
    # Summary: field 1 = repeated Value
    return _str_field(1, v)


def _event(wall_time: float, step: int, summary: bytes = b"",
           file_version: str | None = None) -> bytes:
    # Event: 1=wall_time(double) 2=step(int64) 3=file_version 5=summary
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    out += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _str_field(3, file_version.encode())
    if summary:
        out += _str_field(5, summary)
    return out


class SummaryWriter:
    """Scalar-only TensorBoard event writer (mmcv TensorboardLoggerHook
    replacement)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step),
                           _summary_value(tag, value)))

    def add_scalars(self, scalars: dict, step: int) -> None:
        for k, v in scalars.items():
            try:
                self.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str):
    """Parse an event file back into [(step, tag, value)] — the test-side
    decoder proving the format round-trips."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 12  # len + len-crc
        record = data[pos:pos + length]
        pos += length + 4  # record + crc
        # decode Event fields
        i, step, summary = 0, 0, b""
        while i < len(record):
            key = record[i]
            field, wire = key >> 3, key & 7
            i += 1
            if wire == 0:
                val = 0
                shift = 0
                while True:
                    b = record[i]
                    i += 1
                    val |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = val
            elif wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = record[i]
                    i += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 5:
                    summary = record[i:i + ln]
                i += ln
        # decode Summary -> Value(tag, simple_value).  Lengths are
        # VARINTS — a single-byte read would misparse any submessage or
        # tag >= 128 bytes (long nested metric names), which the writer
        # itself can produce.
        def _varint(buf, k):
            val = shift = 0
            while True:
                b = buf[k]
                k += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    return val, k
        j = 0
        while j < len(summary):
            key = summary[j]
            j += 1
            ln, j = _varint(summary, j)
            val_msg = summary[j:j + ln]
            j += ln
            k, tag, value = 0, None, None
            while k < len(val_msg):
                vkey = val_msg[k]
                vfield, vwire = vkey >> 3, vkey & 7
                k += 1
                if vwire == 2:
                    vln, k = _varint(val_msg, k)
                    if vfield == 1:
                        tag = val_msg[k:k + vln].decode()
                    k += vln
                elif vwire == 5:
                    if vfield == 2:
                        (value,) = struct.unpack_from("<f", val_msg, k)
                    k += 4
                else:
                    break
            if tag is not None and value is not None:
                out.append((step, tag, value))
    return out
