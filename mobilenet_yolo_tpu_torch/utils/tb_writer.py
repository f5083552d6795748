"""TensorBoard event-file writer with zero dependencies.

The reference logs scalars through tensorboardX (train.py:49-51,200-217).
Rather than importing tensorflow (a ~10s import on a one-core host) or
adding a dependency, this hand-encodes the two tiny protos TensorBoard's
scalar dashboard needs (Event, Summary) plus the TFRecord framing:

    record  := u64le length, u32le masked_crc32c(length bytes),
               payload[length], u32le masked_crc32c(payload)
    Event   := 1: double wall_time | 2: int64 step
             | 3: string file_version | 5: Summary summary
    Summary := repeated 1: Value { 1: string tag | 2: float simple_value }

CRC is Castagnoli (crc32c) with TensorFlow's rotation mask. Files written
here load in stock TensorBoard (`tensorboard --logdir ...`).

A copy of ``mobilenet_yolo_tpu/utils/tb_writer.py``: the same bytes for
the same scalars and clock.
"""

from __future__ import annotations

import os
import socket
import struct
import time


# ------------------------------------------------------------------ crc32c

def _make_crc32c_table():
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto wire format

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


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    value_msg = (_field_bytes(1, tag.encode("utf-8"))
                 + _field_float(2, float(value)))
    summary = _field_bytes(1, value_msg)
    return (_field_double(1, wall_time)
            + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    return (_field_double(1, wall_time)
            + _field_bytes(3, b"brain.Event:2"))


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


# ------------------------------------------------------------------ writer

class EventFileWriter:
    """Append-only scalar event writer for one logdir."""

    def __init__(self, logdir: str, clock=time.time):
        os.makedirs(logdir, exist_ok=True)
        self._clock = clock
        host = socket.gethostname() or "local"
        name = f"events.out.tfevents.{int(clock())}.{host}.{os.getpid()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._f.write(frame_record(encode_file_version_event(clock())))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int):
        self._f.write(frame_record(
            encode_scalar_event(tag, value, step, self._clock())))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
