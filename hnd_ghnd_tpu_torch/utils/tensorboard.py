"""Minimal TensorBoard scalar writer and reader (stdlib only).

The port's own copy of hnd_ghnd_tpu/utils/tensorboard.py, which the
runners' ``--tb_dir`` writes through (rank 0 only).  The reference logs
through prints (metric_util.MetricLogger); this adds TensorBoard-compatible
scalar curves.  Event files are TFRecords of serialized `tensorflow.Event`
protos; both formats are stable public wire formats, hand-encoded here:

  TFRecord     = uint64 len | uint32 masked_crc32c(len) | bytes
                 | uint32 masked_crc32c(bytes)
  Event        = 1: double wall_time | 2: int64 step
                 | 3: string file_version | 5: Summary summary
  Summary      = repeated 1: Value
  Summary.Value= 1: string tag | 2: float simple_value

The records are the JAX package's byte for byte; each package reads the
other's files.  They load in TensorBoard and in anything that parses
tfevents (e.g. tensorboard.backend.event_processing).
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import IO, Optional

# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli), table-driven, with the TFRecord masking.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers (only what Event/Summary need).
# ---------------------------------------------------------------------------

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


def _field_double(num: int, v: float) -> bytes:
    return bytes([num << 3 | 1]) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return bytes([num << 3 | 5]) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return bytes([num << 3]) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([num << 3 | 2]) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = (_field_bytes(1, tag.encode("utf-8"))
           + _field_float(2, float(value)))
    summary = _field_bytes(1, val)
    return (_field_double(1, wall_time)
            + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return (_field_double(1, wall_time)
            + _field_bytes(3, b"brain.Event:2"))


def _write_record(f: IO[bytes], payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", _masked_crc(header)))
    f.write(payload)
    f.write(struct.pack("<I", _masked_crc(payload)))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class SummaryWriter:
    """Append-only scalar writer, torch.utils.tensorboard-compatible API
    subset (``add_scalar`` / ``flush`` / ``close``; usable as a context
    manager).  Pass log_dir=None for a no-op writer so call sites need no
    conditionals."""

    def __init__(self, log_dir: Optional[str]):
        self._f: Optional[IO[bytes]] = None
        self.path: Optional[str] = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        _write_record(self._f, _version_event(time.time()))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is None:
            return
        _write_record(self._f, _scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Reader (for tests and quick inspection without TensorBoard).
# ---------------------------------------------------------------------------

def read_scalars(path: str):
    """Parse a tfevents file back into [(tag, value, step), ...]."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (n,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt record header crc")
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("corrupt record payload crc")
            out.extend(_parse_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, v


def _parse_event(payload: bytes):
    step = 0
    scalars = []
    for num, wt, v in _iter_fields(payload):
        if num == 2 and wt == 0:
            step = v
        elif num == 5 and wt == 2:  # summary
            for snum, swt, sv in _iter_fields(v):
                if snum == 1 and swt == 2:  # value
                    tag, val = None, None
                    for vnum, vwt, vv in _iter_fields(sv):
                        if vnum == 1 and vwt == 2:
                            tag = vv.decode("utf-8")
                        elif vnum == 2 and vwt == 5:
                            (val,) = struct.unpack("<f", vv)
                    if tag is not None and val is not None:
                        scalars.append((tag, val, step))
    return scalars
