"""Real logger backends behind the `logging` config group (the port's own
copy of unscene3d_tpu/utils/loggers.py).

The reference wires pluggable Lightning loggers chosen by Hydra group
(wandb in conf/logging/full.yaml, neptune+CSV in base.yaml, TensorBoard+CSV
in offline.yaml; instantiated at main_instance_segmentation.py:51-56).
This module provides the same surface natively:

  * ``TensorBoardLogger`` writes REAL ``events.out.tfevents.*`` files --
    the TFRecord framing (masked CRC32C) and the Event/Summary protobufs
    are encoded by hand in ~80 lines, so the files open in stock
    TensorBoard with zero tensorflow/tensorboardX dependency.
  * ``WandbLogger`` / ``NeptuneLogger`` drive the real client when the
    package is importable in the user's environment, and degrade to the
    append-only JSONL stream (plus a one-line notice) when it is not --
    this image ships neither, but the backend surface is the reference's.

Scalar-only by design: the reference logs per-loss/per-aux scalars
(trainer/trainer.py:149-162) and per-class AP rows (:785-918). Under a
data-parallel process group only rank 0 writes: the other ranks build no
logger (train/experiment.py:build_loggers).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) -- required by the TFRecord framing. zlib.crc32 is the
# IEEE polynomial, not this one, so build the 256-entry table once.
# ---------------------------------------------------------------------------

def _make_crc32c_table():
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tab = _CRC32C_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotate-and-add mask over the raw CRC."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoders (only what Event/Summary need).
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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_string(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def encode_scalar_event(step: int, wall_time: float,
                        scalars: dict) -> bytes:
    """Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}
    (tensorflow/core/util/event.proto + framework/summary.proto)."""
    summary = b"".join(
        _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, float(val)))
        for tag, val in scalars.items())
    return (_pb_double(1, wall_time) + _pb_int64(2, int(step))
            + _pb_bytes(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_string(3, "brain.Event:2")


def write_tfrecord(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


def read_tfrecords(path: str):
    """Decode a tfevents file back into raw payloads, verifying both CRCs
    (used by tests; also a debugging aid)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == masked_crc32c(header), "length CRC mismatch"
            (n,) = struct.unpack("<Q", header)
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == masked_crc32c(payload), "payload CRC mismatch"
            out.append(payload)
    return out


def decode_scalar_event(payload: bytes) -> dict:
    """Inverse of encode_scalar_event, for tests/debugging. Returns
    {"step": int, "wall_time": float, "scalars": {tag: value}} (scalars
    empty for the file_version record)."""

    def fields(buf):
        i = 0
        while i < len(buf):
            key, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                key |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, shift = 0, 0
                while True:
                    b = buf[i]
                    i += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
            elif wire == 1:
                v = buf[i:i + 8]
                i += 8
            elif wire == 2:
                n, shift = 0, 0
                while True:
                    b = buf[i]
                    i += 1
                    n |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                v = buf[i:i + n]
                i += n
            elif wire == 5:
                v = buf[i:i + 4]
                i += 4
            else:  # pragma: no cover
                raise ValueError(f"wire type {wire}")
            yield field, wire, v

    ev = {"step": 0, "wall_time": 0.0, "scalars": {}}
    for field, wire, v in fields(payload):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif field == 2 and wire == 0:
            ev["step"] = v
        elif field == 5 and wire == 2:  # Summary
            for f2, w2, v2 in fields(v):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag, val = None, None
                    for f3, w3, v3 in fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            val = struct.unpack("<f", v3)[0]
                    if tag is not None:
                        ev["scalars"][tag] = val
    return ev


# ---------------------------------------------------------------------------
# Logger backends
# ---------------------------------------------------------------------------

_NUMERIC = (int, float)


def _scalar_items(row: dict):
    for k, v in row.items():
        if hasattr(v, "item"):
            try:
                v = v.item()
            except Exception:  # pragma: no cover - non-scalar array
                continue
        if isinstance(v, bool) or not isinstance(v, _NUMERIC):
            continue
        yield k, float(v)


class TensorBoardLogger:
    """Writes standard ``events.out.tfevents.{t}.{host}`` files readable by
    stock TensorBoard (reference conf/logging/offline.yaml wires
    pytorch_lightning's TensorBoardLogger)."""

    def __init__(self, save_dir: str, name: str = "tb"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        t = time.time()
        self.path = os.path.join(
            self.dir,
            f"events.out.tfevents.{int(t)}.{socket.gethostname()}")
        self._step = 0
        with open(self.path, "wb") as f:
            write_tfrecord(f, encode_file_version_event(t))

    def log(self, row: dict):
        scalars = dict(_scalar_items(row))
        step = int(scalars.pop("step", scalars.get("epoch", self._step)))
        self._step = max(self._step, step) + 1
        if not scalars:
            return
        with open(self.path, "ab") as f:
            write_tfrecord(f, encode_scalar_event(step, time.time(), scalars))


class _ClientOrJSONL:
    """Shared shape for service loggers: use the real client when its
    package exists in the environment, otherwise stream to JSONL offline."""

    service = "service"

    def __init__(self, save_dir: str):
        os.makedirs(save_dir, exist_ok=True)
        self._client = self._init_client(save_dir)
        self.path = os.path.join(save_dir, f"{self.service}_offline.jsonl")
        if self._client is None:
            print(f"[logging] no {self.service} client in this environment: "
                  f"'{self.service}' logger entries stream to "
                  f"{self.path}", flush=True)

    def _init_client(self, save_dir: str):  # pragma: no cover - needs pkg
        return None

    def _client_log(self, row: dict):  # pragma: no cover - needs pkg
        raise NotImplementedError

    def log(self, row: dict):
        if self._client is not None:  # pragma: no cover - needs pkg
            self._client_log(row)
            return
        row = {k: (float(v) if hasattr(v, "item") else v)
               for k, v in row.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")


class WandbLogger(_ClientOrJSONL):
    """Real wandb runs when the package is installed (reference
    conf/logging/full.yaml); offline JSONL otherwise."""

    service = "wandb"

    def _init_client(self, save_dir: str):  # pragma: no cover - needs pkg
        try:
            import wandb
        except ImportError:
            return None
        return wandb.init(project=os.environ.get("WANDB_PROJECT",
                                                 "unscene3d_torch"),
                          dir=save_dir, reinit=True)

    def _client_log(self, row: dict):  # pragma: no cover - needs pkg
        self._client.log(dict(_scalar_items(row)))


class NeptuneLogger(_ClientOrJSONL):
    """Real neptune runs when the package is installed (reference
    conf/logging/base.yaml); offline JSONL otherwise."""

    service = "neptune"

    def _init_client(self, save_dir: str):  # pragma: no cover - needs pkg
        try:
            import neptune
        except ImportError:
            return None
        return neptune.init_run()

    def _client_log(self, row: dict):  # pragma: no cover - needs pkg
        for k, v in _scalar_items(row):
            self._client[k].append(v)
