"""TF-free TFRecord gait-sample reader.

The port's own copy of ``ugaitnet_tpu/data/tfrecord.py`` (numpy only), so
the port imports nothing of the JAX package.

Interop equivalent of (reference) data/mj_tfdata.py:12-96: reads the
legacy single-sample gait TFRecord files (int16 raw planes /100, shape
(-1, 50, 60, 60), plus int64 metadata features) without importing
TensorFlow — the record framing (length + masked-crc framing) and the
tf.train.Example protobuf wire format are parsed directly.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
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


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def iter_tfrecords(path: str, crc: str = "header") -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    crc selects how much integrity checking to pay for, EXPLICITLY (a
    boolean "verify" flag silently weakened when payload checking moved
    behind a second parameter):
      "none"   — no checks
      "header" — the 12-byte length header's crc only (cheap; default)
      "full"   — header + payload crc; the payload crc walks every byte
                 in python (~seconds per multi-MB gait record on this
                 one-core host), so it is a conscious opt-in
    """
    if crc not in ("none", "header", "full"):
        raise ValueError(f"crc must be none|header|full, got {crc!r}")
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return          # clean EOF on a record boundary
            if len(header) < 12:
                raise ValueError(
                    f"truncated TFRecord {path}: 12-byte length header cut "
                    f"short at EOF ({len(header)} bytes left)")
            (length,), (hcrc,) = (struct.unpack("<Q", header[:8]),
                                  struct.unpack("<I", header[8:]))
            if crc != "none" and _masked_crc(header[:8]) != hcrc:
                raise ValueError(f"corrupt length crc in {path}")
            payload = f.read(length)
            trailer = f.read(4)
            if len(payload) < length or len(trailer) < 4:
                # short read = file truncated mid-record (partial copy,
                # interrupted write) — even crc="none" must name the file
                # rather than die in struct.unpack
                raise ValueError(
                    f"truncated TFRecord {path}: record of {length} bytes "
                    f"cut short at EOF")
            data_crc = struct.unpack("<I", trailer)[0]
            if crc == "full" and _masked_crc(payload) != data_crc:
                raise ValueError(f"corrupt data crc in {path}")
            yield payload


# ---- minimal tf.train.Example wire parsing --------------------------------

def _to_signed64(v: int) -> int:
    """Int64List varints are two's-complement: a negative int64 arrives as
    a 10-byte varint decoding to v + 2^64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:        # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:      # varint
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 5:      # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:      # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(payload: bytes) -> Dict[str, object]:
    """tf.train.Example -> {name: bytes | [int] | [float]}."""
    out: Dict[str, object] = {}
    for field, _, features in _iter_fields(payload):
        if field != 1:       # Example.features
            continue
        for ffield, _, feat_entry in _iter_fields(features):
            if ffield != 1:  # Features.feature (map entry)
                continue
            name, value = None, None
            for kf, _, kv in _iter_fields(feat_entry):
                if kf == 1:
                    name = kv.decode()
                elif kf == 2:  # Feature
                    for vf, _, vv in _iter_fields(kv):
                        if vf == 1:    # BytesList
                            for bf, _, bv in _iter_fields(vv):
                                if bf == 1:
                                    value = bv
                        elif vf == 2:  # FloatList
                            floats = []
                            for lf, lw, lv in _iter_fields(vv):
                                if lf == 1 and lw == 2:  # packed
                                    floats.extend(np.frombuffer(
                                        lv, "<f4").tolist())
                                elif lf == 1:
                                    floats.append(
                                        struct.unpack("<f", lv)[0])
                            value = floats
                        elif vf == 3:  # Int64List
                            ints = []
                            for lf, lw, lv in _iter_fields(vv):
                                if lf == 1 and lw == 2:  # packed
                                    pos = 0
                                    while pos < len(lv):
                                        v, pos = _read_varint(lv, pos)
                                        ints.append(_to_signed64(v))
                                elif lf == 1:
                                    ints.append(_to_signed64(lv))
                            value = ints
            if name is not None:
                out[name] = value
    return out


def load_gait_tfrecord(path: str, all_info: bool = False):
    """mj_loadSingleGaitOFTFrecord parity: returns (data, label, videoId) or
    the full parsed dict with all_info=True. data: float32 (N, 50, 60, 60)
    = int16 raw / 100."""
    first = next(iter_tfrecords(path), None)   # files hold ONE example;
    if first is None:                          # don't buffer any extras
        raise ValueError(f"empty TFRecord {path}")
    ex = parse_example(first)
    raw = np.frombuffer(ex["data"], np.int16)
    data = raw.astype(np.float32).reshape(-1, 50, 60, 60) / 100.0
    if all_info:
        ex = dict(ex)
        ex["data"] = data
        return ex
    label = int(ex["labels"][0])
    vid = int(ex["videoId"][0]) if "videoId" in ex else 0
    return data, label, vid
