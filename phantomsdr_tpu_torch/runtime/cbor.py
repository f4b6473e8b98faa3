"""Minimal CBOR encoder, wire-compatible with nlohmann::json::to_cbor
as used by the reference packet builders (reference: src/audio.cpp:26-36
audio packets {data, frame_num, l, m, pwr, r}; src/waterfallcompression.cpp
:24-37 waterfall packets {data, frame_num, l, r}).

nlohmann stores objects as std::map -> keys serialize in lexicographic
order, integers use minimal-length encodings, doubles are 64-bit
(major 7, 0xFB), binary is a CBOR byte string.  Only the types those
packets need are implemented.
"""

from __future__ import annotations

import struct


def _head(major: int, val: int) -> bytes:
    mb = major << 5
    if val < 24:
        return bytes([mb | val])
    if val < 1 << 8:
        return bytes([mb | 24, val])
    if val < 1 << 16:
        return struct.pack(">BH", mb | 25, val)
    if val < 1 << 32:
        return struct.pack(">BI", mb | 26, val)
    return struct.pack(">BQ", mb | 27, val)


def encode(obj) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc(obj, out: bytearray) -> None:
    if isinstance(obj, bool):
        out.append(0xF5 if obj else 0xF4)
    elif isinstance(obj, int):
        if obj >= 0:
            out += _head(0, obj)
        else:
            out += _head(1, -1 - obj)
    elif isinstance(obj, float):
        out += b"\xfb" + struct.pack(">d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out += _head(2, len(b)) + b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += _head(3, len(b)) + b
    elif isinstance(obj, (list, tuple)):
        out += _head(4, len(obj))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out += _head(5, len(obj))
        for k in sorted(obj.keys()):  # nlohmann::json object = sorted map
            _enc(k, out)
            _enc(obj[k], out)
    elif obj is None:
        out.append(0xF6)
    else:
        raise TypeError(f"CBOR: unsupported type {type(obj)}")


def audio_packet(frame_num: int, l: int, m: float, r: int, pwr: float,
                 data: bytes) -> bytes:
    """The audio CBOR packet (src/audio.cpp:17-36)."""
    return encode({
        "frame_num": frame_num, "l": l, "m": float(m), "r": r,
        "pwr": float(pwr), "data": data,
    })


def waterfall_packet(frame_num: int, l: int, r: int, data: bytes) -> bytes:
    """The waterfall CBOR packet (src/waterfallcompression.cpp:13-29)."""
    return encode({"frame_num": frame_num, "l": l, "r": r, "data": data})
