"""Python side of the wire protocol (see native/wire.h): the port's own
copy of `nomad_tpu/wire.py`.

The msgpack-compatible wide-form codec in pure Python (`encode`,
`decode`: nil, bool, int64, float64, str32, bin32, array32 and map32,
tags 0xC0-0xDF), the framed-socket helpers (`send_frame`, `recv_frame`
with its 64 MiB cap, `call`) that the bridge service and in-Python
clients use, and `NativeWire`, a ctypes binding over the C++ shim
`native/libnomadwire.so` in the repository root beside this package
(built with `make -C native`).  The pure-Python and native codecs are
byte-identical, and so are this module's and the JAX package's, so
either side of a connection may use any of them.
"""
from __future__ import annotations

import ctypes
import json
import os
import socket
import struct
from typing import Any, Optional, Tuple

MAX_FRAME = 64 << 20

# ---------------------------------------------------------------------------
# pure-Python codec
# ---------------------------------------------------------------------------


def encode(value: Any) -> bytes:
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _encode(value: Any, out: bytearray) -> None:
    if value is None:
        out.append(0xC0)
    elif value is True:
        out.append(0xC3)
    elif value is False:
        out.append(0xC2)
    elif isinstance(value, int):
        out.append(0xD3)
        out += struct.pack(">q", value)
    elif isinstance(value, float):
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        out.append(0xDB)
        out += struct.pack(">I", len(raw))
        out += raw
    elif isinstance(value, (bytes, bytearray)):
        out.append(0xC6)
        out += struct.pack(">I", len(value))
        out += bytes(value)
    elif isinstance(value, (list, tuple)):
        out.append(0xDD)
        out += struct.pack(">I", len(value))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        out.append(0xDF)
        out += struct.pack(">I", len(value))
        for k, v in value.items():
            _encode(str(k), out)
            _encode(v, out)
    else:
        raise TypeError(f"cannot encode {type(value).__name__}")


def decode(data: bytes) -> Any:
    value, offset = _decode(data, 0)
    if offset != len(data):
        raise ValueError("trailing bytes after wire value")
    return value


def _decode(data: bytes, offset: int) -> Tuple[Any, int]:
    tag = data[offset]
    offset += 1
    if tag == 0xC0:
        return None, offset
    if tag == 0xC2:
        return False, offset
    if tag == 0xC3:
        return True, offset
    if tag == 0xD3:
        return struct.unpack_from(">q", data, offset)[0], offset + 8
    if tag == 0xCB:
        return struct.unpack_from(">d", data, offset)[0], offset + 8
    if tag == 0xDB:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        return data[offset : offset + n].decode("utf-8"), offset + n
    if tag == 0xC6:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        return bytes(data[offset : offset + n]), offset + n
    if tag == 0xDD:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        items = []
        for _ in range(n):
            item, offset = _decode(data, offset)
            items.append(item)
        return items, offset
    if tag == 0xDF:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        obj = {}
        for _ in range(n):
            key, offset = _decode(data, offset)
            value, offset = _decode(data, offset)
            obj[key] = value
        return obj, offset
    raise ValueError(f"unknown wire tag 0x{tag:02x}")


# ---------------------------------------------------------------------------
# framed sockets
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise ValueError("frame exceeds sanity cap")
    return _recv_exact(sock, length)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def call(sock: socket.socket, method: str, body: Any) -> Any:
    """One RPC round trip from Python (mirrors nw_call_json)."""
    send_frame(sock, encode([method, body]))
    resp = recv_frame(sock)
    if resp is None:
        raise ConnectionError("connection closed mid-call")
    return decode(resp)


# ---------------------------------------------------------------------------
# native library binding
# ---------------------------------------------------------------------------

_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "libnomadwire.so",
)


class NativeWire:
    """ctypes binding over native/libnomadwire.so."""

    def __init__(self, path: str = _NATIVE_PATH) -> None:
        self.lib = ctypes.CDLL(path)
        self.lib.nw_encode_json.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        self.lib.nw_decode_to_json.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
        ]
        self.lib.nw_call_json.argtypes = [
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
        ]
        self.lib.nw_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self.lib.nw_free.argtypes = [ctypes.c_void_p]
        self.lib.nw_version.restype = ctypes.c_char_p

    @staticmethod
    def available(path: str = _NATIVE_PATH) -> bool:
        return os.path.exists(path)

    def version(self) -> str:
        return self.lib.nw_version().decode()

    def encode_json(self, document: Any) -> bytes:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = self.lib.nw_encode_json(
            json.dumps(document).encode(), ctypes.byref(out),
            ctypes.byref(out_len),
        )
        if rc != 0:
            raise ValueError(f"nw_encode_json failed: {rc}")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self.lib.nw_free(out)

    def decode_json(self, data: bytes) -> Any:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        out = ctypes.c_char_p()
        rc = self.lib.nw_decode_to_json(
            buf, len(data), ctypes.byref(out)
        )
        if rc != 0:
            raise ValueError(f"nw_decode_to_json failed: {rc}")
        try:
            return json.loads(out.value.decode())
        finally:
            self.lib.nw_free(out)

    def connect(self, host: str, port: int) -> int:
        fd = self.lib.nw_connect(host.encode(), port)
        if fd < 0:
            raise ConnectionError(f"nw_connect failed: {fd}")
        return fd

    def close(self, fd: int) -> None:
        self.lib.nw_close(fd)

    def call_json(self, fd: int, method: str, body: Any) -> Any:
        out = ctypes.c_char_p()
        rc = self.lib.nw_call_json(
            fd, method.encode(), json.dumps(body).encode(),
            ctypes.byref(out),
        )
        if rc != 0:
            raise ConnectionError(f"nw_call_json failed: {rc}")
        try:
            return json.loads(out.value.decode())
        finally:
            self.lib.nw_free(out)
