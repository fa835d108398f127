"""TCP transport: length-prefixed framing and the versioned Message codec,
the reference's ``ZV`` v1 wire byte for byte (its runtime/transport.py
has the full notes):

  frame    := u32 body_len | u8 frame_type | body
  MESSAGE  := MAGIC 'ZV' | u8 version | u8 kind_index | str sender |
              str receiver | i64 round | i64 nbytes | tree payload |
              tree meta
  CONTROL  := utf-8 JSON object (hello/welcome/ping/pong/bye)

``tree`` is a tagged encoding of the payloads the protocol ships: 'a'
ndarray (dtype name + shape + raw C-order bytes), 'f' one big-endian f32
(every scalar function value on the wire), 'i' i64, 't'/'l' tuple/list,
'd' dict of (key, subtree), 'n' None.

The codec is strict about accounting: while serializing it counts the
payload bytes that hit the socket (array raw bytes, 4 per scalar) and
refuses a frame whose count disagrees with the Message's declared
``nbytes``; decoding counts and checks again.

bfloat16: the port's host payloads carry bf16 values as their uint16 bit
patterns (numpy has no bfloat16; ``core/exchange.to_host``), and the
protocol ships no other uint16. So a uint16 array goes on the wire under
the dtype name ``bfloat16``, as the reference's ml_dtypes arrays do, and
a ``bfloat16`` array read off the wire comes back as uint16 patterns:
the same bytes, with no ml_dtypes.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np

from repro_torch.core.wire import KINDS, Message

WIRE_MAGIC = b"ZV"
WIRE_VERSION = 1

FRAME_MESSAGE = 0
FRAME_CONTROL = 1

SCALAR_FMT = ">f"                 # protocol scalars are big-endian f32

_u8 = struct.Struct(">B")
_u32 = struct.Struct(">I")
_i64 = struct.Struct(">q")
_f32 = struct.Struct(SCALAR_FMT)

_MAX_FRAME = 1 << 30              # sanity cap: 1 GiB per message


class TransportError(RuntimeError):
    """Base class for every failure at the socket boundary."""


class ConnectionClosed(TransportError):
    """The peer closed the connection (EOF mid-protocol)."""


class TransportTimeout(TransportError):
    """A per-request timeout expired waiting for the peer."""


class WireFormatError(TransportError):
    """A frame violated the versioned wire format (bad magic/version,
    unknown tag, or payload bytes disagreeing with declared nbytes)."""


BF16_NAME = "bfloat16"


def _dtype_name(arr: np.ndarray) -> str:
    """The wire's dtype name of ``arr``: uint16 patterns are bf16."""
    return BF16_NAME if arr.dtype == np.uint16 else arr.dtype.name


def _dtype_from_name(name: str) -> np.dtype:
    if name == BF16_NAME:
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError:
        raise WireFormatError(f"unknown wire dtype {name!r}") from None


def _put_str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    out.append(_u32.pack(len(b)))
    out.append(b)


class _Reader:
    """Cursor over one received frame body."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise WireFormatError("truncated frame")
        mv = self.buf[self.pos:self.pos + n]
        self.pos += n
        return mv

    def u8(self) -> int:
        return _u8.unpack(self.take(1))[0]

    def u32(self) -> int:
        return _u32.unpack(self.take(4))[0]

    def i64(self) -> int:
        return _i64.unpack(self.take(8))[0]

    def string(self) -> str:
        return bytes(self.take(self.u32())).decode("utf-8")


# ------------------------------------------------------------- tree codec --

def _encode_tree(obj, out: list) -> int:
    """Append the tagged encoding of ``obj``; return the PAYLOAD byte
    count (array raw bytes + 4 per scalar function value — the same
    quantity ``exchange.wire_nbytes`` measures; tags, dtype names and
    shape words are framing overhead, like TCP headers)."""
    if obj is None:
        out.append(b"n")
        return 0
    if isinstance(obj, bool):
        raise WireFormatError("bool payloads are not part of the protocol")
    if isinstance(obj, (float, np.floating)):
        out.append(b"f")
        out.append(_f32.pack(float(obj)))
        return 4
    if isinstance(obj, (int, np.integer)):
        out.append(b"i")
        out.append(_i64.pack(int(obj)))
        return 0
    if isinstance(obj, (tuple, list)):
        out.append(b"t" if isinstance(obj, tuple) else b"l")
        out.append(_u32.pack(len(obj)))
        return sum(_encode_tree(x, out) for x in obj)
    if isinstance(obj, dict):
        out.append(b"d")
        out.append(_u32.pack(len(obj)))
        n = 0
        for k, v in obj.items():
            _put_str(out, str(k))
            n += _encode_tree(v, out)
        return n
    arr = np.ascontiguousarray(np.asarray(obj))
    out.append(b"a")
    _put_str(out, _dtype_name(arr))
    out.append(_u8.pack(arr.ndim))
    for dim in arr.shape:
        out.append(_i64.pack(dim))
    raw = arr.tobytes()
    out.append(_u32.pack(len(raw)))
    out.append(raw)
    return len(raw)


def _decode_tree(r: _Reader):
    """Inverse of :func:`_encode_tree`; returns (obj, payload_bytes)."""
    tag = bytes(r.take(1))
    if tag == b"n":
        return None, 0
    if tag == b"f":
        return float(_f32.unpack(r.take(4))[0]), 4
    if tag == b"i":
        return r.i64(), 0
    if tag in (b"t", b"l"):
        count = r.u32()
        items, n = [], 0
        for _ in range(count):
            x, nx = _decode_tree(r)
            items.append(x)
            n += nx
        return (tuple(items) if tag == b"t" else items), n
    if tag == b"d":
        count = r.u32()
        d, n = {}, 0
        for _ in range(count):
            k = r.string()
            v, nv = _decode_tree(r)
            d[k] = v
            n += nv
        return d, n
    if tag == b"a":
        dtype = _dtype_from_name(r.string())
        ndim = r.u8()
        shape = tuple(r.i64() for _ in range(ndim))
        raw = r.take(r.u32())
        # a writable copy: receivers hand payloads to torch.from_numpy
        arr = np.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
        return arr, arr.nbytes
    raise WireFormatError(f"unknown tree tag {tag!r}")


# ---------------------------------------------------------- message codec --

def encode_message(msg: Message) -> bytes:
    """Serialize one protocol Message, validating that the payload bytes
    actually emitted equal the message's declared (measured) nbytes."""
    if msg.kind not in KINDS:
        raise WireFormatError(f"unknown message kind {msg.kind!r}")
    out: list = [WIRE_MAGIC, _u8.pack(WIRE_VERSION),
                 _u8.pack(KINDS.index(msg.kind))]
    _put_str(out, msg.sender)
    _put_str(out, msg.receiver)
    out.append(_i64.pack(msg.round))
    out.append(_i64.pack(msg.nbytes))
    payload_bytes = _encode_tree(msg.payload, out)
    if payload_bytes != msg.nbytes:
        raise WireFormatError(
            f"{msg.kind} {msg.sender}->{msg.receiver} r{msg.round}: "
            f"declared nbytes={msg.nbytes} but {payload_bytes} payload "
            f"bytes would hit the socket")
    _encode_tree(msg.meta, out)
    return b"".join(out)


def decode_message(body) -> Message:
    r = _Reader(memoryview(body))
    if bytes(r.take(2)) != WIRE_MAGIC:
        raise WireFormatError("bad magic: not a ZV message frame")
    version = r.u8()
    if version != WIRE_VERSION:
        raise WireFormatError(f"wire version {version} != {WIRE_VERSION}")
    kind = KINDS[r.u8()]
    sender = r.string()
    receiver = r.string()
    rnd = r.i64()
    nbytes = r.i64()
    payload, payload_bytes = _decode_tree(r)
    meta, _ = _decode_tree(r)
    if payload_bytes != nbytes:
        raise WireFormatError(
            f"{kind} r{rnd}: frame declares nbytes={nbytes} but carries "
            f"{payload_bytes} payload bytes")
    return Message(kind, sender, receiver, rnd, payload, nbytes, meta)


# ---------------------------------------------------------------- framing --

class FramedSocket:
    """Length-prefixed framing over one TCP connection, with write
    serialization (pong replies and protocol replies may come from
    different threads) and measured socket-byte counters."""

    def __init__(self, sock: socket.socket):
        try:
            # the protocol is request/reply with tiny frames — Nagle
            # delays hurt; not applicable to AF_UNIX test sockets
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.sock = sock
        self.bytes_out = 0
        self.bytes_in = 0
        self._wlock = threading.Lock()
        # bytes of a partially-received frame survive a timeout here, so
        # a caller may retry recv() without desynchronizing the stream
        self._rbuf = bytearray()

    # -- send ---------------------------------------------------------------
    def _send(self, frame_type: int, body: bytes) -> None:
        frame = _u32.pack(len(body) + 1) + _u8.pack(frame_type) + body
        with self._wlock:
            try:
                self.sock.sendall(frame)
            except OSError as e:
                raise ConnectionClosed(f"send failed: {e}") from e
            self.bytes_out += len(frame)

    def send_message(self, msg: Message) -> int:
        body = encode_message(msg)
        self._send(FRAME_MESSAGE, body)
        return len(body) + 5

    def send_control(self, obj: dict) -> None:
        self._send(FRAME_CONTROL, json.dumps(obj).encode("utf-8"))

    # -- recv ---------------------------------------------------------------
    def _fill(self, n: int) -> None:
        """Grow the receive buffer to >= n bytes. On timeout the bytes
        already buffered are KEPT — a retried recv() resumes the same
        frame instead of misreading mid-frame payload as a length."""
        while len(self._rbuf) < n:
            try:
                chunk = self.sock.recv(65536)
            except socket.timeout as e:
                raise TransportTimeout("recv timed out") from e
            except OSError as e:
                raise ConnectionClosed(f"recv failed: {e}") from e
            if not chunk:
                raise ConnectionClosed("peer closed the connection")
            self._rbuf += chunk
            self.bytes_in += len(chunk)

    def recv(self, timeout: float | None = None):
        """Next frame as ('msg', Message) or ('ctl', dict)."""
        self.sock.settimeout(timeout)
        self._fill(4)
        size = _u32.unpack(bytes(self._rbuf[:4]))[0]
        if not 1 <= size <= _MAX_FRAME:
            raise WireFormatError(f"implausible frame size {size}")
        self._fill(4 + size)
        body = bytes(self._rbuf[4:4 + size])
        del self._rbuf[:4 + size]
        frame_type = body[0]
        if frame_type == FRAME_MESSAGE:
            return "msg", decode_message(body[1:])
        if frame_type == FRAME_CONTROL:
            return "ctl", json.loads(body[1:].decode("utf-8"))
        raise WireFormatError(f"unknown frame type {frame_type}")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect_with_retry(host: str, port: int, retries: int = 40,
                       backoff_s: float = 0.25) -> FramedSocket:
    """Dial the server with bounded retry — a party may come up (or
    rejoin) before the server listens, or while it is busy accepting."""
    last: Exception | None = None
    for _ in range(max(1, retries)):
        try:
            return FramedSocket(socket.create_connection((host, port),
                                                         timeout=10.0))
        except OSError as e:
            last = e
            time.sleep(backoff_s)
    raise TransportError(
        f"could not connect to {host}:{port} after {retries} attempts: "
        f"{last}")
