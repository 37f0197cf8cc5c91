"""Wire transports for :mod:`repro_torch.dist` — how stage tensors move.

Both transports share **one codec**: a length-prefixed frame carrying a
strict-JSON header (message kind, frame ids, tensor dtype/shape specs,
metadata) followed by the raw tensor bytes::

    u64 frame_len | b"PICO" | u32 header_len | header JSON | tensor bytes

The in-memory transport passes the *encoded bytes* through a queue pair
rather than the Python objects, so the memory and TCP paths exercise
the identical serialization — results are byte-identical by
construction, and a test can assert it.  Sends are chunked
(``chunk_bytes``) with per-link byte counters and send-latency
histograms published to ``repro_torch.obs``
(``dist.link.bytes_sent`` / ``dist.link.bytes_recv`` /
``dist.link.send_s``).

Messages are plain data (:class:`Message`): ``kind`` is the protocol
verb (``frame``/``result``/``stop``/``hello``/``ready``/``heartbeat``/
``stats``/``die``/``wire``), ``fids`` the frame ids a data message
carries (len > 1 = micro-batch with a leading frame axis), ``tensors``
named ndarrays, ``meta`` a JSON-safe dict.

A copy of the JAX package's ``dist/transport.py``: the codec is the
same byte for byte, so either package decodes the other's frames.
Tensors cross as numpy arrays; :func:`decode` returns read-only views
into the message bytes.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import time
from dataclasses import dataclass, field

import numpy as np

from ..obs import metrics as obs_metrics

MAGIC = b"PICO"
_LEN = struct.Struct("<Q")
_HLEN = struct.Struct("<I")

#: Message kinds understood by the launcher/worker protocol.
KINDS = ("frame", "result", "stop", "hello", "ready", "heartbeat",
         "stats", "die", "wire", "error")


@dataclass
class Message:
    """One protocol message: verb + frame ids + named tensors + meta."""

    kind: str
    fids: list[int] = field(default_factory=list)
    tensors: dict[str, np.ndarray] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)


def encode(msg: Message) -> bytes:
    """Message -> one framed byte string (header JSON + tensor bytes)."""
    specs, blobs = [], []
    for name, arr in msg.tensors.items():
        a = np.asarray(arr)
        if not a.flags["C_CONTIGUOUS"]:
            # NOT ascontiguousarray: that promotes 0-d arrays to 1-d,
            # silently changing the tensor's shape on the wire
            a = np.ascontiguousarray(a).reshape(a.shape)
        specs.append({"name": name, "dtype": str(a.dtype),
                      "shape": list(a.shape)})
        blobs.append(a.tobytes())
    header = json.dumps({"kind": msg.kind, "fids": list(msg.fids),
                         "meta": msg.meta, "tensors": specs},
                        sort_keys=True).encode()
    body = MAGIC + _HLEN.pack(len(header)) + header + b"".join(blobs)
    return _LEN.pack(len(body)) + body


def decode(body: bytes) -> Message:
    """Inverse of :func:`encode` (body excludes the u64 length prefix)."""
    if body[:4] != MAGIC:
        raise ValueError(f"bad frame magic {body[:4]!r}")
    hlen, = _HLEN.unpack_from(body, 4)
    header = json.loads(body[8:8 + hlen].decode())
    off = 8 + hlen
    tensors = {}
    for spec in header["tensors"]:
        dt = np.dtype(spec["dtype"])
        n = int(np.prod(spec["shape"], dtype=np.int64)) if spec["shape"] \
            else 1
        nbytes = n * dt.itemsize
        tensors[spec["name"]] = np.frombuffer(
            body[off:off + nbytes], dtype=dt).reshape(spec["shape"])
        off += nbytes
    if off != len(body):
        raise ValueError(f"frame length mismatch: consumed {off} of "
                         f"{len(body)} bytes")
    return Message(header["kind"], list(header["fids"]), tensors,
                   header["meta"])


class Transport:
    """One directed link endpoint.  Concrete transports implement
    ``_send_bytes``/``_recv_bytes``; accounting and the codec are
    shared here."""

    def __init__(self, link: str = "link", chunk_bytes: int = 1 << 20,
                 metrics=None):
        self.link = link
        self.chunk_bytes = int(chunk_bytes)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.sends = 0
        self.recvs = 0
        self.send_s = 0.0
        self._metrics = (metrics if metrics is not None
                         else obs_metrics.default_registry())

    # -- public API ------------------------------------------------------
    def send(self, msg: Message) -> int:
        """Encode and ship one message; returns bytes put on the wire."""
        wire = encode(msg)
        t0 = time.perf_counter()
        self._send_bytes(wire)
        dt = time.perf_counter() - t0
        self.bytes_sent += len(wire)
        self.sends += 1
        self.send_s += dt
        self._metrics.counter("dist.link.bytes_sent", link=self.link).inc(
            len(wire))
        self._metrics.histogram("dist.link.send_s", link=self.link).observe(
            dt)
        return len(wire)

    def recv(self, timeout: float | None = None) -> Message | None:
        """Next message, or ``None`` on timeout.  A timeout never
        corrupts framing: partially received frames are buffered and
        completed by the next call."""
        body = self._recv_bytes(timeout)
        if body is None:
            return None
        self.bytes_recv += len(body) + _LEN.size
        self.recvs += 1
        self._metrics.counter("dist.link.bytes_recv", link=self.link).inc(
            len(body) + _LEN.size)
        return decode(body)

    def close(self) -> None:  # pragma: no cover - overridden
        pass

    # -- to implement ----------------------------------------------------
    def _send_bytes(self, wire: bytes) -> None:
        raise NotImplementedError

    def _recv_bytes(self, timeout: float | None) -> bytes | None:
        raise NotImplementedError


class MemoryTransport(Transport):
    """Queue-backed link endpoint carrying *encoded* frames, so the
    in-memory path shares the TCP codec byte-for-byte.  One queue is a
    directed link: build both ends with :func:`memory_pair`."""

    def __init__(self, q: "queue.Queue[bytes]", link: str = "mem",
                 chunk_bytes: int = 1 << 20, metrics=None):
        super().__init__(link=link, chunk_bytes=chunk_bytes, metrics=metrics)
        self._q = q
        self._closed = False

    def _send_bytes(self, wire: bytes) -> None:
        if self._closed:
            raise ConnectionError(f"link {self.link} is closed")
        # chunked like TCP so per-chunk accounting matches; the receiver
        # end reassembles from the length prefix
        for off in range(0, len(wire), self.chunk_bytes):
            self._q.put(wire[off:off + self.chunk_bytes])

    def _recv_bytes(self, timeout: float | None) -> bytes | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        buf = getattr(self, "_buf", b"")
        while True:
            if len(buf) >= _LEN.size:
                total, = _LEN.unpack_from(buf)
                if len(buf) >= _LEN.size + total:
                    body = buf[_LEN.size:_LEN.size + total]
                    self._buf = buf[_LEN.size + total:]
                    return body
            try:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                chunk = self._q.get(timeout=remaining)
            except queue.Empty:
                self._buf = buf
                return None
            if chunk is None:           # close sentinel
                self._buf = buf
                raise ConnectionError(f"link {self.link} closed by peer")
            buf += chunk

    def close(self) -> None:
        self._closed = True
        self._q.put(None)


def memory_pair(link: str = "mem", chunk_bytes: int = 1 << 20,
                metrics=None) -> tuple[MemoryTransport, MemoryTransport]:
    """(sender, receiver) endpoints over one directed in-memory link."""
    q: "queue.Queue[bytes]" = queue.Queue()
    return (MemoryTransport(q, link=link, chunk_bytes=chunk_bytes,
                            metrics=metrics),
            MemoryTransport(q, link=link, chunk_bytes=chunk_bytes,
                            metrics=metrics))


class TCPTransport(Transport):
    """A connected TCP stream endpoint (length-prefixed frames,
    chunked ``sendall``).  Safe for one sender thread plus one receiver
    thread; a recv timeout leaves any partial frame buffered."""

    def __init__(self, sock: socket.socket, link: str = "tcp",
                 chunk_bytes: int = 1 << 20, metrics=None):
        super().__init__(link=link, chunk_bytes=chunk_bytes, metrics=metrics)
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = b""
        self._want = None        # frame length being accumulated

    @classmethod
    def connect(cls, addr: tuple[str, int], link: str = "tcp",
                chunk_bytes: int = 1 << 20, metrics=None,
                timeout: float = 30.0) -> "TCPTransport":
        """Connect with retry until ``timeout`` (peers race to bind)."""
        deadline = time.monotonic() + timeout
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                sock = socket.create_connection(addr, timeout=timeout)
                return cls(sock, link=link, chunk_bytes=chunk_bytes,
                           metrics=metrics)
            except OSError as e:        # peer not listening yet
                last = e
                time.sleep(0.02)
        raise ConnectionError(f"cannot connect {link} to {addr}: {last}")

    def _send_bytes(self, wire: bytes) -> None:
        for off in range(0, len(wire), self.chunk_bytes):
            self._sock.sendall(wire[off:off + self.chunk_bytes])

    def _recv_bytes(self, timeout: float | None) -> bytes | None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._want is None and len(self._buf) >= _LEN.size:
                self._want, = _LEN.unpack_from(self._buf)
                self._buf = self._buf[_LEN.size:]
            if self._want is not None and len(self._buf) >= self._want:
                body = self._buf[:self._want]
                self._buf = self._buf[self._want:]
                self._want = None
                return body
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            expired = remaining is not None and remaining <= 0
            # timeout 0 degrades to one non-blocking poll, so buffered
            # kernel bytes are still drained before giving up
            self._sock.settimeout(remaining if not expired else 0.0)
            try:
                chunk = self._sock.recv(self.chunk_bytes)
            except (BlockingIOError, socket.timeout, TimeoutError):
                return None
            except OSError as e:
                raise ConnectionError(
                    f"link {self.link} recv failed: {e}") from e
            if not chunk:
                raise ConnectionError(f"link {self.link} closed by peer")
            self._buf += chunk

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TCPListener:
    """Bound listening socket (``port=0`` = ephemeral); accepts peers
    as :class:`TCPTransport` endpoints."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr: tuple[str, int] = self._sock.getsockname()

    @property
    def port(self) -> int:
        return self.addr[1]

    def accept(self, link: str = "tcp", chunk_bytes: int = 1 << 20,
               metrics=None, timeout: float = 30.0) -> TCPTransport:
        self._sock.settimeout(timeout)
        try:
            sock, _ = self._sock.accept()
        except (socket.timeout, TimeoutError):
            raise TimeoutError(f"no peer connected to {self.addr} within "
                               f"{timeout}s") from None
        return TCPTransport(sock, link=link, chunk_bytes=chunk_bytes,
                            metrics=metrics)

    def close(self) -> None:
        self._sock.close()
