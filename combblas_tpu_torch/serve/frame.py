"""Transport-agnostic length-prefixed JSON+binary frame codec;
counterpart of ``combblas_tpu/serve/frame.py``, the same wire format
byte for byte.

ONE implementation serves the process fleet's parent<->child
``socketpair`` channels (``serve/procfleet.py``) and the network front
door's TCP connections (``serve/net/``).  Every frame is::

    [4B total_len] [4B header_len] [header JSON] [binary blobs]

Framing means a reader can never consume half a message; a peer that
dies mid-frame produces a clean ``ChannelClosed`` on the next read,
never a poisoned stream — the on-disk analog is the WAL's
torn-final-line tolerance.

The header is one UTF-8 JSON object (debuggable, pickle-free — a
peer crash can corrupt its own heap, not ours).  Numpy arrays do NOT
ride as JSON lists: :func:`encode` hoists them into the frame's binary
section as raw contiguous bytes and leaves an
``{"__ndb__": dtype, "shape": [...], "off": n, "nbytes": n}``
envelope in the header; :func:`decode` rebuilds them with
``np.frombuffer`` — a memcpy, not a float-parse.  That keeps a
pagerank reply (one n-vector per query) at wire cost ~= its array
bytes, which is what lets the serving read path stay exec-bound
instead of serialization-bound.  Round 21 adds one typed envelope on
top: :class:`SparseFrontier` rides as ``__spf__`` (dtype-minimized
frontier triples — the sharded hop protocol's sparse wire encoding)
and :func:`pack_bf16`/:func:`unpack_bf16` give dense payloads an
opt-in half-width float codec with no dtype-string dependency.

Big payloads (graph versions) still NEVER ride a channel: they travel
as ``save_version`` checkpoint files on disk and the message carries
the path (``swap_from_checkpoint``), so the wire layer stays
latency-bound, not bandwidth-bound.

The obs accounting series keep their round-18 ``serve.ipc.*`` names
(``serve.ipc.bytes_out/bytes_in/encode_s/decode_s``, labeled by
``peer``) for BOTH transports — one codec, one set of dashboards;
net-specific totals (``serve.net.bytes_in/bytes_out``) are derived by
the frontend from the per-channel byte counters below.

Deviations from the reference, kept on purpose (the bytes on the wire
are the same):

* The receiver grows its partial frame in a ``bytearray`` and asks the
  socket for the rest of a frame in chunks of up to 1 MB: the
  reference's ``bytes``
  concatenation copies the partial frame on every 64 KB chunk,
  quadratic in a bfs reply's ~12 MB of levels and parents at scale 20.
* A ``torch.Tensor`` in a message is hoisted as an ``__ndb__`` array
  through one host transfer (``.detach().cpu()``); a tensor of a dtype
  numpy lacks (bfloat16) raises ``TypeError`` instead of riding the
  reference's fallback, which would send a CUDA tensor as its ``repr``
  string. Any other object that numpy holds only as an object array is
  sent as its ``repr``, as the reference means to: object arrays have
  no wire bytes.
"""

from __future__ import annotations

import json
import select
import socket
import struct
import threading
import time

import numpy as np
import torch

from .. import obs

#: Hard cap on one frame — a corrupt length prefix must not allocate
#: gigabytes; real messages are query results (KBs).
MAX_FRAME = 64 << 20
# sender-side no-progress deadline (see Channel._send_frame): a peer
# that drains NOTHING for this long is wedged, not slow.  Generous on
# purpose — boot-sized frames to a child that is still importing its
# JAX runtime on a loaded single-core box legitimately stall for tens
# of seconds; liveness policing belongs to heartbeats, not the wire.
SEND_TIMEOUT_S = 300.0


class ChannelClosed(ConnectionError):
    """The peer closed (or broke) the socket — for a replica channel
    this is crash detection, handled by quarantine + respawn; for a
    net connection it is client disconnect, handled by connection
    cleanup (in-flight replies are dropped, never stranded)."""


class SparseFrontier:
    """Typed sparse-frontier wire payload (round 21): the live COO
    triples of a logically-dense ``[n, width]`` hop operand.

    The sharded hop protocol (``serve/shard.py``) ships O(frontier)
    triples instead of the O(n*W) dense state — the CombBLAS SpMSpV
    stance applied at the wire.  Encoded as a first-class ``__spf__``
    header envelope so both sides get the TYPE back, not a bag of
    arrays; dtypes are wire-minimized: rows ``int32``, lanes ``uint8``
    (batch widths are <= 256 by serve-config construction), values
    ``float32`` or absent entirely (a bfs frontier's values ARE its
    row ids).
    """

    __slots__ = ("n", "width", "rows", "lanes", "vals")

    def __init__(self, n: int, width: int, rows, lanes, vals=None):
        self.n = int(n)
        self.width = int(width)
        if not (1 <= self.width <= 256):
            raise ValueError(
                f"SparseFrontier width must be in [1, 256] (lanes "
                f"ride uint8); got {self.width}"
            )
        self.rows = np.ascontiguousarray(rows, np.int32)
        self.lanes = np.ascontiguousarray(lanes, np.uint8)
        self.vals = (None if vals is None
                     else np.ascontiguousarray(vals, np.float32))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def nbytes(self) -> int:
        """Logical wire bytes of the triple arrays (the router's
        hop-payload accounting surface)."""
        t = self.rows.nbytes + self.lanes.nbytes
        return t + (0 if self.vals is None else self.vals.nbytes)

    def to_dense(self, fill, dtype=None) -> np.ndarray:
        """Host-side scatter into the dense ``[n, width]`` array the
        triples describe: ``fill`` everywhere, ``vals`` (or the row
        ids when vals is None) at the triples."""
        dt = np.dtype(dtype) if dtype is not None \
            else np.asarray(fill).dtype
        out = np.full((self.n, self.width), fill, dt)
        out[self.rows, self.lanes.astype(np.int64)] = (
            self.rows if self.vals is None else self.vals
        )
        return out


def pack_bf16(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16-on-the-wire as raw uint16 (round-to-nearest-
    even via the carry-in bias trick), dependency-free — no ml_dtypes
    on the wire, so both peers agree on the codec by construction."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u >> np.uint32(16)).astype(np.uint16)


def unpack_bf16(u: np.ndarray) -> np.ndarray:
    """The decode half of :func:`pack_bf16`: uint16 -> float32 by
    reinstating the truncated mantissa bits as zeros."""
    w = np.ascontiguousarray(u, np.uint16).astype(np.uint32)
    return (w << np.uint32(16)).view(np.float32)


def _headerable(obj, blobs: list):
    """JSON-safe header view of ``obj``: ndarrays hoist their bytes
    into ``blobs`` and leave an ``__ndb__`` envelope; numpy scalars
    become Python scalars."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        off = sum(len(b) for b in blobs)
        blobs.append(a.tobytes())
        return {
            "__ndb__": a.dtype.str,
            "shape": list(a.shape),
            "off": off,
            "nbytes": a.nbytes,
        }
    if isinstance(obj, SparseFrontier):
        return {"__spf__": {
            "n": obj.n, "width": obj.width,
            "rows": _headerable(obj.rows, blobs),
            "lanes": _headerable(obj.lanes, blobs),
            "vals": (None if obj.vals is None
                     else _headerable(obj.vals, blobs)),
        }}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, dict):
        return {str(k): _headerable(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_headerable(v, blobs) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        # device tensors: one host transfer (module docstring)
        t = obj.detach().cpu()
        try:
            a = t.numpy()
        except TypeError as e:
            raise TypeError(
                f"a {t.dtype} tensor has no numpy dtype to ride the "
                "wire as; convert it before sending"
            ) from e
        return _headerable(a, blobs)
    # anything else array-like
    try:
        a = np.asarray(obj)
    except Exception:
        return repr(obj)
    if a.dtype.hasobject:
        return repr(obj)
    return _headerable(a, blobs)


def encode(obj) -> bytes:
    """One frame body: ``[4B header_len][header][blobs]``."""
    blobs: list = []
    head = json.dumps(
        _headerable(obj, blobs), separators=(",", ":")
    ).encode("utf-8")
    return b"".join([struct.pack(">I", len(head)), head, *blobs])


def decode(data: bytes) -> dict:
    (hl,) = struct.unpack(">I", data[:4])
    head = json.loads(data[4:4 + hl].decode("utf-8"))
    binary = memoryview(data)[4 + hl:]
    return _denumpy(head, binary)


def _denumpy(obj, binary):
    if isinstance(obj, dict):
        if "__ndb__" in obj:
            off, nb = int(obj["off"]), int(obj["nbytes"])
            return np.frombuffer(
                binary[off:off + nb], dtype=np.dtype(obj["__ndb__"])
            ).reshape(obj["shape"]).copy()  # own the memory: the
            # frame buffer is released after decode
        if "__spf__" in obj:
            m = obj["__spf__"]
            vals = m.get("vals")
            return SparseFrontier(
                int(m["n"]), int(m["width"]),
                _denumpy(m["rows"], binary),
                _denumpy(m["lanes"], binary),
                None if vals is None else _denumpy(vals, binary),
            )
        return {k: _denumpy(v, binary) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_denumpy(v, binary) for v in obj]
    return obj


class Channel:
    """One framed JSON duplex channel over a connected socket.

    ``send`` is thread-safe (the reply path and the heartbeat thread
    share the child's channel; the router's request path and its
    supervisor share the parent's; the frontend's reply callbacks
    share a connection's) and returns the wire length of the frame it
    wrote.  ``recv`` is single-reader by design — each side owns
    exactly one reader thread/loop.

    ``peer`` labels the round-18 channel accounting series
    (``serve.ipc.bytes_out/bytes_in/encode_s/decode_s``) so the
    isolation tax is attributable per peer class; obs disabled costs
    one attribute read per frame.  ``bytes_out``/``bytes_in`` integer
    totals are maintained unconditionally (plain int adds) so
    transports can derive their own byte series without a second
    count at this layer.
    """

    def __init__(self, sock: socket.socket, peer: str | None = None):
        self._sock = sock
        self._lab = {"peer": peer} if peer else {}
        self._wlock = threading.Lock()
        self._closed = False
        # wire totals including the 4B length prefix; bytes_in only
        # advances on whole decoded frames (the single reader may hold
        # a partial frame in _rbuf — not yet a message, not counted)
        self.bytes_out = 0
        self.bytes_in = 0
        # partial-frame accumulator: a recv() that times out MID-FRAME
        # keeps what it read here, so the next call resumes the same
        # frame instead of desyncing (a slow peer mid-sendall — GIL
        # stall, compile, SIGSTOP+SIGCONT — is a late frame, not a
        # broken stream). A bytearray grows in place: appending each
        # chunk to immutable bytes copied the whole partial frame every
        # time, quadratic in a multi-megabyte reply
        self._rbuf = bytearray()

    def send(self, obj: dict) -> int:
        if obs.ENABLED:
            t0 = time.perf_counter()
            data = encode(obj)
            obs.observe(
                "serve.ipc.encode_s", time.perf_counter() - t0, **self._lab
            )
            obs.count("serve.ipc.bytes_out", len(data) + 4, **self._lab)
        else:
            data = encode(obj)
        if len(data) > MAX_FRAME:
            raise ValueError(
                f"ipc frame too large ({len(data)} bytes); ship big "
                "payloads as checkpoint files, not messages"
            )
        frame = struct.pack(">I", len(data)) + data
        with self._wlock:
            if self._closed:
                raise ChannelClosed("channel closed")
            try:
                self._send_frame(frame)
            except (OSError, ValueError) as e:
                raise ChannelClosed(f"peer gone: {e}") from e
            self.bytes_out += len(frame)
        return len(frame)

    def _send_frame(self, frame: bytes) -> None:
        # NOT ``sendall``: ``settimeout`` is socket-GLOBAL, so a
        # concurrent reader polling ``recv`` with a short tick would
        # impose that tick on the whole sendall — and any frame larger
        # than the kernel socket buffer headed to a busy peer (a boot
        # payload to a child still importing its runtime, a dense hop
        # slab mid-compile) would spuriously "time out".  Chunked
        # select+send keeps partial progress across ticks and only
        # gives up after SEND_TIMEOUT_S of ZERO forward progress — a
        # genuinely wedged peer, not a slow one.
        view = memoryview(frame)
        stalled_since = time.monotonic()
        while view:
            _, writable, _ = select.select([], [self._sock], [], 1.0)
            n = 0
            if writable:
                try:
                    n = self._sock.send(view)
                except (socket.timeout, BlockingIOError,
                        InterruptedError):
                    n = 0
            if n:
                view = view[n:]
                stalled_since = time.monotonic()
            elif time.monotonic() - stalled_since > SEND_TIMEOUT_S:
                raise OSError(
                    f"send stalled > {SEND_TIMEOUT_S:g}s "
                    f"({len(view)} bytes undrained)"
                )

    def recv(self, timeout: float | None = None) -> dict:
        """One message; ``socket.timeout`` when a whole frame has not
        arrived within ``timeout`` (the reader loop's poll tick —
        partial bytes are RETAINED, so a timeout can never desync the
        framing), ``ChannelClosed`` on EOF/reset/corrupt prefix."""
        self._sock.settimeout(timeout)
        while True:
            need = 1 << 16
            if len(self._rbuf) >= 4:
                (n,) = struct.unpack(">I", self._rbuf[:4])
                if n > MAX_FRAME:
                    raise ChannelClosed(f"oversized frame ({n} bytes)")
                if len(self._rbuf) >= 4 + n:
                    with memoryview(self._rbuf) as mv:
                        data = bytes(mv[4:4 + n])  # one copy
                    del self._rbuf[:4 + n]
                    self.bytes_in += n + 4
                    if obs.ENABLED:
                        t0 = time.perf_counter()
                        msg = decode(data)
                        obs.observe(
                            "serve.ipc.decode_s",
                            time.perf_counter() - t0,
                            **self._lab,
                        )
                        obs.count(
                            "serve.ipc.bytes_in", len(data) + 4, **self._lab
                        )
                        return msg
                    return decode(data)
                # the rest of this frame, in chunks of up to 1 MB
                need = min(max(need, 4 + n - len(self._rbuf)), 1 << 20)
            try:
                c = self._sock.recv(need)
            except socket.timeout:
                raise  # partial frame stays buffered for the next call
            except (OSError, ValueError) as e:
                raise ChannelClosed(f"peer gone: {e}") from e
            if not c:
                raise ChannelClosed("peer closed the channel")
            self._rbuf += c

    def close(self) -> None:
        with self._wlock:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
