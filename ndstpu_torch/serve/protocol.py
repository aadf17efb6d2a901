"""Serve wire protocol: length-prefixed JSON frames over a stream socket.

A copy of the JAX package's ``ndstpu/serve/protocol.py``: its frames are
byte-identical, so either package's client talks to either's server.

One frame is a 4-byte big-endian payload length followed by that many
bytes of UTF-8 JSON.  Framing (not newline-delimited JSON) so SQL text
may contain anything, and a half-written frame from a killed peer is
detected as a short read, never misparsed.

Requests are JSON objects with an ``op``:

``sql``
    ``{"op": "sql", "id": str, "sql": str, "tenant": str,
    "deadline_s": float?, "name": str?}`` — execute one statement.
    ``name`` routes the result to ``<output_prefix>/<name>`` on the
    server (the power-CLI writer, byte-identical artifacts); without
    it rows materialize server-side and only the row count returns.
``ping`` / ``health`` / ``ready`` / ``stats``
    liveness, full health doc, readiness flag, obs counter snapshot.
``probe``
    ``{"op": "probe", "id": str}`` — the fleet supervisor's
    liveness/readiness verb.  Answered at all times once the listener
    is bound (``bind_early`` servers answer it **before** readiness),
    returning ``{"probe": {"alive", "ready", "draining", "pid",
    "replica_id", "endpoints", "uptime_s", "aot", ...}}``.  Readiness
    flips only after warm-restart replay and the optional
    ``--aot_corpus`` full-corpus precompile complete, so a supervisor
    routing on ``ready`` never sends traffic to a cold replica.
``drain``
    begin graceful drain (lifecycle.py); responds before draining.

Both transports (AF_UNIX and TCP, serve/transport.py) carry these
frames unchanged — parity is byte-level, and ``MAX_FRAME_BYTES`` +
per-connection read timeouts bound what one peer can pin.

Responses carry ``status``: ``ok`` | ``error`` (+``taxonomy``,
``attempts``) | ``overloaded`` (+``retry_after_s``) | ``rejected``
(+``reason``) | ``draining`` — the typed load-shedding contract
clients key their retry policy on (docs/ROBUSTNESS.md).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

# a frame bigger than this is a protocol error, not a request — bounds
# memory per connection before admission control even runs
MAX_FRAME_BYTES = 64 << 20

_LEN = struct.Struct(">I")


class ProtocolError(ValueError):
    """Malformed frame (oversized, truncated mid-frame, non-JSON)."""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def send_msg(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj, default=str).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(payload)} bytes")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """One frame as a dict; None on clean EOF (peer hung up)."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {length} bytes")
    payload = _recv_exact(sock, length)
    if payload is None:
        raise ProtocolError("connection closed between header and payload")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except ValueError as e:
        raise ProtocolError(f"bad JSON frame: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"frame must be a JSON object, got "
                            f"{type(obj).__name__}")
    return obj
