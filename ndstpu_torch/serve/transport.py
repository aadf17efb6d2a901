"""Serve transports: AF_UNIX and TCP endpoints behind one grammar.

A copy of the JAX package's ``ndstpu/serve/transport.py``.

A unix-domain socket alone is fine for one host, useless for a
replicated fleet whose clients and supervisor may not share a
filesystem.  This module is the one place endpoint strings are
parsed, listened on, and connected to; framing stays in
``protocol.py`` (length-prefixed JSON with ``MAX_FRAME_BYTES`` bounds)
so both transports speak byte-identical frames.

Endpoint grammar (accepted everywhere a socket path used to be):

``unix:/path/to.sock`` (or any bare path)
    AF_UNIX stream socket, the default.
``tcp:HOST:PORT`` (or bare ``HOST:PORT`` when HOST has no ``/``)
    TCP stream socket.  ``PORT`` 0 asks the kernel for an ephemeral
    port; the bound listener's real endpoint is recoverable via
    :func:`bound_endpoint`.

Multi-endpoint specs are comma-separated (``unix:/a.sock,tcp:h:9001``)
— the failover list a fleet client rotates through
(serve/client.py) and the listener set a server binds side by side.

Per-connection **read timeouts** bound how long a dead or wedged peer
can pin a reader thread: every accepted/connected socket gets
``settimeout`` from ``NDSTPU_SERVE_READ_TIMEOUT_S`` (default 600 s;
``0`` disables).  A timeout surfaces as ``socket.timeout`` — transient
by ndstpu_torch/faults/taxonomy.py, so client retry loops treat it like any
connection fault.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import List, Optional

READ_TIMEOUT_ENV = "NDSTPU_SERVE_READ_TIMEOUT_S"
DEFAULT_READ_TIMEOUT_S = 600.0


def read_timeout_s() -> Optional[float]:
    """Per-connection read timeout; None disables (env set to 0)."""
    raw = os.environ.get(READ_TIMEOUT_ENV)
    if raw is None:
        return DEFAULT_READ_TIMEOUT_S
    try:
        val = float(raw)
    except ValueError:
        return DEFAULT_READ_TIMEOUT_S
    return val if val > 0 else None


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One parsed serve endpoint: ``unix`` path or ``tcp`` host:port."""

    kind: str                  # "unix" | "tcp"
    path: Optional[str] = None
    host: Optional[str] = None
    port: Optional[int] = None

    @property
    def spec(self) -> str:
        if self.kind == "unix":
            return f"unix:{self.path}"
        return f"tcp:{self.host}:{self.port}"

    def __str__(self) -> str:  # log-friendly
        return self.spec


def parse_endpoint(spec) -> Endpoint:
    """Parse one endpoint spec (an :class:`Endpoint` passes through)."""
    if isinstance(spec, Endpoint):
        return spec
    text = str(spec).strip()
    if not text:
        raise ValueError("empty serve endpoint spec")
    if text.startswith("unix:"):
        return Endpoint("unix", path=text[len("unix:"):])
    if text.startswith("tcp:"):
        rest = text[len("tcp:"):]
        host, sep, port = rest.rpartition(":")
        if not sep or not host:
            raise ValueError(f"tcp endpoint needs tcp:HOST:PORT "
                             f"(got {spec!r})")
        return Endpoint("tcp", host=host, port=int(port))
    # bare string: HOST:PORT when it looks like one, else a unix path
    if ":" in text and "/" not in text:
        host, _, port = text.rpartition(":")
        if port.isdigit():
            return Endpoint("tcp", host=host, port=int(port))
    return Endpoint("unix", path=text)


def parse_endpoints(spec) -> List[Endpoint]:
    """A comma-separated spec (or list of specs) -> endpoint list."""
    if isinstance(spec, (list, tuple)):
        out: List[Endpoint] = []
        for item in spec:
            out.extend(parse_endpoints(item))
        return out
    return [parse_endpoint(p) for p in str(spec).split(",")
            if p.strip()]


def listen(spec, backlog: int = 64) -> socket.socket:
    """Bind + listen on one endpoint; returns the listener socket."""
    ep = parse_endpoint(spec)
    if ep.kind == "unix":
        if os.path.exists(ep.path):
            os.unlink(ep.path)
        d = os.path.dirname(os.path.abspath(ep.path))
        os.makedirs(d, exist_ok=True)
        ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        ls.bind(ep.path)
    else:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((ep.host, ep.port))
    ls.listen(backlog)
    return ls


def bound_endpoint(listener: socket.socket) -> Endpoint:
    """The endpoint a listener actually bound (resolves tcp port 0)."""
    if listener.family == socket.AF_UNIX:
        return Endpoint("unix", path=listener.getsockname())
    host, port = listener.getsockname()[:2]
    return Endpoint("tcp", host=host, port=port)


def connect(spec, connect_timeout_s: Optional[float] = None,
            read_timeout_s_override: Optional[float] = ...
            ) -> socket.socket:
    """Connect to one endpoint.  ``connect_timeout_s`` bounds only the
    connect itself; afterwards the socket carries the per-connection
    read timeout (override with ``read_timeout_s_override``; ``...``
    means use the env default, ``None`` means no timeout)."""
    ep = parse_endpoint(spec)
    if ep.kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        s.settimeout(connect_timeout_s)
        s.connect(ep.path if ep.kind == "unix" else (ep.host, ep.port))
        configure(s, read_timeout_s_override)
    except BaseException:
        s.close()
        raise
    return s


def configure(sock: socket.socket,
              read_timeout_s_override: Optional[float] = ...) -> None:
    """Apply the per-connection read timeout (server accept path and
    client connect path share this)."""
    timeout = read_timeout_s() if read_timeout_s_override is ... \
        else read_timeout_s_override
    sock.settimeout(timeout)
    if sock.family != socket.AF_UNIX:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def pick_free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral TCP port that was free at probe time (fleet smoke
    convenience; production fleets pin ports in the fleet spec)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind((host, 0))
        return s.getsockname()[1]
    finally:
        s.close()
