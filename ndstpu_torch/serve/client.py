"""Reconnect-and-retry client for the query server / serving fleet.

A copy of the JAX package's ``ndstpu/serve/client.py``.

The retry policy mirrors the server's typed shedding contract
(serve/protocol.py):

* **connection faults** (refused / reset / broken pipe / injected
  ``serve.accept`` drops) — reconnect with deterministic backoff; all
  classified transient by ndstpu_torch/faults/taxonomy.py;
* **``overloaded``** — sleep the server's ``retry_after_s`` hint, then
  resend;
* **``error`` with ``taxonomy: transient``** (injected
  ``serve.dispatch`` faults, watchdog abandonment) — resend;
* **``rejected``** / **``error`` permanent** — raise immediately:
  the server said retrying unchanged cannot help;
* **``draining``** — raise :class:`ServerDraining` (transient kind):
  callers that know a restart is coming keep
  retrying until the new incarnation answers.

**Multi-endpoint failover (fleet mode).**  ``ServeClient`` accepts a
comma-separated endpoint list (serve/transport.py grammar: AF_UNIX
paths and/or ``tcp:HOST:PORT``).  With more than one endpoint the
contract extends — every switch increments the ``failovers`` evidence
counter:

* a connection fault (``ConnectionRefusedError``/reset — a crashed or
  restarting replica) rotates to the next endpoint and re-submits the
  idempotent read there;
* ``overloaded``/``draining`` from one replica rotates too, so a shed
  request lands on a sibling instead of queueing behind the loaded or
  restarting one;
* only when **every** endpoint refuses for the whole connect window
  does the client raise :class:`NoHealthyEndpoint` (transient, lists
  the endpoints tried).

With a single endpoint the single-server behavior is unchanged byte for
byte.
"""

from __future__ import annotations

import socket
import time
import zlib
from typing import List, Optional

from ndstpu_torch.serve import protocol, transport
from ndstpu_torch.serve.overload import Rejected


class ServeError(RuntimeError):
    """A permanent server-side failure, taxonomy attached."""

    def __init__(self, message: str, taxonomy: str = "permanent",
                 response: Optional[dict] = None):
        super().__init__(message)
        self.taxonomy = taxonomy
        self.kind = taxonomy  # faults.taxonomy.classify reads .kind
        self.response = response or {}


class ServerDraining(RuntimeError):
    kind = "transient"


class NoHealthyEndpoint(ConnectionError):
    """Every fleet endpoint refused for the whole connect window.

    Subclasses :class:`ConnectionError`, so faults/taxonomy.py
    classifies it transient — an outer retry loop may find the fleet
    back up."""

    kind = "transient"

    def __init__(self, endpoints: List[str], last_error: str):
        super().__init__(
            f"no healthy endpoint among {len(endpoints)}: "
            f"{', '.join(endpoints)} (last error: {last_error})")
        self.endpoints = list(endpoints)
        self.last_error = last_error


class ServeClient:
    """One logical client; transparently reconnects across retries and
    rotates across fleet endpoints on connection faults and sheds."""

    def __init__(self, endpoints, tenant: str = "default",
                 retries: int = 8, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 connect_timeout_s: float = 30.0):
        self.endpoints = transport.parse_endpoints(endpoints)
        if not self.endpoints:
            raise ValueError("ServeClient needs at least one endpoint")
        # single-endpoint compat: callers read .socket_path
        self.socket_path = (self.endpoints[0].path
                            if self.endpoints[0].kind == "unix"
                            else self.endpoints[0].spec)
        self.tenant = tenant
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.connect_timeout_s = connect_timeout_s
        self._sock: Optional[socket.socket] = None
        # initial endpoint spread: stable per tenant, so a fleet of
        # clients distributes across replicas instead of all piling
        # onto endpoints[0] (failover still sweeps the full list)
        self._idx = (zlib.crc32(tenant.encode()) % len(self.endpoints)
                     if len(self.endpoints) > 1 else 0)
        self._seq = 0
        self.retried = 0    # observable: how often retry paths fired
        self.failovers = 0  # observable: endpoint switches (fleet)

    # -- transport -----------------------------------------------------------

    @property
    def endpoint(self) -> transport.Endpoint:
        """The endpoint the client currently prefers / is attached to."""
        return self.endpoints[self._idx % len(self.endpoints)]

    def _connect(self) -> socket.socket:
        """Attach to the preferred endpoint, sweeping the rest of the
        fleet on refusal; bounded by ``connect_timeout_s`` overall."""
        if self._sock is not None:
            return self._sock
        deadline = time.monotonic() + self.connect_timeout_s
        wait = self.backoff_s
        n = len(self.endpoints)
        last_err: Optional[OSError] = None
        while True:
            for hop in range(n):
                ep = self.endpoints[(self._idx + hop) % n]
                try:
                    s = transport.connect(ep)
                except OSError as exc:
                    last_err = exc
                    continue
                if hop and n > 1:
                    self.failovers += 1
                self._idx = (self._idx + hop) % n
                self._sock = s
                return s
            if time.monotonic() >= deadline:
                if n > 1:
                    raise NoHealthyEndpoint(
                        [ep.spec for ep in self.endpoints],
                        last_error=str(last_err)) from last_err
                raise last_err  # single endpoint: the raw OSError
            time.sleep(wait)
            wait = min(wait * 2, self.max_backoff_s)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _drop(self) -> None:
        self.close()

    def _failover(self) -> None:
        """Abandon the current endpoint: next attempt starts the sweep
        at its sibling.  No-op beyond dropping with one endpoint."""
        self._drop()
        if len(self.endpoints) > 1:
            self._idx = (self._idx + 1) % len(self.endpoints)
            self.failovers += 1

    def _roundtrip(self, msg: dict) -> dict:
        sock = self._connect()
        protocol.send_msg(sock, msg)
        resp = protocol.recv_msg(sock)
        if resp is None:
            raise ConnectionResetError("server closed the connection")
        return resp

    # -- request with the typed retry contract -------------------------------

    def request(self, msg: dict) -> dict:
        attempt = 0
        wait = self.backoff_s
        fleet = len(self.endpoints) > 1
        while True:
            attempt += 1
            try:
                resp = self._roundtrip(msg)
            except (OSError, protocol.ProtocolError):
                self._failover()
                if attempt > self.retries:
                    raise
                self.retried += 1
                time.sleep(wait)
                wait = min(wait * 2, self.max_backoff_s)
                continue
            status = resp.get("status")
            if status == "ok":
                return resp
            if status == "overloaded":
                if attempt > self.retries:
                    raise ServeError(
                        f"still overloaded after {attempt} attempts: "
                        f"{resp.get('error')}", taxonomy="transient",
                        response=resp)
                self.retried += 1
                hint = float(resp.get("retry_after_s") or wait)
                if fleet:
                    # shed here should land on a sibling: rotate and
                    # retry promptly at first (another replica may be
                    # idle), then back off toward the service-time
                    # hint so the attempt budget spans real queries
                    # instead of exhausting in one fast sweep
                    self._failover()
                    time.sleep(min(max(hint, wait),
                                   self.max_backoff_s))
                    wait = min(wait * 2, self.max_backoff_s)
                else:
                    time.sleep(hint)
                continue
            if status == "draining":
                if fleet and attempt <= self.retries:
                    # rolling restart: the rest of the fleet serves
                    self._failover()
                    self.retried += 1
                    time.sleep(wait)
                    continue
                raise ServerDraining(
                    resp.get("error") or "server is draining")
            if status == "rejected":
                raise Rejected(resp.get("error") or "rejected",
                               reason=resp.get("reason") or "rejected")
            # status == "error": retry transient, raise permanent
            taxonomy = resp.get("taxonomy") or "permanent"
            if taxonomy == "transient" and attempt <= self.retries:
                self.retried += 1
                time.sleep(wait)
                wait = min(wait * 2, self.max_backoff_s)
                continue
            raise ServeError(
                f"{resp.get('type', 'Error')}: {resp.get('error')}",
                taxonomy=taxonomy, response=resp)

    # -- ops -----------------------------------------------------------------

    def _rid(self) -> str:
        self._seq += 1
        return f"{self.tenant}-{self._seq}"

    def sql(self, sql: str, name: Optional[str] = None,
            deadline_s: Optional[float] = None,
            tenant: Optional[str] = None,
            max_rows: int = 100) -> dict:
        msg = {"op": "sql", "id": self._rid(), "sql": sql,
               "tenant": tenant or self.tenant, "max_rows": max_rows}
        if name is not None:
            msg["name"] = name
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        return self.request(msg)

    def ping(self) -> dict:
        return self.request({"op": "ping", "id": self._rid()})

    def health(self) -> dict:
        return self.request(
            {"op": "health", "id": self._rid()})["health"]

    def probe(self) -> dict:
        """Liveness/readiness probe (answered even before readiness)."""
        return self.request(
            {"op": "probe", "id": self._rid()})["probe"]

    def stats(self) -> dict:
        return self.request({"op": "stats", "id": self._rid()})

    def drain(self) -> dict:
        return self.request({"op": "drain", "id": self._rid()})

    def wait_ready(self, timeout_s: float = 120.0,
                   poll_s: float = 0.1) -> bool:
        """Poll readiness (warm restart + AOT precompile flip it only
        after they complete); any one ready endpoint suffices."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                resp = self._roundtrip(
                    {"op": "ready", "id": self._rid()})
                if resp.get("ready"):
                    return True
                if len(self.endpoints) > 1:
                    self._drop()  # not ready: try the next replica
                    self._idx = (self._idx + 1) % len(self.endpoints)
            except (OSError, protocol.ProtocolError):
                self._drop()
                if len(self.endpoints) > 1:
                    self._idx = (self._idx + 1) % len(self.endpoints)
            time.sleep(poll_s)
        return False
