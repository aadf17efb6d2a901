"""Replicated serving fleet: N QueryServer replicas over one warehouse.

A copy of the JAX package's ``ndstpu/serve/fleet.py`` that launches the
port's server (``python -m ndstpu_torch.harness.serve server``).

One server process is a single point of failure between clients and
the warehouse.  This module runs N replica processes (each its own
Session and its own copy of the warehouse, read from the same files or
generated from the same seed; all sharing ONE incrementally-persisted
compile-record file, so a replica boot discovers nothing on any shape
the fleet has seen) behind a **fleet supervisor**:

* **health loop** — each replica is probed over the wire (the
  ``probe`` verb, serve/protocol.py) every ``probe_interval_s``; the
  ``fleet.probe`` fault site sits in the probe path so fault-injection
  runs can exercise false-negative handling (a probe must fail
  ``probe_fail_threshold`` times consecutively, or the process must
  exit, before the supervisor declares death);
* **bounded-backoff restart** — a dead replica is SIGKILL-fenced,
  its stale ``COMMIT.lock`` leases under the warehouse broken (a lock
  naming a dead pid can never commit), and relaunched after a
  doubling, capped backoff;
* **rolling zero-downtime restart** — :meth:`rolling_restart` drains
  one replica (graceful SIGTERM semantics via the ``drain`` verb),
  waits for its successor to probe ready, then moves to the next.
  Clients failover to siblings meanwhile (serve/client.py), so the
  invariant is zero dropped queries, at most one retry per client per
  restart;
* **re-adoption** — supervisor state is the probe state: on boot the
  supervisor probes every configured endpoint and ADOPTS live
  replicas (recording their pids) instead of double-starting them, so
  SIGKILL-ing the supervisor itself never interrupts serving.

On one card every replica holds its own warehouse on the device and
takes half the free memory for its graphs at its first capture, so the
replicas of a fleet fit one card only at a small scale.

Every loop iteration atomically rewrites ``FLEET_HEALTH.json`` in the
run dir — a runtime artifact (never committed, like ``RUN_STATE.json``)
that smoke tests and operators read for pids, readiness, restart
counts, and the serve.fleet.* counters.

``NDSTPU_FLEET=0`` is the kill switch: the supervisor degenerates to
one replica, and the plain single-server path is untouched by this
module entirely.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from ndstpu_torch import faults, obs
from ndstpu_torch.io import commit as commit_mod
from ndstpu_torch.serve import protocol, transport

FLEET_HEALTH_BASENAME = "FLEET_HEALTH.json"
FLEET_HEALTH_ARTIFACT = "ndstpu-fleet-health-v1"
FLEET_ENV = "NDSTPU_FLEET"


@dataclasses.dataclass
class FleetConfig:
    input_prefix: str
    replicas: int = 2
    run_dir: str = "fleet_state"
    endpoints: Optional[List[str]] = None  # default: stable unix socks
    device: str = "cuda"
    generate: Optional[float] = None       # SF: input_prefix is "-"
    generate_seed: int = 1
    output_prefix: Optional[str] = None
    output_format: str = "csv"
    compile_records: Optional[str] = None  # SHARED across replicas
    ledger_path: Optional[str] = "none"
    scale_factor: str = "unknown"
    floats: bool = False
    slots: int = 1
    queue_depth: Optional[int] = 64        # None -> memplan auto
    aot_corpus: Optional[str] = None
    query_timeout_s: Optional[float] = None
    probe_interval_s: float = 0.5
    probe_timeout_s: float = 5.0
    probe_fail_threshold: int = 3
    boot_grace_s: float = 120.0     # probe failures don't kill a boot
    restart_backoff_s: float = 0.25
    restart_backoff_max_s: float = 5.0
    ready_timeout_s: float = 600.0
    python: str = sys.executable


class _Replica:
    """Supervisor-side view of one replica process."""

    def __init__(self, replica_id: str, endpoint: str, state_dir: str):
        self.replica_id = replica_id
        self.endpoint = endpoint
        self.state_dir = state_dir
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None     # known pid (owned or adopted)
        self.adopted = False
        self.state = "down"  # down|starting|ready|restarting|draining
        self.ready = False
        self.restarts = 0
        self.consecutive_failures = 0
        self.backoff_s = 0.0
        self.launched_at: Optional[float] = None  # monotonic
        self.last_probe: Optional[dict] = None
        self.last_probe_at: Optional[float] = None
        self.last_exit: Optional[int] = None

    def doc(self) -> dict:
        return {"replica_id": self.replica_id,
                "endpoint": self.endpoint,
                "pid": self.pid,
                "adopted": self.adopted,
                "state": self.state,
                "ready": self.ready,
                "restarts": self.restarts,
                "consecutive_failures": self.consecutive_failures,
                "last_probe_at": self.last_probe_at,
                "last_exit": self.last_exit}


def default_endpoints(run_dir: str, n: int) -> List[str]:
    """Stable short AF_UNIX paths for a run dir: stable so a restarted
    supervisor probes the SAME sockets it (or its predecessor) bound —
    re-adoption depends on it — and short because unix socket paths
    cap at ~108 bytes regardless of where run_dir lives."""
    tag = hashlib.sha256(
        os.path.abspath(run_dir).encode()).hexdigest()[:8]
    base = tempfile.gettempdir()
    return [os.path.join(base, f"ndstpu-fleet-{tag}-r{i}.sock")
            for i in range(n)]


class FleetSupervisor:
    """Health-checks, restarts, and rolls N serve replicas."""

    def __init__(self, config: FleetConfig,
                 probe_fn: Optional[Callable] = None,
                 launcher: Optional[Callable] = None):
        self.config = config
        if os.environ.get(FLEET_ENV, "") == "0":
            print(f"[fleet] {FLEET_ENV}=0: degenerating to 1 replica")
            config = dataclasses.replace(config, replicas=1)
            self.config = config
        if config.replicas < 1:
            raise ValueError("fleet needs >= 1 replica")
        self._probe_fn = probe_fn or self._probe_rpc
        self._launcher = launcher or self._launch_proc
        os.makedirs(config.run_dir, exist_ok=True)
        self.shared_records = config.compile_records or os.path.join(
            config.run_dir, "compile_records.pkl")
        eps = (list(config.endpoints) if config.endpoints
               else default_endpoints(config.run_dir, config.replicas))
        if len(eps) != config.replicas:
            raise ValueError(f"{config.replicas} replicas need "
                             f"{config.replicas} endpoints, got "
                             f"{len(eps)}")
        self.replicas = [
            _Replica(f"r{i}", ep,
                     os.path.join(config.run_dir, f"r{i}"))
            for i, ep in enumerate(eps)]
        self.health_path = os.path.join(config.run_dir,
                                        FLEET_HEALTH_BASENAME)
        self._lock = threading.RLock()
        self._rolling_lock = threading.Lock()
        self._stopped = threading.Event()
        self._drained = threading.Event()  # drain_fleet finished
        self._monitor: Optional[threading.Thread] = None

    # -- wire helpers --------------------------------------------------------

    def _rpc(self, endpoint: str, msg: dict) -> dict:
        sock = transport.connect(
            endpoint, connect_timeout_s=self.config.probe_timeout_s,
            read_timeout_s_override=self.config.probe_timeout_s)
        try:
            protocol.send_msg(sock, msg)
            resp = protocol.recv_msg(sock)
            if resp is None:
                raise ConnectionResetError(
                    f"{endpoint}: closed during rpc")
            return resp
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _probe_rpc(self, rep: _Replica) -> dict:
        faults.check("fleet.probe", key=rep.replica_id)
        resp = self._rpc(rep.endpoint,
                         {"op": "probe", "id": f"fleet-{rep.replica_id}"})
        probe = resp.get("probe")
        if not isinstance(probe, dict):
            raise protocol.ProtocolError(
                f"{rep.endpoint}: probe verb unsupported: {resp}")
        return probe

    # -- launch / adopt / fence ----------------------------------------------

    def _launch_proc(self, rep: _Replica) -> subprocess.Popen:
        cfg = self.config
        os.makedirs(rep.state_dir, exist_ok=True)
        argv = [cfg.python, "-m", "ndstpu_torch.harness.serve", "server",
                "--socket", rep.endpoint,
                "--input_prefix", cfg.input_prefix,
                "--device", cfg.device,
                "--output_format", cfg.output_format,
                "--state_dir", rep.state_dir,
                "--compile_records", self.shared_records,
                "--scale_factor", str(cfg.scale_factor),
                "--slots", str(cfg.slots),
                "--replica_id", rep.replica_id,
                "--bind_early"]
        argv += ["--queue_depth",
                 "auto" if not cfg.queue_depth else str(cfg.queue_depth)]
        if cfg.output_prefix:
            argv += ["--output_prefix", cfg.output_prefix]
        if cfg.ledger_path:
            argv += ["--ledger", cfg.ledger_path]
        if cfg.aot_corpus:
            argv += ["--aot_corpus", cfg.aot_corpus]
        if cfg.generate is not None:
            argv += ["--generate", f"{cfg.generate:g}",
                     "--generate_seed", str(cfg.generate_seed)]
        if cfg.floats:
            argv += ["--floats"]
        if cfg.query_timeout_s is not None:
            argv += ["--query_timeout_s", str(cfg.query_timeout_s)]
        log = open(os.path.join(cfg.run_dir,
                                f"{rep.replica_id}.log"), "ab")
        try:
            # own session: replicas outlive a SIGKILL'd supervisor and
            # never see its terminal signals
            return subprocess.Popen(argv, stdout=log, stderr=log,
                                    start_new_session=True)
        finally:
            log.close()

    def _fence(self, rep: _Replica) -> int:
        """Break the dead replica's stale CAS commit leases: any
        ``COMMIT.lock`` under the warehouse (or output root) naming
        its pid — or any pid that no longer exists — can never commit
        and would otherwise stall writers for a full lease."""
        dead_pid = rep.pid
        roots = [self.config.input_prefix]
        if self.config.output_prefix:
            roots.append(self.config.output_prefix)
        broken = 0
        for root in roots:
            if not root or not os.path.isdir(root):
                continue
            for dirpath, _dirnames, filenames in os.walk(root):
                if commit_mod.LOCK_BASENAME not in filenames:
                    continue
                path = os.path.join(dirpath, commit_mod.LOCK_BASENAME)
                try:
                    with open(path) as f:
                        holder = json.load(f)
                    pid = int(holder.get("pid", -1))
                except (OSError, ValueError):
                    pid = -1
                stale = pid == dead_pid or not _pid_alive(pid)
                if stale:
                    try:
                        os.unlink(path)
                        broken += 1
                    except OSError:
                        pass
        if broken:
            obs.inc("serve.fleet.fenced", broken)
            print(f"[fleet] fenced {broken} stale commit lease(s) "
                  f"left by {rep.replica_id} (pid {dead_pid})")
        return broken

    def _start_replica(self, rep: _Replica) -> None:
        rep.proc = self._launcher(rep)
        rep.pid = rep.proc.pid if rep.proc is not None else rep.pid
        rep.adopted = False
        rep.state = "starting"
        rep.ready = False
        rep.consecutive_failures = 0
        rep.launched_at = time.monotonic()
        rep.last_probe = None  # this incarnation has not probed yet
        rep.last_exit = None
        obs.inc("serve.fleet.launched")
        print(f"[fleet] launched {rep.replica_id} pid={rep.pid} "
              f"on {rep.endpoint}")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Adopt live replicas (probe state is the source of truth —
        a restarted supervisor must never double-start), launch the
        rest, then begin the health loop."""
        for rep in self.replicas:
            probe = None
            try:
                probe = self._probe_fn(rep)
            except Exception:  # noqa: BLE001 — not running: launch it
                probe = None
            if probe and probe.get("alive"):
                rep.pid = probe.get("pid")
                rep.adopted = True
                rep.proc = None
                rep.ready = bool(probe.get("ready"))
                rep.state = "ready" if rep.ready else "starting"
                rep.last_probe = probe
                rep.last_probe_at = time.time()
                obs.inc("serve.fleet.adopted")
                print(f"[fleet] adopted live {rep.replica_id} "
                      f"pid={rep.pid} on {rep.endpoint} "
                      f"(ready={rep.ready})")
            else:
                self._start_replica(rep)
        self._write_health()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        obs.inc("serve.fleet.started")

    def wait_ready(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every replica probes ready."""
        timeout_s = (self.config.ready_timeout_s
                     if timeout_s is None else timeout_s)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stopped.is_set():
            if all(r.ready for r in self.replicas):
                return True
            time.sleep(0.1)
        return all(r.ready for r in self.replicas)

    def endpoints_spec(self) -> str:
        """The comma-separated failover spec clients connect with."""
        return ",".join(r.endpoint for r in self.replicas)

    # -- health loop ---------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stopped.is_set():
            for rep in self.replicas:
                if self._stopped.is_set():
                    break
                with self._lock:
                    if rep.state in ("draining", "restarting"):
                        continue  # rolling_restart owns it right now
                    self._check_one(rep)
            self._write_health()
            self._stopped.wait(self.config.probe_interval_s)
        self._write_health()

    def _check_one(self, rep: _Replica) -> None:
        # process exit is authoritative death, no threshold needed
        if rep.proc is not None:
            rc = rep.proc.poll()
            if rc is not None:
                rep.last_exit = rc
                print(f"[fleet] {rep.replica_id} pid={rep.pid} "
                      f"exited rc={rc}")
                self._restart(rep)
                return
        try:
            probe = self._probe_fn(rep)
            obs.inc("serve.fleet.probes")
            rep.last_probe = probe
            rep.last_probe_at = time.time()
            rep.consecutive_failures = 0
            rep.backoff_s = 0.0
            was_ready = rep.ready
            rep.ready = bool(probe.get("ready"))
            rep.state = "ready" if rep.ready else "starting"
            if rep.adopted and probe.get("pid"):
                rep.pid = probe.get("pid")
            if rep.ready and not was_ready:
                print(f"[fleet] {rep.replica_id} ready "
                      f"(pid={rep.pid})")
        except Exception as e:  # noqa: BLE001 — probe failure
            obs.inc("serve.fleet.probe_failures")
            # a fresh incarnation hasn't bound yet: imports + catalog
            # load take seconds, so failed probes inside the boot
            # grace window are expected, not a death signal (process
            # exit above stays authoritative either way)
            booting = (rep.last_probe is None
                       and rep.launched_at is not None
                       and time.monotonic() - rep.launched_at
                       < self.config.boot_grace_s)
            if booting:
                return
            rep.consecutive_failures += 1
            if rep.consecutive_failures >= \
                    self.config.probe_fail_threshold:
                print(f"[fleet] {rep.replica_id} failed "
                      f"{rep.consecutive_failures} probes "
                      f"({type(e).__name__}: {e}); restarting")
                self._restart(rep)

    def _restart(self, rep: _Replica) -> None:
        """Fence + relaunch one dead replica with bounded backoff."""
        rep.state = "restarting"
        rep.ready = False
        obs.inc("serve.fleet.restarts")
        self._kill_quietly(rep)
        self._fence(rep)
        rep.backoff_s = min(
            max(rep.backoff_s * 2, self.config.restart_backoff_s),
            self.config.restart_backoff_max_s)
        rep.restarts += 1
        time.sleep(rep.backoff_s)
        self._start_replica(rep)

    def _kill_quietly(self, rep: _Replica) -> None:
        """Make sure the old incarnation is really gone before the new
        one binds its endpoint (idempotent on an already-dead pid)."""
        if rep.proc is not None:
            if rep.proc.poll() is None:
                try:
                    rep.proc.kill()
                except OSError:
                    pass
            try:
                rep.proc.wait(timeout=10)
                rep.last_exit = rep.proc.returncode
            except Exception:  # noqa: BLE001
                pass
            rep.proc = None
        elif rep.pid:
            try:
                os.kill(rep.pid, signal.SIGKILL)
            except OSError:
                pass

    # -- rolling restart -----------------------------------------------------

    def rolling_restart(self, reason: str = "rolling") -> dict:
        """Zero-downtime restart: drain + relaunch one replica at a
        time, waiting for it to probe ready before touching the next,
        so N-1 replicas serve at every instant."""
        if not self._rolling_lock.acquire(blocking=False):
            return {"skipped": "rolling restart already in progress"}
        try:
            obs.inc("serve.fleet.rolling_restarts")
            print(f"[fleet] rolling restart ({reason})")
            rolled = []
            for rep in self.replicas:
                with self._lock:
                    rep.state = "draining"
                    rep.ready = False
                self._drain_one(rep)
                with self._lock:
                    self._fence(rep)
                    rep.restarts += 1
                    self._start_replica(rep)
                if not self._wait_replica_ready(rep):
                    print(f"WARNING: [fleet] {rep.replica_id} not "
                          f"ready after rolling relaunch; continuing")
                rolled.append(rep.replica_id)
            print(f"[fleet] rolling restart complete: {rolled}")
            return {"rolled": rolled}
        finally:
            self._rolling_lock.release()

    def _drain_one(self, rep: _Replica) -> None:
        """SIGTERM-equivalent graceful drain over the wire; escalate
        to kill only if the drain wedges."""
        try:
            self._rpc(rep.endpoint,
                      {"op": "drain", "id": f"fleet-{rep.replica_id}"})
        except Exception as e:  # noqa: BLE001 — already dead is fine
            print(f"[fleet] {rep.replica_id} drain rpc failed "
                  f"({type(e).__name__}); treating as down")
        deadline = time.monotonic() + max(
            30.0, (self.config.query_timeout_s or 300.0) + 60.0)
        while time.monotonic() < deadline:
            if rep.proc is not None:
                if rep.proc.poll() is not None:
                    rep.last_exit = rep.proc.returncode
                    rep.proc = None
                    return
            else:
                if not rep.pid or not _pid_alive(rep.pid):
                    return
            time.sleep(0.1)
        print(f"WARNING: [fleet] {rep.replica_id} did not exit after "
              f"drain; killing")
        self._kill_quietly(rep)

    def _wait_replica_ready(self, rep: _Replica) -> bool:
        deadline = time.monotonic() + self.config.ready_timeout_s
        while time.monotonic() < deadline:
            try:
                probe = self._probe_fn(rep)
                rep.last_probe = probe
                rep.last_probe_at = time.time()
                if probe.get("ready"):
                    with self._lock:
                        rep.ready = True
                        rep.state = "ready"
                        rep.consecutive_failures = 0
                    return True
            except Exception:  # noqa: BLE001 — still booting
                pass
            if rep.proc is not None and rep.proc.poll() is not None:
                return False  # crashed during boot; monitor restarts
            time.sleep(0.2)
        return False

    # -- drain / health artifact ---------------------------------------------

    def drain_fleet(self, reason: str = "drain") -> dict:
        """Stop monitoring, drain every replica, record final state."""
        if self._stopped.is_set():
            return {"reason": reason, "already": True}
        self._stopped.set()
        if self._monitor is not None:
            self._monitor.join(timeout=self.config.probe_interval_s
                               + self.config.probe_timeout_s + 5)
        for rep in self.replicas:
            rep.state = "draining"
            rep.ready = False
            self._drain_one(rep)
            rep.state = "down"
        self._write_health()
        obs.inc("serve.fleet.drained")
        print(f"[fleet] drained ({reason})")
        self._drained.set()
        return {"reason": reason,
                "replicas": [r.replica_id for r in self.replicas]}

    def fleet_counters(self) -> Dict[str, float]:
        return {k: v for k, v in obs.counters_snapshot().items()
                if k.startswith("serve.fleet.")}

    def health_doc(self) -> dict:
        with self._lock:
            return {
                "artifact": FLEET_HEALTH_ARTIFACT,
                "supervisor_pid": os.getpid(),
                "updated_epoch_s": time.time(),
                "run_dir": os.path.abspath(self.config.run_dir),
                "input_prefix": self.config.input_prefix,
                "device": self.config.device,
                "endpoints": self.endpoints_spec(),
                "shared_compile_records": self.shared_records,
                "replicas": [r.doc() for r in self.replicas],
                "counters": self.fleet_counters(),
            }

    def _write_health(self) -> None:
        doc = self.health_doc()
        tmp = self.health_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
            os.replace(tmp, self.health_path)
        except OSError as e:
            print(f"WARNING: [fleet] health write failed: {e}")


def _pid_alive(pid: Optional[int]) -> bool:
    if not pid or pid < 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


def install_fleet_signal_handlers(sup: FleetSupervisor) -> None:
    """SIGTERM/SIGINT -> drain the fleet; SIGHUP -> rolling restart
    (the operator's zero-downtime redeploy trigger)."""
    def _drain(signum, _frame):
        threading.Thread(
            target=lambda: (sup.drain_fleet(
                reason=signal.Signals(signum).name)),
            name="fleet-drain", daemon=True).start()

    def _roll(_signum, _frame):
        threading.Thread(target=sup.rolling_restart,
                         kwargs={"reason": "SIGHUP"},
                         name="fleet-rolling", daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _roll)


def serve_fleet_forever(config: FleetConfig) -> int:
    """CLI runner: start, install signals, block until drained."""
    sup = FleetSupervisor(config)
    install_fleet_signal_handlers(sup)
    sup.start()
    ok = sup.wait_ready()
    print(f"[fleet] serving on {sup.endpoints_spec()} "
          f"(ready={ok}, replicas={len(sup.replicas)})", flush=True)
    sup._stopped.wait()
    # _stopped flips at the START of drain_fleet (stops the monitor);
    # exiting then would orphan still-draining replicas — block until
    # every replica has actually been drained or killed.
    per_rep = max(30.0, (config.query_timeout_s or 300.0) + 90.0)
    sup._drained.wait(timeout=per_rep * max(1, len(sup.replicas)))
    return 0
