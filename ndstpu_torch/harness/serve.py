"""``python -m ndstpu_torch.harness.serve``: the always-on query service.

The port of the JAX package's ``ndstpu/harness/serve.py`` (its
``ndstpu-serve``).  Three subcommands:

``server``
    Boot a :class:`~ndstpu_torch.serve.server.QueryServer` over a
    warehouse on the card (``--device``, default ``cuda``; ``cpu`` runs it
    on the host) and block until drained (SIGTERM/SIGINT run the graceful
    drain; SIGKILL is what the warm restart exists for).  The warehouse
    is read from ``--input_prefix`` (through pyarrow), or, with
    ``--input_prefix -`` and ``--generate SF`` (and ``--generate_seed
    N``), generated on the device, as the power run's ``--generate``
    does: the card's machine has no pyarrow.  State files (journal /
    compile records / SLO.json / ledger) default into ``--state_dir`` so
    a restart with the same flags finds them.  ``--socket`` takes any
    serve/transport.py endpoint spec (unix path or ``tcp:HOST:PORT``);
    ``--tcp HOST:PORT`` adds a TCP listener beside it.  With no card and
    no ``--device cpu`` the server exits 2 naming the missing device.

``fleet``
    Boot a :class:`~ndstpu_torch.serve.fleet.FleetSupervisor`: N replica
    server processes over one warehouse, health-checked and restarted
    with bounded backoff.  SIGHUP triggers a rolling zero-downtime
    restart; SIGTERM drains the whole fleet.  Clients connect with
    the printed comma-separated endpoint spec and fail over between
    replicas.  Each replica holds its own warehouse on the device.

``client``
    Ad-hoc requests against a running server or fleet: ``--sql``
    (repeatable), ``--op health|stats|ready|drain|ping|probe``, with
    the typed reconnect-retry-failover contract of
    :class:`~ndstpu_torch.serve.client.ServeClient`.

Examples::

    python -m ndstpu_torch.harness.serve server --socket /tmp/nds.sock \\
        --input_prefix - --generate 20 --state_dir serve_state
    python -m ndstpu_torch.harness.serve fleet --replicas 2 \\
        --input_prefix - --generate 0.5 --run_dir fleet_state
    python -m ndstpu_torch.harness.serve client --socket /tmp/nds.sock \\
        --sql "SELECT count(*) FROM store_sales"
    python -m ndstpu_torch.harness.serve client \\
        --socket unix:/a.sock,tcp:127.0.0.1:9001 --op probe

``--floats`` (``server`` and ``fleet``) serves the decimals-as-doubles
warehouse, as the power run's ``--floats``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ndstpu_torch.harness.serve",
        description="always-on NDS query service (the PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run the query server")
    s.add_argument("--socket", required=True,
                   help="endpoint to listen on (unix path, "
                        "unix:/path, or tcp:HOST:PORT)")
    s.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="additional TCP listener beside --socket")
    s.add_argument("--input_prefix", required=True,
                   help="warehouse root (loader.load_catalog), or - with "
                        "--generate")
    _device_args(s)
    s.add_argument("--output_prefix", default=None,
                   help="root for per-request result writes "
                        "(requests carrying a name)")
    s.add_argument("--output_format", default="csv",
                   choices=("csv", "parquet"))
    s.add_argument("--state_dir", default="serve_state",
                   help="journal/compile-records/SLO/ledger home")
    s.add_argument("--compile_records", default=None,
                   help="override the state_dir compile-record path")
    s.add_argument("--journal", default=None,
                   help="override the state_dir journal path")
    s.add_argument("--slo", default=None,
                   help="override the state_dir SLO.json path")
    s.add_argument("--ledger", default=None,
                   help="run-ledger path ('none' disables)")
    s.add_argument("--scale_factor", default="unknown",
                   help="recorded in the ledger rows (set by --generate)")
    s.add_argument("--floats", action="store_true",
                   help="double mode (no decimals)")
    s.add_argument("--slots", type=int, default=1,
                   help="device admission slots (InprocAdmission)")
    s.add_argument("--queue_depth", default="64",
                   help="admission queue depth; 'auto' derives it "
                        "from the memplan device-memory model")
    s.add_argument("--tenant_tokens", type=float, default=64.0)
    s.add_argument("--tenant_refill_per_s", type=float, default=16.0)
    s.add_argument("--breaker_cooldown_s", type=float, default=5.0)
    s.add_argument("--query_timeout_s", type=float, default=None,
                   help="per-query watchdog (default: env "
                        "NDSTPU_SERVE_QUERY_TIMEOUT_S or 300)")
    s.add_argument("--aot_corpus", default=None,
                   help="query stream file (or dir of query_*.sql) "
                        "to precompile before readiness flips")
    s.add_argument("--bind_early", action="store_true",
                   help="bind + answer probes before warm "
                        "restart/AOT complete (fleet supervisors)")
    s.add_argument("--replica_id", default=None,
                   help="fleet identity reported in probe/health")

    f = sub.add_parser("fleet", help="run a replicated serving fleet")
    f.add_argument("--input_prefix", required=True,
                   help="warehouse root, or - with --generate")
    f.add_argument("--replicas", type=int, default=2)
    f.add_argument("--run_dir", default="fleet_state",
                   help="per-replica state dirs + FLEET_HEALTH.json")
    f.add_argument("--endpoints", default=None,
                   help="comma-separated endpoint specs, one per "
                        "replica (default: unix sockets derived from "
                        "run_dir)")
    _device_args(f)
    f.add_argument("--output_prefix", default=None)
    f.add_argument("--output_format", default="csv",
                   choices=("csv", "parquet"))
    f.add_argument("--compile_records", default=None,
                   help="SHARED compile-record artifact (default: "
                        "run_dir/compile_records.pkl)")
    f.add_argument("--ledger", default="none")
    f.add_argument("--scale_factor", default="unknown")
    f.add_argument("--floats", action="store_true",
                   help="double mode (no decimals), on every replica")
    f.add_argument("--slots", type=int, default=1)
    f.add_argument("--queue_depth", default="64",
                   help="per-replica admission depth; 'auto' derives "
                        "it from the memplan device-memory model")
    f.add_argument("--aot_corpus", default=None)
    f.add_argument("--query_timeout_s", type=float, default=None)
    f.add_argument("--probe_interval_s", type=float, default=0.5)
    f.add_argument("--restart_backoff_s", type=float, default=0.25)

    c = sub.add_parser("client", help="talk to a running server/fleet")
    c.add_argument("--socket", required=True,
                   help="endpoint spec; comma-separate for failover")
    c.add_argument("--sql", action="append", default=[],
                   help="statement to run (repeatable)")
    c.add_argument("--op", default=None,
                   choices=("ping", "health", "ready", "stats",
                            "drain", "probe"))
    c.add_argument("--tenant", default="default")
    c.add_argument("--name", default=None,
                   help="server-side output name for a single --sql")
    c.add_argument("--deadline_s", type=float, default=None)
    c.add_argument("--max_rows", type=int, default=100)
    c.add_argument("--retries", type=int, default=8)
    c.add_argument("--wait_ready_s", type=float, default=0.0,
                   help="poll readiness up to this long first")
    return p


def _device_args(p: argparse.ArgumentParser) -> None:
    """The device and the generated warehouse, as the power CLI has
    them."""
    p.add_argument("--device", default="cuda",
                   help="torch device the engine runs on (default cuda; "
                        "cpu for the tests)")
    p.add_argument("--generate", type=float, metavar="SF",
                   help="generate the warehouse on the device at this "
                        "scale factor instead of reading one "
                        "(--input_prefix must be -)")
    p.add_argument("--generate_seed", type=int, default=1, metavar="N",
                   help="the generator's seed with --generate (default 1)")


def _check_warehouse(p: argparse.ArgumentParser, args) -> None:
    """A warehouse directory, or ``-`` with ``--generate SF``, which also
    sets the ledger rows' scale factor."""
    if (args.generate is None) != (args.input_prefix != "-"):
        p.error("give a warehouse directory, or - with --generate SF")
    if args.generate is not None:
        args.scale_factor = f"{args.generate:g}"


def _refusal(args) -> Optional[str]:
    """Why the server or fleet cannot start here, or None: no card (and
    no --device other than cuda), or outputs without pyarrow."""
    from ndstpu_torch.engine.torchexec import resolve_device
    from ndstpu_torch.io import loader
    try:
        resolve_device(args.device)
        if args.output_prefix:
            loader._pyarrow()
    except (RuntimeError, ModuleNotFoundError) as e:
        return str(e)
    return None


def _parse_depth(raw) -> Optional[int]:
    """``auto`` (or 0) -> None: derive depth from the memplan
    device-memory model (memplan.admission_budget)."""
    if raw is None or str(raw).lower() in ("auto", "0", "none"):
        return None
    return int(raw)


def _run_server(args) -> int:
    from ndstpu_torch.serve import lifecycle
    from ndstpu_torch.serve.server import QueryServer, ServeConfig
    sd = args.state_dir
    os.makedirs(sd, exist_ok=True)
    cfg = ServeConfig(
        socket_path=args.socket,
        input_prefix=args.input_prefix,
        device=args.device,
        generate=args.generate,
        generate_seed=args.generate_seed,
        output_prefix=args.output_prefix,
        output_format=args.output_format,
        compile_records=args.compile_records
        or os.path.join(sd, "compile_records.pkl"),
        journal_path=args.journal
        or os.path.join(sd, "serve_journal.jsonl"),
        slo_path=args.slo or os.path.join(sd, "SLO.json"),
        ledger_path=args.ledger,
        scale_factor=args.scale_factor,
        floats=args.floats,
        slots=args.slots,
        queue_depth=_parse_depth(args.queue_depth),
        tenant_tokens=args.tenant_tokens,
        tenant_refill_per_s=args.tenant_refill_per_s,
        breaker_cooldown_s=args.breaker_cooldown_s,
        query_timeout_s=args.query_timeout_s,
        tcp=args.tcp,
        aot_corpus=args.aot_corpus,
        bind_early=args.bind_early,
        replica_id=args.replica_id)
    server = QueryServer(cfg)
    lifecycle.install_signal_handlers(server)
    server.serve_forever()
    return 0


def _run_fleet(args) -> int:
    from ndstpu_torch.serve import fleet
    cfg = fleet.FleetConfig(
        input_prefix=args.input_prefix,
        replicas=args.replicas,
        run_dir=args.run_dir,
        endpoints=(args.endpoints.split(",") if args.endpoints
                   else None),
        device=args.device,
        generate=args.generate,
        generate_seed=args.generate_seed,
        output_prefix=args.output_prefix,
        output_format=args.output_format,
        compile_records=args.compile_records,
        ledger_path=args.ledger,
        scale_factor=args.scale_factor,
        floats=args.floats,
        slots=args.slots,
        queue_depth=_parse_depth(args.queue_depth),
        aot_corpus=args.aot_corpus,
        query_timeout_s=args.query_timeout_s,
        probe_interval_s=args.probe_interval_s,
        restart_backoff_s=args.restart_backoff_s)
    return fleet.serve_fleet_forever(cfg)


def _run_client(args) -> int:
    from ndstpu_torch.serve.client import ServeClient
    cli = ServeClient(args.socket, tenant=args.tenant,
                      retries=args.retries)
    try:
        if args.wait_ready_s > 0 and \
                not cli.wait_ready(args.wait_ready_s):
            print(f"server not ready within {args.wait_ready_s:g}s",
                  file=sys.stderr)
            return 1
        if args.op:
            resp = cli.request({"op": args.op})
            print(json.dumps(resp, indent=2, default=str))
            if cli.failovers:
                print(f"# client.failovers={cli.failovers}",
                      file=sys.stderr)
        for sql in args.sql:
            name = args.name if len(args.sql) == 1 else None
            resp = cli.sql(sql, name=name,
                           deadline_s=args.deadline_s,
                           max_rows=args.max_rows)
            print(json.dumps(resp, indent=2, default=str))
        if not args.op and not args.sql:
            print(json.dumps(cli.health(), indent=2, default=str))
    finally:
        cli.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.cmd in ("server", "fleet"):
        _check_warehouse(p, args)
        why = _refusal(args)
        if why is not None:
            print(f"{p.prog} {args.cmd}: {why}", file=sys.stderr)
            return 2
    if args.cmd == "server":
        return _run_server(args)
    if args.cmd == "fleet":
        return _run_fleet(args)
    return _run_client(args)


if __name__ == "__main__":
    sys.exit(main())
