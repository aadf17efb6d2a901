"""Always-on query service: the serve layer over one shared Session.

The port of the JAX package's ``ndstpu/serve``.  The batch harness
(power/throughput) runs fixed work lists and exits; ``ndstpu_torch.serve``
keeps the engine, the warehouse and the compiled plans resident on the
card and puts a fault-tolerant front door on them:

* :mod:`ndstpu_torch.serve.protocol` — length-prefixed JSON request
  framing shared by server and client (byte-identical to the JAX
  package's);
* :mod:`ndstpu_torch.serve.transport` — AF_UNIX and TCP endpoints;
* :mod:`ndstpu_torch.serve.overload` — admission control: bounded queue,
  per-tenant token budgets, deadline-aware shedding, and a per-plan-
  shape circuit breaker over the quarantine list;
* :mod:`ndstpu_torch.serve.lifecycle` — the robustness control plane:
  append-only serve journal, SIGTERM graceful drain, crash-safe warm
  restart, and per-tenant latency SLO export (``SLO.json``);
* :mod:`ndstpu_torch.serve.server` — the socket front door feeding the
  continuous-feed :class:`~ndstpu_torch.harness.scheduler.StreamScheduler`
  and :class:`~ndstpu_torch.harness.admission.InprocAdmission`;
* :mod:`ndstpu_torch.serve.client` — reconnect-and-retry client;
* :mod:`ndstpu_torch.serve.fleet` — N server replicas behind a
  supervisor.

Entry point: ``python -m ndstpu_torch.harness.serve server|fleet|client``.
"""

from ndstpu_torch.serve.overload import (  # noqa: F401
    AdmissionQueue,
    CircuitBreaker,
    Overloaded,
    Rejected,
    TenantBudgets,
)
