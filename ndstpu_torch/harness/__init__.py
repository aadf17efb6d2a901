"""Benchmark harness on the port's engine: the power run
(:mod:`ndstpu_torch.harness.power`), the throughput run
(:mod:`ndstpu_torch.harness.throughput`: concurrent streams, one power
process each or threads over one shared session through
:mod:`ndstpu_torch.harness.scheduler`), their per-query reports, progress
heartbeat and deadline budget, and the concurrent-stream admission gates.
The five-phase orchestrator, maintenance and validation are later
slices."""
