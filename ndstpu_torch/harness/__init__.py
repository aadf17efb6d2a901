"""Benchmark harness on the port's engine: the power run
(:mod:`ndstpu_torch.harness.power`), its per-query reports, progress
heartbeat and deadline budget, and the concurrent-stream admission gate.
The throughput run, the five-phase orchestrator, maintenance and
validation are later slices."""
