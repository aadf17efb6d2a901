"""Commit-lease names the serving fleet's fencing reads.

The JAX package's ``ndstpu/io/commit.py`` commits lake tables under a
compare-and-swap lease, a ``COMMIT.lock`` file that names the writer's
pid.  The port has no lake tables yet, so it keeps only the lease's file
name, which the fleet supervisor (``ndstpu_torch/serve/fleet.py``) fences:
a dead replica's lease under the warehouse or output root is removed
before the replica restarts, so it can never stall a writer.
"""

LOCK_BASENAME = "COMMIT.lock"
