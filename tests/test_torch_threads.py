"""One torch intra-op thread in each test process.

The test run has six pytest workers on eight CPUs.  torch starts an
intra-op thread a core in each of them, and a worker's thread pool then
spins against the other workers' (the JAX package's XLA pools among
them) on tensors far too small to share.  Every worker collects this
module, so the setting holds in each of them; the port's test files also
import it, so that it holds when one of them runs alone."""

import torch

torch.set_num_threads(1)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
