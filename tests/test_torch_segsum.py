"""The port's exact decimal segment sum against the JAX package's.

``ndstpu_torch.ops.segsum.segment_sum_decimal`` on CPU tensors runs its
plain PyTorch version; it is held bit-exact (sums and counts, int64)
against ``ndstpu.ops.segsum.segment_sum_decimal`` run in Pallas interpret
mode, as tests/test_ops.py runs it.  Inputs are made with numpy from a
seed.  The CUDA kernel has no CPU mode: ``chip_smoke.py`` compares it
with the plain version on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndstpu.ops import segsum as jseg
from ndstpu_torch.ops import segsum as tseg

_BIAS = 1 << 41


def _case(kind, n, s, seed=7):
    rng = np.random.RandomState(seed)
    # signed cents incl. values far above f32's exact-integer range
    vals = rng.randint(-10**12, 10**12, n).astype(np.int64)
    gid = rng.randint(0, s, n).astype(np.int32)
    mask = rng.rand(n) < 0.9
    if kind == "empty_mask":
        mask[:] = False
    elif kind == "gid_out_of_range":
        gid = rng.randint(-3, s + 3, n).astype(np.int32)
    elif kind == "poison":
        vals[n // 2] = _BIAS            # one masked-in |v| >= 2^41
        mask[n // 2] = True
    elif kind == "bias_edge":
        # |v| = 2^41 - 1 is in range; v = -2^41 is poison AND counts 0
        vals[: n // 2] = _BIAS - 1
        vals[n // 2] = -_BIAS
        mask[n // 2] = True
    return vals, gid, mask


_CASES = [("random", 2048, 11), ("random", 4096, 500), ("random", 1, 1),
          ("random", 513, 24443), ("empty_mask", 512, 9),
          ("gid_out_of_range", 2048, 37), ("poison", 1024, 13),
          ("bias_edge", 1024, 5)]


@pytest.mark.parametrize("kind,n,s", _CASES)
def test_plain_matches_pallas_interpret(kind, n, s):
    """Bit-exact (tolerance 0): int64 sums and counts."""
    vals, gid, mask = _case(kind, n, s)
    jsums, jcounts = jseg.segment_sum_decimal(
        jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), s,
        block_rows=256, block_segs=128, interpret=True)
    launches = tseg.LAUNCHES
    tsums, tcounts = tseg.segment_sum_decimal(
        torch.from_numpy(vals), torch.from_numpy(gid),
        torch.from_numpy(mask), s)
    assert tseg.LAUNCHES == launches          # CPU tensors never launch
    assert tsums.dtype == torch.int64 and tcounts.dtype == torch.int64
    np.testing.assert_array_equal(tsums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    if kind in ("poison", "bias_edge"):
        assert (tsums.numpy() == -(2 ** 62)).all()


def test_plain_lifts_row_limit():
    """The JAX function refuses more than (2^31-1)//255 rows; the port
    accumulates in int64 and takes them (checked against numpy)."""
    n, s = (2 ** 31 - 1) // 255 + 1, 3
    vals = np.full(n, 10**9, np.int64)
    gid = (np.arange(n) % s).astype(np.int32)
    mask = np.ones(n, bool)
    with pytest.raises(ValueError):
        jseg.segment_sum_decimal(jnp.asarray(vals), jnp.asarray(gid),
                                 jnp.asarray(mask), s, interpret=True)
    sums, counts = tseg.segment_sum_decimal(
        torch.from_numpy(vals), torch.from_numpy(gid),
        torch.from_numpy(mask), s)
    want_counts = np.bincount(gid, minlength=s).astype(np.int64)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(sums.numpy(), want_counts * 10**9)


@pytest.mark.parametrize("bad", ["dtype", "shape", "segments"])
def test_wrapper_rejects_bad_input(bad):
    vals = torch.zeros(8, dtype=torch.int64)
    gid = torch.zeros(8, dtype=torch.int32)
    mask = torch.ones(8, dtype=torch.bool)
    s = 4
    if bad == "dtype":
        gid = gid.long()
    elif bad == "shape":
        mask = mask[:7]
    else:
        s = 0
    with pytest.raises((TypeError, ValueError)):
        tseg.segment_sum_decimal(vals, gid, mask, s)
