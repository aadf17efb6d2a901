"""The port's exact decimal segment sum against the JAX package's.

``ndstpu_torch.ops.segsum.segment_sum_decimal`` on CPU tensors runs its
plain PyTorch version; it is held bit-exact (sums and counts, int64)
against ``ndstpu.ops.segsum.segment_sum_decimal`` run in Pallas interpret
mode, as tests/test_ops.py runs it.  Inputs are made with numpy from a
seed.  The CUDA kernel has no CPU mode: ``chip_smoke.py`` compares it
with the plain version on the card."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndstpu.ops import segsum as jseg
from ndstpu_torch.ops import segsum as tseg

_BIAS = 1 << 41


def zipf_gid(rng, n, s):
    """Zipf-skewed gids as chip_smoke.py draws them: rank ~ 1/k, the
    hottest segment some 10% of the rows."""
    rank = np.clip(np.exp(rng.rand(n) * np.log(s + 1.0)).astype(np.int64),
                   1, s)
    return ((rank - 1) * 1000003 % s).astype(np.int32)


def _case(kind, n, s, seed=7):
    rng = np.random.RandomState(seed)
    # signed cents incl. values far above f32's exact-integer range
    vals = rng.randint(-10**12, 10**12, n).astype(np.int64)
    gid = rng.randint(0, s, n).astype(np.int32)
    mask = rng.rand(n) < 0.9
    if kind == "zipf":
        gid = zipf_gid(rng, n, s)
    elif kind == "one_segment":
        gid[:] = 0
    elif kind == "poison_gid_out_of_range":
        vals[n // 2] = -_BIAS           # out of range, and so is its gid
        mask[n // 2] = True
        gid[n // 2] = s + 2
    elif kind == "empty_mask":
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
          ("bias_edge", 1024, 5),
          # the cases the kernel's regimes make important: Zipf-hot
          # segments at the engine's 32,768-segment gate, every row in one
          # segment, a ragged tail (n % 4 != 0), views at an odd storage
          # offset, an out-of-range value whose gid is out of range too
          ("zipf", 4096, 32768), ("one_segment", 4099, 1),
          ("random", 4095, 37), ("offset_view", 4097, 37),
          ("poison_gid_out_of_range", 1024, 13)]
# Pallas tiling for the interpret run (default 256 rows x 128 segments)
_BLOCKS = {32768: (1024, 8192)}


@pytest.mark.parametrize("kind,n,s", _CASES)
def test_plain_matches_pallas_interpret(kind, n, s):
    """Bit-exact (tolerance 0): int64 sums and counts."""
    vals, gid, mask = _case(kind, n, s)
    tv, tg, tm = (torch.from_numpy(x) for x in (vals, gid, mask))
    if kind == "offset_view":
        # contiguous views at storage offset 1, as the engine may pass
        vals, gid, mask = vals[1:], gid[1:], mask[1:]
        tv, tg, tm = tv[1:], tg[1:], tm[1:]
        assert tv.storage_offset() == 1 and tv.is_contiguous()
    block_rows, block_segs = _BLOCKS.get(s, (256, 128))
    jsums, jcounts = jseg.segment_sum_decimal(
        jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), s,
        block_rows=block_rows, block_segs=block_segs, interpret=True)
    launches = tseg.LAUNCHES
    tsums, tcounts = tseg.segment_sum_decimal(tv, tg, tm, s)
    assert tseg.LAUNCHES == launches          # CPU tensors never launch
    assert tsums.dtype == torch.int64 and tcounts.dtype == torch.int64
    np.testing.assert_array_equal(tsums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    if kind.startswith("poison") or kind == "bias_edge":
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


_SEGS = range(1, 32769)
_ROWS = (0, 1, 3, 4096, 84_500, 1_000_000, 8_000_000, 300_000_000)


@pytest.mark.parametrize("kernel", ["decimal", "f32"])
def test_launch_planner(kernel):
    """For every segment count up to the engine's gate and a spread of row
    counts, on a 132-SM card: the planned shared memory fits a block's
    232,448 B with the kernel's 1 KB of static shared memory, the cluster
    is 1 or 2 CTAs and divides the grid, the grid is non-empty for n > 0,
    and n = 0 plans no kernel."""
    plan = tseg._plan_decimal if kernel == "decimal" else tseg._plan_f32
    for s in _SEGS:
        for n in _ROWS:
            p = plan.__wrapped__(n, s, 132)
            if n == 0:
                assert p.grid == 0, (n, s, p)
                continue
            assert p.smem + 1024 <= 232448, (n, s, p)
            assert p.cluster in (1, 2) and p.grid % p.cluster == 0, \
                (n, s, p)
            assert 0 < p.grid and 0 < p.block <= 1024, (n, s, p)
            if p.smem:
                # a histogram holds every segment this CTA owns
                per_seg = 12 if kernel == "decimal" else 4
                owned = -(-s // 2) if p.cluster == 2 and \
                    kernel == "decimal" else s
                assert p.smem >= per_seg * owned, (n, s, p)
