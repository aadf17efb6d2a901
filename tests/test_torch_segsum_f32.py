"""The port's float32 segment sum against the JAX package's.

``ndstpu_torch.ops.segsum.segment_sum_f32`` on CPU tensors runs its plain
PyTorch version; it is held against ``ndstpu.ops.segsum.segment_sum_f32``
run in Pallas interpret mode, as tests/test_ops.py runs it, within
tests/test_ops.py's tolerance (rtol 2e-5, atol 1e-2: the two sum in
different orders).  Inputs are made with numpy from a seed.  The CUDA
kernel has no CPU mode: ``chip_smoke.py`` compares it with the plain
version on the card.  The segment-sum bench runs here on the CPU, where
the kernels' plain versions stand in for them."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ndstpu.ops import segsum as jseg
from ndstpu_torch.ops import bench
from ndstpu_torch.ops import segsum as tseg
from test_torch_segsum import zipf_gid


def _case(kind, n, s, seed=5):
    """tests/test_ops.py's inputs: uniform(-100, 100), mask 0.8."""
    rng = np.random.RandomState(seed)
    vals = rng.uniform(-100, 100, n).astype(np.float32)
    gid = rng.randint(0, s, n).astype(np.int32)
    mask = rng.rand(n) < 0.8
    if kind == "all_masked":
        mask[:] = False
    elif kind == "gid_out_of_range":
        gid = rng.randint(-5, s + 5, n).astype(np.int32)
    elif kind == "zipf":
        gid = zipf_gid(rng, n, s)
    elif kind == "one_segment":
        gid[:] = 0
    return vals, gid, mask


_CASES = [("random", 1000, 7), ("random", 4096, 300), ("random", 513, 1),
          ("all_masked", 512, 9), ("gid_out_of_range", 2048, 37),
          ("random", 100, 1000),     # num_segments above the row count
          # the cases the kernel's regimes make important: Zipf-hot
          # segments at the engine's 32,768-segment gate, every row in one
          # segment, a ragged tail (n % 4 != 0), views at an odd storage
          # offset
          ("zipf", 4096, 32768), ("one_segment", 4099, 1),
          ("random", 4095, 37), ("offset_view", 4097, 37)]
# Pallas tiling for the interpret run (default 256 rows x 128 segments)
_BLOCKS = {32768: (1024, 8192)}


@pytest.mark.parametrize("kind,n,s", _CASES)
def test_plain_matches_pallas_interpret(kind, n, s):
    vals, gid, mask = _case(kind, n, s)
    tv, tg, tm = (torch.from_numpy(x) for x in (vals, gid, mask))
    if kind == "offset_view":
        # contiguous views at storage offset 1, as the engine may pass
        vals, gid, mask = vals[1:], gid[1:], mask[1:]
        tv, tg, tm = tv[1:], tg[1:], tm[1:]
        assert tv.storage_offset() == 1 and tv.is_contiguous()
    block_rows, block_segs = _BLOCKS.get(s, (256, 128))
    want = np.asarray(jseg.segment_sum_f32(
        jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), s,
        block_rows=block_rows, block_segs=block_segs, interpret=True))
    launches = tseg.LAUNCHES_F32
    got = tseg.segment_sum_f32(tv, tg, tm, s)
    assert tseg.LAUNCHES_F32 == launches      # CPU tensors never launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (s,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-2)
    if kind == "all_masked":
        assert not got.any()


def test_wrapper_checks_its_inputs():
    v = torch.zeros(4)
    g = torch.zeros(4, dtype=torch.int32)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        tseg.segment_sum_f32(v.double(), g, m, 2)
    with pytest.raises(ValueError):
        tseg.segment_sum_f32(v, g[:3], m, 2)
    with pytest.raises(ValueError):
        tseg.segment_sum_f32(v, g, m, 0)


def test_bench_on_the_cpu():
    """The bench entry point runs on the CPU when asked and prints one
    JSON line of the four times."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    out = subprocess.run(
        [sys.executable, "-m", "ndstpu_torch.ops.bench", "4096", "64",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        check=True).stdout
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["rows"] == 4096 and rec["segs"] == 64
    assert rec["device"] == "cpu" and rec["timer"] == "host clock"
    for k in ("library_f32_ms", "kernel_f32_ms", "library_i64_ms",
              "kernel_i64_ms"):
        assert rec[k] > 0


def test_bench_inputs_follow_the_jax_script():
    """Same RandomState(0) draws as scripts/pallas_bench.py."""
    x = bench.inputs(1000, 32, "cpu")
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(
        x["vals_f"].numpy(), rng.uniform(-100, 100, 1000).astype(np.float32))
    rng.randint(-10 ** 9, 10 ** 9, 1000)
    np.testing.assert_array_equal(x["gid"].numpy(),
                                  rng.randint(0, 32, 1000).astype(np.int32))
