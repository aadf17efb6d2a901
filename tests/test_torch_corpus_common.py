"""Shared part of the corpus differential (tests/test_torch_corpus_
{1,2,3,4,5}.py and tests/test_torch_corpus_rows_{1,2}.py): every part of the
power corpus through the port and the JAX engine, over the port's own
generated warehouse.

The warehouse is ``ndstpu_torch.datagen.generate(SCALE, seed=1)`` on the
CPU, all 25 tables; the JAX engine reads the same numpy columns through a
``loader.Catalog``.  Each of the five numbered files takes a fifth of the
103 parts (``render_power_corpus()``, rngseed 07291122510, stream 0) and
parametrises over it.  A part passes when the port runs it twice with no
exception (discovery, then a replay of its compiled plan at the padded
capacities discovery recorded), each result agrees with
``Session(backend="tpu")`` under
``tests/test_jaxexec.py::assert_tables_match`` (in order where the plan
ends in a sort), and it comes back empty exactly when it is one of
``EMPTY``, the parts the generator's models leave without a row at this
scale.  The parts of ``EMPTY`` that a larger warehouse gives rows
(``FEW_ROWS``) are held the same way there, where each must find a
row.  This module holds no tests itself."""

import contextlib

import pytest
import torch
from torch.overrides import TorchFunctionMode

from ndstpu.engine import columnar as jax_columnar
from ndstpu.engine.session import Session as JaxSession
from ndstpu.io import loader
from ndstpu.schema import DType as JaxDType
from ndstpu_torch import datagen
from ndstpu_torch.engine.plan import fixes_order
from ndstpu_torch.engine.session import Session
from ndstpu_torch.ops import segsum
from ndstpu_torch.queries import corpus
from test_jaxexec import assert_tables_match

SCALE = 0.01
SQL = dict(corpus())
NAMES = list(SQL)
PARTS = 5

# the parts with no row at SCALE: values or ranges the generator's models
# never make at any scale (q56's colors, q53's and q63's brands, q62's and
# q65's months before the sales window), or too few rows at this size
# (one store, four reasons, 1,962 items)
EMPTY = {
    "query1", "query8", "query24_part1", "query24_part2", "query31", "query34",
    "query36", "query37", "query39_part2", "query41", "query44", "query49",
    "query53", "query54", "query56", "query58", "query62", "query63",
    "query64", "query65", "query68", "query84", "query85", "query91",
    "query93", "query99",
}
# the parts of EMPTY that a larger warehouse gives rows, for each of the
# two rows files: (scale, seed) -> the parts held there; the rest of EMPTY
# find no row in any of these
FEW_ROWS = (
    {(0.3, 1): ("query31", "query36", "query37", "query39_part2", "query49",
                "query58", "query64", "query68", "query84", "query91")},
    {(1, 1): ("query1", "query41", "query85", "query93"),
     (1, 3): ("query54",)},
)


def part(i: int):
    """The i-th fifth (1-based) of the corpus parts: every fifth part,
    so that the heavy templates spread over the five files."""
    return NAMES[i - 1::PARTS]


def jax_catalog(cat) -> loader.Catalog:
    """The JAX package's catalog over the numpy columns of the port's
    CPU catalog ``cat``."""
    out = loader.Catalog()
    for name, table in cat.tables.items():
        out.register(name, jax_columnar.Table({
            c: jax_columnar.Column(
                col.data.numpy(),
                JaxDType(col.ctype.kind, precision=col.ctype.precision,
                         scale=col.ctype.scale),
                None if col.valid is None else col.valid.numpy(),
                col.dictionary)
            for c, col in table.columns.items()}))
    return out


def make_sessions(scale: float, seed: int):
    """(JAX session, port session) over one generated warehouse."""
    cat = datagen.generate(scale, seed=seed, device="cpu")
    return JaxSession(jax_catalog(cat), backend="tpu"), Session(
        cat, device="cpu")


@pytest.fixture(scope="module")
def sessions():
    return make_sessions(SCALE, 1)


def rows_cases(i: int):
    """The (warehouse, part) cases of the i-th (1-based) rows file."""
    return [(where, name) for where, names in FEW_ROWS[i - 1].items()
            for name in names]


@pytest.fixture(scope="module")
def larger():
    """(scale, seed) -> sessions, one warehouse held at a time."""
    made = {}

    def get(where):
        if where not in made:
            made.clear()
            made[where] = make_sessions(*where)
        return made[where]
    return get


# torch calls that wait for the device or copy from the host: a CUDA
# graph capture refuses them, so the replay path must make none
_SYNCS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.__int__,
          torch.Tensor.__float__, torch.Tensor.__index__,
          torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu,
          torch.nonzero, torch.Tensor.nonzero, torch.argwhere,
          torch.unique, torch.Tensor.unique, torch.masked_select,
          torch.isin, torch.as_tensor, torch.tensor, torch.from_numpy}


def _indexes(idx):
    return idx if isinstance(idx, tuple) else (idx,)


class NoHostSync(TorchFunctionMode):
    """Raises on a torch call that would sync with the device or copy
    from the host (``_SYNCS``, a boolean-mask index, a slice bounded by a
    tensor, an assignment of a Python value into a tensor, which copies
    it from the host).  The segment-sum kernel's CPU stand-in is let
    through: on the card that call is the kernel."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _SYNCS:
            raise AssertionError(f"host sync in replay: {func.__name__}")
        if func is torch.Tensor.__setitem__ and \
                not isinstance(args[2], torch.Tensor):
            raise AssertionError("host copy in replay: a Python value "
                                 "assigned into a tensor")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            for i in _indexes(args[1]):
                if isinstance(i, torch.Tensor) and i.dtype == torch.bool or \
                        isinstance(i, slice) and any(
                            isinstance(x, torch.Tensor)
                            for x in (i.start, i.stop, i.step)):
                    raise AssertionError("host sync in replay: a mask or "
                                         "tensor-bounded index")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def replays_without_sync(exe):
    """Run ``exe``'s replays under :class:`NoHostSync` (the executor's own
    read-back after a replay is outside it)."""
    run, kernel = exe._replay_run, segsum.segment_sum_decimal

    def guarded(cp, bufs, values):
        with NoHostSync():
            return run(cp, bufs, values)

    def stand_in(*args):
        with torch._C.DisableTorchFunction():
            return kernel(*args)

    exe._replay_run = guarded
    segsum.segment_sum_decimal = stand_in
    try:
        yield
    finally:
        del exe._replay_run
        segsum.segment_sum_decimal = kernel


def check_part(sessions, name: str, empty=EMPTY):
    """``name`` through both engines: the port's first run (discovery)
    and its second (the replay of what it discovered, which must make no
    host sync) each agree with the JAX engine, and the part is empty
    exactly when it is one of ``empty``."""
    jax_sess, torch_sess = sessions
    sql = SQL[name]
    exe = torch_sess.executor
    first = torch_sess.sql(sql)
    replays, discoveries = exe.n_replays, exe.n_discoveries
    with replays_without_sync(exe):
        second = torch_sess.sql(sql)
    assert (exe.n_replays, exe.n_discoveries) == \
        (replays + 1, discoveries), "the second run did not replay"
    want = jax_sess.sql(sql)
    ordered = fixes_order(torch_sess.plan(sql)[0])
    for table in (first, second):
        assert want.column_names == table.column_names
        assert_tables_match(want, table, ordered=ordered)
    assert (first.num_rows == 0) == (name in empty), \
        f"{name}: {first.num_rows} rows"
