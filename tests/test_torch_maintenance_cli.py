"""The port's maintenance command line on the CPU:
``python -m ndstpu_torch.harness.maintenance``'s ``main``.

A whole run with ``--generate 0.01 --device cpu --update 1`` (the
warehouse and the refresh set generated), and one whose refresh set is a
folder of the JAX package's generator's ``.dat`` files (read with the
port's csvio): the time log has the reference's shape (the header
``application_id,query,time/s``, one row a function in milliseconds, the
start, end and elapsed seconds), the JSON summaries carry each function's
status (LF_CR, LF_SR and LF_WR ``Failed``, as in the JAX package), and
the JAX package's ``bench.get_refresh_time`` and
``get_maintenance_time`` read the log.  Then ``--dm_funcs``, the error
for an unknown function, the refused ``--micro_batch`` and the argument
checks.  The runs after the first take a fork of the warehouse the first
generated in place of generating their own."""

import contextlib
import csv
import io
import json

import pytest

from ndstpu.harness import bench
from ndstpu_torch import datagen
from ndstpu_torch.harness import maintenance as dm
from test_torch_dm_common import FAILING, SCALE, fork, ndsgen_refresh

HEADER = ["application_id", "query", "time/s"]
TAIL = ["Data Maintenance Start Time", "Data Maintenance End Time",
        "Data Maintenance Time"]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """One whole run with ``--generate 0.01 --update 1``: its folder, its
    standard output and a fork of the warehouse it generated, taken
    before its statements replaced any table."""
    made = []
    real = datagen.generate

    def keep(*a, **k):
        cat = real(*a, **k)
        made.append(fork(cat))
        return cat
    d = tmp_path_factory.mktemp("generated")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setattr(datagen, "generate", keep)
        dm.main(["-", "-", str(d / "dm.csv"), "--generate", f"{SCALE:g}",
                 "--update", "1", "--device", "cpu",
                 "--json_summary_folder", str(d / "j")])
    (cat,) = made
    return d, out.getvalue(), cat


@pytest.fixture
def forked(generated, monkeypatch):
    """``--generate`` hands the run a fork of the generated run's
    warehouse."""
    monkeypatch.setattr(datagen, "generate",
                        lambda *a, **k: fork(generated[2]))


def _log(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _statuses(folder):
    out = {}
    for p in folder.glob("*.json"):
        s = json.loads(p.read_text())
        out[s["query"]] = s["queryStatus"]
    return out


def _check_run(log, summaries, funcs=dm.DM_FUNCS):
    header, rows = _log(log)
    assert header == HEADER
    assert [r[1] for r in rows] == list(funcs) + TAIL
    assert len({r[0] for r in rows}) == 1
    assert all(int(r[2]) >= 0 for r in rows[:len(funcs)])
    start, end, elapsed = (float(r[2]) for r in rows[len(funcs):])
    assert elapsed == pytest.approx(end - start)
    status = _statuses(summaries)
    assert status == {fn: ["Failed" if fn in FAILING else "Completed"]
                      for fn in funcs}
    return elapsed


def test_generated_run(generated, tmp_path):
    folder, out, _cat = generated
    log = folder / "dm.csv"
    elapsed = _check_run(log, folder / "j")
    assert out.count("====== Run ") == 11
    assert "Rows of LF_SS: {'store_sales': [" in out
    # the JAX package's benchmark reads the port's log
    assert bench.get_refresh_time(str(log)) == pytest.approx(elapsed)
    base = tmp_path / "dm"
    (tmp_path / "dm_1.csv").write_text(log.read_text())
    assert bench.get_maintenance_time(str(base), 3, 1) == \
        bench.round_up_to_nearest_10_percent(elapsed)


def test_refresh_folder(tmp_path, forked):
    folder = ndsgen_refresh(tmp_path / "upd")
    log = tmp_path / "dm.csv"
    dm.main(["-", str(folder), str(log), "--generate", f"{SCALE:g}",
             "--device", "cpu", "--json_summary_folder",
             str(tmp_path / "j")])
    _check_run(log, tmp_path / "j")


def test_dm_funcs(tmp_path, forked, capsys):
    log = tmp_path / "dm.csv"
    dm.main(["-", "-", str(log), "--generate", f"{SCALE:g}", "--update",
             "1", "--device", "cpu", "--dm_funcs", "LF_SS,DF_SS,LF_SR",
             "--json_summary_folder", str(tmp_path / "j")])
    _check_run(log, tmp_path / "j", funcs=["LF_SS", "DF_SS", "LF_SR"])
    out = capsys.readouterr().out
    assert "Rows of DF_SS: {'store_sales': [" in out


def test_unknown_function(tmp_path, forked):
    with pytest.raises(ValueError, match="unknown DM functions"):
        dm.main(["-", "-", str(tmp_path / "dm.csv"), "--generate",
                 f"{SCALE:g}", "--update", "1", "--device", "cpu",
                 "--dm_funcs", "LF_SS,LF_XX"])
    assert not (tmp_path / "dm.csv").exists()


@pytest.mark.parametrize("argv, says", [
    (["-", "-", "t.csv", "--generate", "1", "--update", "1",
      "--micro_batch"], "ingest slice"),
    (["-", "-", "t.csv", "--update", "1"], "warehouse directory"),
    (["wh", "-", "t.csv", "--generate", "1", "--update", "1"],
     "warehouse directory"),
    (["-", "upd", "t.csv", "--generate", "1", "--update", "1"],
     "refresh data directory"),
    (["-", "-", "t.csv", "--generate", "1"], "refresh data directory"),
    (["wh", "-", "t.csv", "--update", "1"], "--generate"),
], ids=["micro_batch", "no-generate", "dir-and-generate",
        "dir-and-update", "no-update", "update-without-generate"])
def test_arguments_refused(argv, says, capsys):
    with pytest.raises(SystemExit) as e:
        dm.parse_args(argv)
    assert e.value.code == 2
    assert says in capsys.readouterr().err
