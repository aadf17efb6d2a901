"""``--static_check`` on the port: the static analyzer
(``ndstpu_torch.analysis``) against the JAX package's, and the gate of the
power and throughput runs.

* ``analyze_plan`` gives the JAX package's diagnostics (code, severity,
  plan path, message, in order) on every part of the power corpus, each
  planned over its package's zero-row schema catalog.
* ``power.static_check`` refuses what the JAX package's refuses on its
  accelerator engines (``tests/test_analysis.py::test_static_check_gate``):
  a part the planner rejects (``NDS000``) and one that cannot lower.  The
  JAX gate skips its ``cpu`` engine, a numpy interpreter; the port's
  ``--device cpu`` runs the card's executor, so the port gates on every
  device.
* A power command line whose stream holds such a part exits before any
  query with the JAX command's text (its engine named by the device), the
  same ``STATIC CHECK`` lines printed; the throughput run's inproc mode
  exits likewise; a stream the analyzer passes runs."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import os
import subprocess

import pytest

from ndstpu import analysis as jax_analysis
from ndstpu.engine.session import Session as JaxSession
from ndstpu_torch import analysis
from ndstpu_torch.engine.session import Session
from ndstpu_torch.harness import power, scheduler
from ndstpu_torch.queries import corpus
from test_torch_corpus_common import jax_warehouse

SQL = dict(corpus())


@pytest.fixture(scope="module")
def sessions():
    return (JaxSession(jax_analysis.schema_catalog(), backend="cpu"),
            Session(analysis.schema_catalog(), device="cpu"))


def _diags(res):
    return [(d.code, d.severity, d.path, d.message) for d in res.diagnostics]


@pytest.mark.parametrize("name", list(SQL))
def test_diagnostics_equal_the_jax_analyzer(sessions, name):
    jax_sess, sess = sessions
    want = jax_analysis.analyze_sql(jax_sess, name, SQL[name],
                                    scale_factor=1.0)
    got = analysis.analyze_sql(sess, name, SQL[name], scale_factor=1.0)
    assert _diags(got) == _diags(want)
    assert (got.verdict, got.fallback_codes) == \
        (want.verdict, want.fallback_codes)
    assert not got.errors


GATED = {
    "q_good": "select ss_item_sk, count(*) from store_sales "
              "group by ss_item_sk",
    "q_planfail": "select ss_item_sk from store_sales full join "
                  "store_returns on ss_ticket_number <> sr_ticket_number",
    "q_lowerfail": "select upper(ss_item_sk) as u from store_sales",
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_static_check_gate(sessions, device, capsys):
    from ndstpu.harness import power as jax_power
    jax_sess, sess = sessions
    assert power.static_check(sess, GATED, device) == \
        jax_power.static_check(jax_sess, GATED, "tpu") == \
        ["q_planfail", "q_lowerfail"]
    out = capsys.readouterr().out.splitlines()
    port = [line for line in out[:len(out) // 2]
            if line.startswith("STATIC CHECK")]
    jax = [line for line in out[len(out) // 2:]
           if line.startswith("STATIC CHECK")]
    assert port == jax and len(port) >= 2


def _stream(path, parts):
    path.write_text("".join(
        f"-- start query {i} in stream 0 using template {name}.tpl\n"
        f"{sql};\n" for i, (name, sql) in enumerate(parts.items(), 1)))
    return path


def test_power_run_refuses_with_the_jax_text(tmp_path, tmp_path_factory,
                                             capsys):
    stream = _stream(tmp_path / "query_0.sql",
                     {"query3": SQL["query3"].rstrip().rstrip(";"),
                      "qbad": GATED["q_lowerfail"]})
    with pytest.raises(SystemExit) as exc:
        power.main([str(stream), "-", str(tmp_path / "t.csv"),
                    "--generate", "0.002", "--device", "cpu",
                    "--static_check"])
    port_lines = [line for line in capsys.readouterr().out.splitlines()
                  if line.startswith("STATIC CHECK")]
    assert not (tmp_path / "t.csv").exists()
    wh = jax_warehouse(tmp_path_factory)
    jax = subprocess.run(
        ["python", "-m", "ndstpu.harness.power", str(stream), str(wh),
         str(tmp_path / "jax.csv"), "--engine", "tpu", "--static_check"],
        capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.getcwd()))
    assert jax.returncode != 0
    assert str(exc.value.code) == jax.stderr.strip().splitlines()[-1] \
        .replace("on tpu", "on cpu")
    assert port_lines == [line for line in jax.stdout.splitlines()
                          if line.startswith("STATIC CHECK")]
    assert port_lines and all("qbad" in line for line in port_lines)


def test_power_run_passes_the_corpus_parts(tmp_path, capsys):
    stream = _stream(tmp_path / "query_0.sql",
                     {n: SQL[n].rstrip().rstrip(";")
                      for n in ("query3", "query42")})
    power.main([str(stream), "-", str(tmp_path / "t.csv"), "--generate",
                "0.002", "--device", "cpu", "--static_check"])
    assert "static check passed: 2 part(s) lower on cpu" in \
        capsys.readouterr().out.splitlines()
    log = (tmp_path / "t.csv").read_text()
    assert "query3" in log and "query42" in log


def test_throughput_inproc_gate(tmp_path):
    for sid in ("1", "2"):
        _stream(tmp_path / f"query_{sid}.sql",
                {"query3": SQL["query3"].rstrip().rstrip(";"),
                 **({"qbad": GATED["q_lowerfail"]} if sid == "2" else {})})
    cmd = ["python", "-m", "ndstpu_torch.harness.power",
           str(tmp_path / "query_{}.sql"), "-", str(tmp_path / "t_{}.csv"),
           "--generate", "0.002", "--device", "cpu", "--static_check"]
    with pytest.raises(SystemExit, match="static check failed: query "
                       "part\\(s\\) qbad cannot lower on cpu"):
        scheduler.run_streams_inproc(["1", "2"], cmd)


def test_analysis_and_the_card_scripts_load_no_jax():
    """The analyzer, the profile entry point and the scripts that run
    the port on a card import nothing of JAX or of the JAX package (the
    card's machine has neither)."""
    import ast
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    scripts = sorted((root / "scripts").glob("torch_*.py"))
    assert len(scripts) >= 2
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not [n for n in names if n.split(".")[0] in
                        ("jax", "jaxlib", "ndstpu")], path.name
    code = ("import sys, ndstpu_torch.analysis, ndstpu_torch.profile\n"
            "from ndstpu_torch.harness import power\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'ndstpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
