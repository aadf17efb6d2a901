"""The port's query corpus and value pools are its own copies of the JAX
package's: the same 103 rendered parts, byte-identical templates and
``dists.json``, read from under ``ndstpu_torch/`` only."""

import builtins
import importlib
import io
import os
import pathlib
import re

import pytest

from ndstpu.queries import streamgen as jax_streamgen
from ndstpu_torch import datagen
from ndstpu_torch.engine import plan as lp
from ndstpu_torch.engine.session import Session
from ndstpu_torch.queries import Q9_BUCKETS, STORE_QUERIES, corpus, streamgen

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_corpus_is_the_jax_packages():
    ours = corpus()
    theirs = jax_streamgen.render_power_corpus()
    assert len(ours) == len(theirs) == 103
    assert ours == theirs


def test_rendering_defaults_match():
    assert streamgen.BENCH_RNGSEED == jax_streamgen.BENCH_RNGSEED
    assert streamgen.list_templates() == jax_streamgen.list_templates()
    assert len(streamgen.list_templates()) == 99


def test_dists_json_is_a_byte_copy():
    ours = ROOT / "ndstpu_torch" / "datagen" / "dists.json"
    theirs = ROOT / "ndstpu" / "datagen" / "dists.json"
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", jax_streamgen.list_templates())
def test_template_is_a_byte_copy(name):
    ours = streamgen.TEMPLATE_DIR / name
    theirs = jax_streamgen.TEMPLATE_DIR / name
    assert ours.parent == ROOT / "ndstpu_torch" / "queries" / "templates"
    assert ours.read_bytes() == theirs.read_bytes()


def test_q9_buckets_are_the_rendered_ones():
    text = re.sub(r"\s+", " ", STORE_QUERIES["q9"])
    found = re.findall(r"between (\d+) and (\d+)\) > (\d+)", text)
    assert tuple(tuple(map(int, f)) for f in found) == Q9_BUCKETS


def test_port_opens_no_path_under_the_jax_package(monkeypatch):
    """Loading the generator's pools, rendering the corpus and generating
    a warehouse read files under ``ndstpu_torch/`` only."""
    opened = []
    real_open = builtins.open

    def spy(file, *args, **kwargs):
        if isinstance(file, (str, os.PathLike)):
            opened.append(pathlib.Path(file).resolve())
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.setattr(io, "open", spy)
    from ndstpu_torch.datagen import model
    importlib.reload(model)
    importlib.reload(streamgen)
    assert len(streamgen.render_power_corpus()) == 103
    datagen.generate(0.01, seed=3, device="cpu",
                     tables=["customer_address", "item"])
    assert opened
    port = ROOT / "ndstpu_torch"
    assert all(p.is_relative_to(port) for p in opened), \
        [str(p) for p in opened if not p.is_relative_to(port)]
    assert port / "datagen" / "dists.json" in opened
    assert not any(p.is_relative_to(ROOT / "ndstpu") for p in opened)


def _joins(plan):
    if isinstance(plan, lp.Join):
        yield plan
    for attr in ("child", "left", "right"):
        sub = getattr(plan, attr, None)
        if isinstance(sub, lp.Plan):
            yield from _joins(sub)


def test_q54_joins_its_customers_before_the_address_expansion(monkeypatch):
    """q54's store ⋈ customer_address on (county, state) is many to
    many: joined before the small my_customers CTE, it ran out of an
    80 GB card's memory at SF 30.  The join estimate now thins a
    subquery's fact rows by its filtered dimensions, so my_customers is
    joined before customer_address, and that join is by address key as
    well.  The optimizer reads only row counts: SF 20's stand in here."""
    cat = datagen.generate(0.01, seed=1, device="cpu")
    n = datagen.sizes(20)

    class Rows:
        def __init__(self, rows):
            self.num_rows = rows

    monkeypatch.setattr(cat, "get", lambda t: Rows(n[t]))
    plan = Session(cat, device="cpu").plan(dict(corpus())["query54"])[0]
    address = [j for j in _joins(plan)
               if any("ca_county" in repr(k) for k in j.keys)]
    assert len(address) == 1
    (join,) = address
    assert any("ca_address_sk" in repr(k) for k in join.keys)
    assert "my_customers.c_customer_sk" in repr(join.left)


def test_join_estimate_thins_by_filtered_dimensions():
    """A key join keeps its larger side's rows times the fraction of the
    smaller side its filters keep."""
    from ndstpu_torch.engine import expr as ex
    from ndstpu_torch.engine.optimizer import _estimate_rows

    class Cat:
        def get(self, t):
            return type("T", (), {"num_rows": {"f": 1e6, "d": 1e3}[t]})()

        def __contains__(self, t):
            return True

    fact = lp.Scan("f", "f", ["k"])
    dim = lp.Scan("d", "d", ["k"])
    kept = lp.Filter(dim, ex.Literal(True))
    key = [(ex.ColumnRef("f.k"), ex.ColumnRef("d.k"))]
    assert _estimate_rows(lp.Join(fact, dim, "inner", key), Cat()) == 1e6
    assert _estimate_rows(lp.Join(fact, kept, "inner", key), Cat()) == \
        1e6 / 20
    assert _estimate_rows(lp.Join(fact, kept, "cross", []), Cat()) == 1e6
