"""The port's plan canonicalization against the JAX package's.

For each part of the power corpus, rendered under the two rngseeds and
two streams ``scripts/canon_audit.py`` probes (07291122510 and
19980713042, streams 0 and 1), the port plans the text on its zero-row
schema catalog (``ndstpu_torch.analysis.schema_catalog``) and
canonicalizes the plan (``ndstpu_torch.analysis.canon``); the JAX package
does the same on its own.  Per part and rendering, the two fingerprints
and cache keys must be equal; over the four renderings, the port's
fingerprints, cache keys and bindable and shape-affecting slot counts
must equal the committed ``CANON_AUDIT.json``.  No part differs on zero
rows, so the test lists no exception.
"""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import json
import pathlib

import pytest

from ndstpu import analysis as jax_analysis
from ndstpu.engine.session import Session as JaxSession
from ndstpu.queries import streamgen as jax_streamgen
from ndstpu_torch import analysis
from ndstpu_torch.analysis import canon
from ndstpu_torch.engine.session import Session
from ndstpu_torch.queries import corpus, streamgen

ROOT = pathlib.Path(__file__).resolve().parent.parent
RNGSEEDS = ("07291122510", "19980713042")
STREAMS = (0, 1)
AUDIT = json.loads((ROOT / "CANON_AUDIT.json").read_text())["parts"]


@pytest.fixture(scope="module")
def canons():
    """part -> [(port CanonResult, JAX CanonResult)], one a rendering."""
    jsess = JaxSession(jax_analysis.schema_catalog())
    jtables = jax_analysis.schema_tables()
    tsess = Session(analysis.schema_catalog(), device="cpu")
    out = {}
    for seed in RNGSEEDS:
        for stream in STREAMS:
            ported = streamgen.render_power_corpus(seed, stream)
            ref = jax_streamgen.render_power_corpus(rngseed=seed,
                                                    stream=stream)
            assert ported == ref
            for name, sql in ported:
                out.setdefault(name, []).append((
                    canon.canonicalize(tsess.plan(sql)[0], query=name),
                    jax_analysis.canonicalize(jsess.plan(sql)[0],
                                              tables=jtables, query=name)))
    return out


@pytest.mark.parametrize("name", [n for n, _ in corpus()])
def test_canonical_keys_equal_the_reference(canons, name):
    pairs = canons[name]
    assert len(pairs) == len(RNGSEEDS) * len(STREAMS)
    for got, want in pairs:
        assert (got.fingerprint, got.cache_key) == \
            (want.fingerprint, want.cache_key)
        assert got.values == want.values
        assert [(s.slot, s.kind, s.code, repr(s.ctype)) for s in got.slots] \
            == [(s.slot, s.kind, s.code, repr(s.ctype)) for s in want.slots]
    audit = AUDIT[name]
    ports = [got for got, _ in pairs]
    assert sorted({c.fingerprint for c in ports}) == audit["fingerprints"]
    assert sorted({c.cache_key for c in ports}) == audit["cache_keys"]
    assert max(len(c.bindable) for c in ports) == audit["bindable"]
    assert max(len(c.shape_affecting) for c in ports) == audit["shape"]
