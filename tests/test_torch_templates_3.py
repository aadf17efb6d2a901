"""Template differential, part 3 of 3: see
tests/test_torch_templates_common.py."""

import pytest

from ndstpu_torch.engine import torchexec
from test_torch_templates_common import (  # noqa: F401
    TEMPLATES, check_template, part, render, sessions)


@pytest.mark.parametrize("tpl", part(3))
def test_template(sessions, tpl):  # noqa: F811
    check_template(sessions, tpl)


# the templates the port accepted before (the q3 family's slice), the
# four store-channel reports, the templates that needed only windows or
# grouping sets, and those that needed set operations, DISTINCT or
# distinct aggregates
_ACCEPTED_BEFORE = (1, 3, 7, 13, 25, 26, 29, 30, 37, 42, 46, 48, 52, 55,
                    64, 65, 68, 73, 81, 82, 96)
_STORE_CHANNEL = (9, 43, 88, 93)
_WINDOWS_AND_GROUPING_SETS = (12, 18, 20, 22, 27, 36, 44, 47, 51, 53, 57,
                              63, 67, 70, 86, 89, 98)
_SETOPS_AND_DISTINCT = (2, 4, 5, 6, 8, 11, 14, 16, 23, 28, 33, 38, 41, 49,
                        54, 56, 60, 66, 71, 74, 75, 76, 77, 80, 87, 94, 95)


@pytest.fixture(scope="module")
def refusals(sessions):  # noqa: F811
    """Each template the port refuses -> the Unsupported it raised."""
    out = {}
    for tpl in TEMPLATES:
        for sql in render(tpl):
            try:
                sessions[1].sql(sql)
            except torchexec.Unsupported as u:
                out[tpl] = u
                break
    return out


def test_accepted_set(refusals):
    accepted = set(TEMPLATES) - set(refusals)
    want = {f"query{i}" for i in _ACCEPTED_BEFORE + _STORE_CHANNEL +
            _WINDOWS_AND_GROUPING_SETS + _SETOPS_AND_DISTINCT}
    assert want <= accepted, sorted(want - accepted)


def test_refused_set_is_the_families_still_to_port(refusals):
    """No family is left to port: the port refuses no template (every
    part of the corpus runs through the port, the CPU analog of
    tests/test_jaxexec.py::test_corpus_compile_coverage)."""
    got = {tpl: (u.node, u.code, str(u)) for tpl, u in refusals.items()}
    assert got == {}


@pytest.mark.parametrize("q", ["q3", "q42", "q52", "q55", "q9", "q43", "q88",
                               "q93", "q36", "q47", "q67", "q89", "q98",
                               "q2", "q28", "q41", "q76"])
def test_card_queries_are_the_rendered_templates(q):
    """The texts chip_smoke.py runs on the card are the templates as
    streamgen renders them (whitespace aside)."""
    import re

    from ndstpu_torch.queries import (QUERIES, SETOP_QUERIES, STORE_QUERIES,
                                      WINDOW_QUERIES)
    text = {**QUERIES, **STORE_QUERIES, **WINDOW_QUERIES,
            **SETOP_QUERIES}[q]
    (want,) = render(f"query{q[1:]}")
    assert re.sub(r"\s+", " ", text).strip() == \
        re.sub(r"\s+", " ", want).strip()
