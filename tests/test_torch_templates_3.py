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
# four store-channel reports, and the templates that need only windows or
# grouping sets
_ACCEPTED_BEFORE = (1, 3, 7, 13, 25, 26, 29, 30, 37, 42, 46, 48, 52, 55,
                    64, 65, 68, 73, 81, 82, 96)
_STORE_CHANNEL = (9, 43, 88, 93)
_WINDOWS_AND_GROUPING_SETS = (12, 18, 20, 22, 27, 36, 44, 47, 51, 53, 57,
                              63, 67, 70, 86, 89, 98)
# the families still to port, each template by its first refusal
_STILL_TO_PORT = {
    "SetOp": (2, 4, 5, 8, 11, 14, 23, 33, 38, 49, 56, 60, 66, 71, 74, 75,
              76, 77, 80, 87),
    "Distinct": (6, 41, 54),
    "distinct aggregate": (16, 28, 94, 95),
}


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
            _WINDOWS_AND_GROUPING_SETS}
    assert want <= accepted, sorted(want - accepted)


def test_refused_set_is_the_families_still_to_port(refusals):
    """The port refuses exactly the set-op, distinct and distinct-aggregate
    templates, each for its family."""
    def family(u):
        if u.code == "NDS207" and "distinct" in str(u):
            return "distinct aggregate"
        return u.node
    got = {tpl: family(u) for tpl, u in refusals.items()}
    want = {f"query{i}": fam for fam, ids in _STILL_TO_PORT.items()
            for i in ids}
    assert got == want


@pytest.mark.parametrize("q", ["q3", "q42", "q52", "q55", "q9", "q43", "q88",
                               "q93", "q36", "q47", "q67", "q89", "q98"])
def test_card_queries_are_the_rendered_templates(q):
    """The texts chip_smoke.py runs on the card are the templates as
    streamgen renders them (whitespace aside)."""
    import re

    from ndstpu_torch.queries import QUERIES, STORE_QUERIES, WINDOW_QUERIES
    text = {**QUERIES, **STORE_QUERIES, **WINDOW_QUERIES}[q]
    (want,) = render(f"query{q[1:]}")
    assert re.sub(r"\s+", " ", text).strip() == \
        re.sub(r"\s+", " ", want).strip()
