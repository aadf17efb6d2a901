"""Template differential, part 3 of 3: see
tests/test_torch_templates_common.py."""

import pytest

from test_torch_templates_common import (  # noqa: F401
    TEMPLATES, check_template, part, render, run_port, sessions)


@pytest.mark.parametrize("tpl", part(3))
def test_template(sessions, tpl):  # noqa: F811
    check_template(sessions, tpl)


# the templates the port accepted before (the q3 family's slice) and the
# four store-channel reports of this slice
_ACCEPTED_BEFORE = (1, 3, 7, 13, 25, 26, 29, 30, 37, 42, 46, 48, 52, 55,
                    64, 65, 68, 73, 81, 82, 96)
_STORE_CHANNEL = (9, 43, 88, 93)


def test_accepted_set(sessions):  # noqa: F811
    accepted = {tpl for tpl in TEMPLATES
                if run_port(sessions[1], tpl) is not None}
    want = {f"query{i}" for i in _ACCEPTED_BEFORE + _STORE_CHANNEL}
    assert want <= accepted, sorted(want - accepted)


@pytest.mark.parametrize("q", ["q3", "q42", "q52", "q55", "q9", "q43", "q88",
                               "q93"])
def test_card_queries_are_the_rendered_templates(q):
    """The texts chip_smoke.py runs on the card are the templates as
    streamgen renders them (whitespace aside)."""
    import re

    from ndstpu_torch.queries import QUERIES, STORE_QUERIES
    text = {**QUERIES, **STORE_QUERIES}[q]
    (want,) = render(f"query{q[1:]}")
    assert re.sub(r"\s+", " ", text).strip() == \
        re.sub(r"\s+", " ", want).strip()
