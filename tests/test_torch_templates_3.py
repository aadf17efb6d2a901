"""Template differential, part 3 of 3: see
tests/test_torch_templates_common.py."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from test_torch_templates_common import (  # noqa: F401
    check_accepted, check_refused, check_template, part, refusals, render,
    sessions)


@pytest.mark.parametrize("tpl", part(3))
def test_template(sessions, tpl):  # noqa: F811
    check_template(sessions, tpl)


@pytest.fixture(scope="module")
def refused(sessions):  # noqa: F811
    """Each template of this third the port refuses -> its Unsupported."""
    return refusals(sessions, part(3))


def test_accepted_set(refused):
    check_accepted(refused, part(3))


def test_refused_set_is_the_families_still_to_port(refused):
    check_refused(refused)


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
