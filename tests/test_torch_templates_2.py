"""Template differential, part 2 of 3: see
tests/test_torch_templates_common.py."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from test_torch_templates_common import (  # noqa: F401
    check_accepted, check_refused, check_template, part, refusals,
    sessions)


@pytest.mark.parametrize("tpl", part(2))
def test_template(sessions, tpl):  # noqa: F811
    check_template(sessions, tpl)


@pytest.fixture(scope="module")
def refused(sessions):  # noqa: F811
    """Each template of this third the port refuses -> its Unsupported."""
    return refusals(sessions, part(2))


def test_accepted_set(refused):
    check_accepted(refused, part(2))


def test_refused_set_is_the_families_still_to_port(refused):
    check_refused(refused)
