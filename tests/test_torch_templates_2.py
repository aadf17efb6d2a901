"""Template differential, part 2 of 3: see
tests/test_torch_templates_common.py."""

import pytest

from test_torch_templates_common import check_template, part, sessions  # noqa: F401


@pytest.mark.parametrize("tpl", part(2))
def test_template(sessions, tpl):  # noqa: F811
    check_template(sessions, tpl)
