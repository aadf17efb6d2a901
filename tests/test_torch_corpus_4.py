"""Corpus differential, part 4 of 5: see
tests/test_torch_corpus_common.py."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from test_torch_corpus_common import check_part, part, sessions  # noqa: F401


@pytest.mark.parametrize("name", part(4))
def test_part(sessions, name):  # noqa: F811
    check_part(sessions, name)
