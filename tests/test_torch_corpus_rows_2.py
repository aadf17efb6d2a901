"""Corpus differential for the parts that find no row at the numbered
files' scale, part 2 of 2: each through the port and the JAX engine over
a larger warehouse, where it must find a row.  See
tests/test_torch_corpus_common.py."""

import pytest

from test_torch_corpus_common import (check_part, larger,  # noqa: F401
                                      rows_cases)

CASES = rows_cases(2)


@pytest.mark.parametrize("where,name", CASES, ids=[n for _, n in CASES])
def test_part_finds_rows(larger, where, name):  # noqa: F811
    check_part(larger(where), name, empty=())
