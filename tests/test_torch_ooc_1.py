"""The out-of-core corpus check, part 1 of 3: every third part of the
power corpus through the port's chunked session against its resident
answer (tests/test_torch_ooc_common.py)."""

import test_torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

from test_torch_ooc_common import check_ooc_part, part, warehouse  # noqa: F401


@pytest.mark.parametrize("name", part(1))
def test_part_chunked_equals_resident(warehouse, name, monkeypatch):  # noqa: F811
    check_ooc_part(warehouse, name, monkeypatch)
