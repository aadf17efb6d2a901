"""Preflight checks of the harness's command lines.

The two of the JAX package's ``ndstpu/check.py`` (``check_json_summary_
folder`` and ``check_query_subset_exists``, the reference's
check.py:136-152) that the power run needs, copied.  The rest of that
module builds the C++ generator ``ndsgen`` and stays with the JAX package.
"""

from __future__ import annotations

import os


def check_json_summary_folder(folder: str | None) -> None:
    """Require an empty/new folder for per-query JSON summaries
    (reference: check.py:136-145)."""
    if folder is None:
        return
    if os.path.exists(folder):
        if not os.path.isdir(folder):
            raise RuntimeError(f"{folder} is not a directory")
        if os.listdir(folder):
            raise RuntimeError(
                f"json summary folder {folder} is not empty; "
                "choose an empty or new folder"
            )
    else:
        os.makedirs(folder)


def check_query_subset_exists(query_dict: dict, subset: list[str]) -> bool:
    """All requested sub-queries must exist in the stream
    (reference: check.py:147-152)."""
    for q in subset:
        if q not in query_dict:
            raise RuntimeError(f"query {q} not found in the query stream")
    return True
