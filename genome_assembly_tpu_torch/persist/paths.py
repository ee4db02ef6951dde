"""Result/plot directory management (reference createAndSave.py:7-29)."""

from __future__ import annotations

import os


def create_paths(paths: list[tuple[str, str]]) -> list[str] | None:
    """For each (base, experiment_name), ensure the *parent* directory of
    base/experiment_name exists and return the joined paths.

    Mirrors the reference contract exactly (createAndSave.py:17-29): only the
    dirname of the joined path is created — the leaf itself is created by the
    writer — and an OSError prints and returns None.
    """
    out: list[str] = []
    for base, experiment_name in paths:
        joined = os.path.join(base, experiment_name)
        parent = os.path.dirname(joined)
        try:
            if parent and not os.path.exists(parent):
                os.makedirs(parent, exist_ok=True)
        except OSError as e:
            print(f"Error creating directory {parent}: {e}")
            return None
        out.append(joined)
    return out
