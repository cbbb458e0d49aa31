"""Dataset location (the port's copy of ``scgrhc.core.paths``).

The reference hard-codes ``/home/jesse/scg-rhc-database`` (reference:
pathutil.py:4-6).  We keep that as the default for drop-in compatibility but
allow overriding via the ``SCGRHC_DATA`` environment variable or
:func:`set_data_path`, which is what the tests' fake in-memory/on-disk record
stores use (SURVEY.md §4 "a fake record store standing in for the hard-coded
path").
"""

from __future__ import annotations

import os

_DEFAULT_DATA_PATH = os.path.join("/", "home", "jesse", "scg-rhc-database")

DATA_PATH = os.environ.get("SCGRHC_DATA", _DEFAULT_DATA_PATH)
PROCESSED_DATA_PATH = os.path.join(DATA_PATH, "processed_data")


def set_data_path(path: str) -> None:
    """Point the framework at a different dataset root (e.g. a test fixture)."""
    global DATA_PATH, PROCESSED_DATA_PATH
    DATA_PATH = path
    PROCESSED_DATA_PATH = os.path.join(path, "processed_data")
