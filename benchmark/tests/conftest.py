"""Shared pieces of the benchmark's CPU tests: a tiny size of every cell.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
The ``gpu``-marked tests run on the card (``-m gpu``) and skip elsewhere.
"""

import pytest

# tiny sizes: T = 32, a few windows
SHRINK = {"config": {"segment_size": 0.064, "batch_size": 4, "train_windows": 16},
          "traffic": {"traced_steps": 2, "checked_steps": 2}}
CELLS = ("train.w06",)


@pytest.fixture(autouse=True)
def _tmpdir_env(tmp_path, monkeypatch):
    """Each test's temporary files under its own folder."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
