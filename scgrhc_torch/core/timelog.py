"""Timestamped log lines, format-compatible with the reference
(reference: timelog.py:3-10): ``"%c | HH:MM:SS-elapsed | message"``.

The format is a byte-level parity contract (stage banners and progress
lines are diffed against reference logs), so the output is pinned while
the implementation is our own.
"""

from __future__ import annotations

import time as _time


def _elapsed_hms(seconds: float) -> str:
    """Seconds → zero-padded ``HH:MM:SS`` (truncating, like the reference's
    divmod-of-float + int() formatting)."""
    whole = int(seconds)
    return f"{whole // 3600:02}:{whole // 60 % 60:02}:{whole % 60:02}"


def timelog(message: str, start_time: float) -> str:
    now = _time.strftime("%c")
    return f"{now} | {_elapsed_hms(_time.time() - start_time)} | {message}"
