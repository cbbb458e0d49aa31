"""Per-record JSON sidecars → chamber sample-index intervals (the port's
copy of ``scgrhc.io.sidecar``).

Interval semantics of the reference (recordutil.py:93-110):

* ``MacStTime`` / ``MacEndTime`` are ``"<date> HH:MM:SS"`` strings; only the
  time of day is parsed.
* ``ChamEvents_in_s`` maps event labels (``"<CHAMBER>_<suffix>"``) to seconds
  since the catheterization start.  A virtual ``END`` event at
  ``(MacEndTime - MacStTime)`` seconds is appended.
* Events are sorted by time; for each event whose label prefix (before the
  first ``_``) is the requested chamber, the interval runs from that event
  to the next one (of any chamber), in samples at 500 Hz via
  ``int(seconds * fs)``.
* A non-dict ``ChamEvents_in_s`` yields no intervals.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any

from scgrhc_torch.core import paths


def read_sidecar(record_name: str, processed_dir: str | None = None) -> dict[str, Any]:
    base = processed_dir if processed_dir is not None else paths.PROCESSED_DATA_PATH
    with open(os.path.join(base, f"{record_name}.json"), "r") as f:
        return json.load(f)


def chamber_intervals_from_sidecar(
    data: dict[str, Any], chamber: str, fs: int
) -> list[tuple[int, int]]:
    """Sidecar dict → [(start_sample, stop_sample), ...]."""
    intervals: list[tuple[int, int]] = []
    mac_st = datetime.strptime(data["MacStTime"].split()[1], "%H:%M:%S")
    mac_end = datetime.strptime(data["MacEndTime"].split()[1], "%H:%M:%S")
    cham_events = data["ChamEvents_in_s"]
    if isinstance(cham_events, dict):
        events = dict(cham_events)
        events["END"] = (mac_end - mac_st).total_seconds()
        ordered = sorted(events.items(), key=lambda x: x[1])
        for i, (label, seconds) in enumerate(ordered[:-1]):
            if label.split("_")[0] == chamber:
                intervals.append((int(seconds * fs), int(ordered[i + 1][1] * fs)))
    return intervals


def get_chamber_intervals(
    record_name: str, chamber: str, processed_dir: str | None = None
) -> list[tuple[int, int]]:
    """Sample-index intervals for when the catheter was in ``chamber``."""
    from scgrhc_torch.io.catalog import SAMPLE_FREQ

    return chamber_intervals_from_sidecar(
        read_sidecar(record_name, processed_dir), chamber, SAMPLE_FREQ
    )
