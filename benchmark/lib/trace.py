"""The traced window: ``torch.profiler`` over a stretch of the run, with CUDA
activity (CUPTI) on the card, read back from its Chrome trace.

The window is a host span named :data:`WINDOW` that ends after a device
synchronize, so every launch it makes finishes inside it.  From the trace:
the device's busy time (the union of kernel, copy and set intervals inside
the window), each kernel's time, the launch count, and the idle gaps, each
named by the innermost host operator running at its middle.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field

WINDOW = "benchmark_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # (name, start_us, dur_us)
    device_ops: list = field(default_factory=list)  # [[name, seconds], ...], top 10
    idle_gaps: list = field(default_factory=list)  # [[host op, seconds], ...], top 10

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names`` as a word."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(d for n, _, d in self.kernels if pat.search(n)) * 1e-6


class Traced:
    """Start and stop a traced window; :meth:`stop` returns its summary."""

    def __init__(self, tmpdir: str, on_card: bool):
        self.path = os.path.join(tmpdir, "benchmark_trace.json")
        self.on_card = on_card
        self.prof = self.span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.on_card:
            torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> TraceSummary:
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return summarize(events)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list[dict]) -> TraceSummary:
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])

    def clip(e):
        s = max(float(e["ts"]), w0)
        return s, min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)

    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    intervals = [iv for iv in map(clip, dev) if iv[1] > iv[0]]
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged)
    kernels = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev
               if e["cat"] == "kernel" and w0 <= float(e["ts"]) < w1]
    by_name: dict[str, float] = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d
    device_ops = sorted(([n, d * 1e-6] for n, d in by_name.items()), key=lambda x: -x[1])[:10]

    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:10]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime")]

    def label(gap):
        mid = (gap[0] + gap[1]) / 2
        inside = [e for e in host if float(e["ts"]) <= mid < float(e["ts"]) + float(e["dur"])]
        if not inside:
            return "host outside PyTorch operators"
        return min(inside, key=lambda e: float(e["dur"]))["name"]

    idle = [[label(g), (g[1] - g[0]) * 1e-6] for g in gaps]
    return TraceSummary((w1 - w0) * 1e-6, busy * 1e-6, kernels, device_ops, idle)
