"""Persistent SCG→RHC inference daemon, the PyTorch counterpart of
``scgrhc.pipeline.serve``.

``python -m scgrhc_torch serve <dir> [ckpt|best|last]`` loads the
generator onto the device once, optionally warms the streaming path
(kernel build and first launches), then answers newline-delimited JSON
requests on stdin with one JSON response line on stdout per request:

    {"record": "PATIENT01"}                          → predict + save .npy
    {"record": "...", "overlap_s": 0.5}              → overlap-and-blend
    {"record": "...", "save": false}                 → waveform inline
    {"record": "...", "continuous": true}            → seam-free whole-record mode
    {"record": "...", "calibrate": true}             → denormalize to the train
                                                       split's RHC range (mmHg)
    {"cmd": "ping"}                                  → liveness check
    {"cmd": "quit"}                                  → clean shutdown

Responses carry the mode, whether the waveform is calibrated, and
per-request wall-clock latency.  The daemon's ``--calibrate`` reads the
calibration range at start-up and makes it every request's default;
without it, the first request that asks reads it.  Errors are per request:
one bad request does not stop the daemon.  Not yet ported: ``--mesh``
and serving from more than one rank (the daemon's continuous requests run
``models.cp.apply_cp`` there in ``scgrhc``; the next slice of the port).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from time import perf_counter, time

import numpy as np

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.io.catalog import SAMPLE_FREQ
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.stream import STREAM_BATCH, stream_infer
from scgrhc_torch.pipeline.predict import (
    cohort_rhc_minmax,
    load_generator_params,
    not_ported,
    predict_continuous,
    predict_record,
    read_scg,
    resolve_checkpoint,
)


SERVE_MESH = ("mesh sharding of serve (--mesh, or more than one rank: the next slice, "
              "with models.cp.apply_cp)")


def _valid_record_name(name) -> bool:
    """Client-supplied record names feed both the WFDB read path and the
    ``.npy`` save path, and the daemon may be network-exposed, so only a
    bare basename is accepted."""
    return (
        isinstance(name, str)
        and name not in ("", ".", "..")
        and os.path.basename(name) == name
        and (os.altsep is None or os.altsep not in name)
    )


def _handle_with_deadline(req: dict, ctx: dict, timeout_s) -> dict:
    """Run one request with a wall-clock deadline (``--timeout S``).

    On expiry the in-flight work is abandoned on its daemon thread, never
    killed, and the client gets the standard error JSON; the daemon stays
    alive for the next request."""
    if not timeout_s:
        return _handle(req, ctx)
    box = {}

    def work():
        try:
            box["resp"] = _handle(req, ctx)
        except BaseException as e:  # re-raised on the request thread
            box["exc"] = e

    th = threading.Thread(target=work, daemon=True, name="serve-request")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        raise TimeoutError(
            f"request exceeded --timeout {timeout_s}s; in-flight work "
            "abandoned (not killed). Retry when the device recovers."
        )
    if "exc" in box:
        raise box["exc"]
    return box["resp"]


def _handle(req: dict, ctx: dict) -> dict:
    params = ctx["params"]
    t0 = perf_counter()
    name = req["record"]
    if not _valid_record_name(name):
        raise ValueError(f"invalid record name {name!r} (bare names only)")
    overlap = int(float(req.get("overlap_s", 0.0)) * SAMPLE_FREQ)
    rhc_minmax = None
    if req.get("calibrate", ctx["calibrate"]):
        if ctx["rhc_minmax"] is None:  # daemon started without --calibrate
            ctx["rhc_minmax"] = cohort_rhc_minmax(params)
        rhc_minmax = ctx["rhc_minmax"]
    if req.get("continuous", False):
        pred = predict_continuous(ctx["gen"], read_scg(params, name), rhc_minmax)
        mode = "continuous"
    else:
        pred = predict_record(ctx["gen"], params, name, overlap, rhc_minmax,
                              batch=ctx["stream_batch"])
        mode = "windowed"
    resp = {
        "record": name,
        "mode": mode,
        "n_samples": int(pred.shape[0]),
        "seconds": round(pred.shape[0] / SAMPLE_FREQ, 3),
        "checkpoint": ctx["ckpt_name"],
        "calibrated": rhc_minmax is not None,
        "ms": round((perf_counter() - t0) * 1e3, 1),
    }
    if req.get("save", True):
        out_dir = ctx["out_dir"]
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}.npy")
        np.save(path, pred.astype(np.float32))
        resp["path"] = path
    else:
        resp["waveform"] = np.asarray(pred, dtype=np.float32).tolist()
    return resp


def _warm(ctx, n_windows: int):
    """Run both request paths once at ``n_windows`` windows — the float32
    path and the int16 ADC path with on-device calibration — so the kernel
    build, library load and first launches happen before the first real
    request."""
    params = ctx["params"]
    t = params.segment_samples
    c = len(params.in_channels)
    batch = ctx["stream_batch"]
    rng = np.random.default_rng(0)
    stream_infer(
        ctx["gen"], rng.random((c, n_windows * t)).astype(np.float32),
        segment_samples=t, batch=batch,
    )
    adc = rng.integers(-1000, 1000, (c, n_windows * t), dtype=np.int16)
    cal = (np.ones(c, np.float32), np.zeros(c, np.float32),
           np.full(c, -32768.0, np.float32))
    stream_infer(ctx["gen"], adc, segment_samples=t, batch=batch, calibration=cal)


def run(
    params,
    checkpoint: str = "best",
    calibrate: bool = False,
    out_dir: str | None = None,
    warm: int = 0,
    mesh: bool = False,
    stream_batch: int = STREAM_BATCH,
    stdin=None,
    stdout=None,
    timeout: float | None = None,
    device=None,
) -> int:
    """Serve until EOF or ``{"cmd": "quit"}``.  Returns requests served.

    ``device`` defaults to CUDA (``"cpu"`` runs the plain versions);
    ``calibrate`` (CLI ``--calibrate``) denormalizes every request that
    does not say otherwise; ``timeout`` (CLI ``--timeout S``) bounds each
    request's wall clock."""
    if mesh or comm.process_count() > 1:
        raise not_ported(SERVE_MESH)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    start_time = time()

    ckpt_name = resolve_checkpoint(params, checkpoint)
    ctx = {
        "params": params,
        "ckpt_name": ckpt_name,
        "gen": load_generator_params(params, ckpt_name, device),
        "calibrate": calibrate,
        "rhc_minmax": cohort_rhc_minmax(params) if calibrate else None,
        "out_dir": out_dir or os.path.join(params.dir_path, "predictions"),
        "stream_batch": stream_batch,
    }
    if warm:
        _warm(ctx, warm)
    print(
        timelog(
            f"Run waveform_serve for {params.dir_path} | {ckpt_name} | ready",
            start_time,
        ),
        file=sys.stderr,
        flush=True,
    )

    served = 0
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                break
            if req.get("cmd") == "ping":
                resp = {"ok": True, "checkpoint": ckpt_name}
            else:
                resp = _handle_with_deadline(req, ctx, timeout)
                served += 1
        except Exception as e:  # per-request isolation
            resp = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), file=stdout, flush=True)
    print(
        timelog(f"waveform_serve | {served} requests served", start_time),
        file=sys.stderr,
        flush=True,
    )
    return served
