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
one bad request does not stop the daemon.

``--mesh`` shards a windowed request's windows over the ranks when the
record is past one chunk (``parallel.stream.mesh_for_request``, as
``predict --mesh``); at world size 1 it is a mesh of one.  A continuous
request runs time-sharded over the ranks when there are several and the
record's length divides their count (``predict.predict_continuous``).

Over several ranks (``torchrun --nproc-per-node=N -m scgrhc_torch serve
<dir> --mesh``) every rank loads the generator and computes; rank 0 alone
reads stdin, writes stdout and saves the ``.npy``.  The ranks stay in step
request by request:

  * rank 0 broadcasts each line, ``ping`` and ``quit`` included, and the
    end of its input (:func:`_lines`).  While stdin is idle it sends a
    keep-alive every ``KEEPALIVE_S``, so that the followers' wait in the
    broadcast (over the stage group, ``comm.STAGE_TIMEOUT_S``) never runs
    out on a quiet night;
  * the failures a request can meet before its first collective (the
    JSON, the name's validation, the calibration range, a missing record,
    the record read: :func:`_prepare`) are gathered from every rank, so
    every rank skips the request together, rank 0 writes the error line,
    and the daemon carries on;
  * a failure once the ranks compute together (a collective, the card)
    ends the daemon on every rank after rank 0's error line: the rank that
    failed leaves, and its peers' collectives then fail at once instead of
    waiting out ``comm.TIMEOUT_S``;
  * ``--timeout``: a request past its deadline has left its work running
    on a thread, which may still be inside a collective that the next
    request's would meet, so over ranks an expired deadline writes its
    error line and ends the process at once (``os._exit``: the abandoned
    thread holds the group, which an orderly exit would wait for); its
    peers' collectives fail and they end too.  At world size 1 the daemon
    carries on, as ``scgrhc``'s does.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
from time import perf_counter, time

import numpy as np

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.io.catalog import SAMPLE_FREQ
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import make_mesh
from scgrhc_torch.parallel.stream import STREAM_BATCH, mesh_for_request, stream_infer
from scgrhc_torch.pipeline.predict import (
    cohort_rhc_minmax,
    load_generator_params,
    predict_continuous,
    predict_windows,
    read_scg,
    read_windowed,
    resolve_checkpoint,
)

KEEPALIVE_S = 600.0  # rank 0's keep-alive period while stdin is idle, over ranks
_KEEPALIVE = False  # the keep-alive's value in the line broadcast (None: end of input)


class RanksFailed(RuntimeError):
    """A request failed once the ranks computed together: over several
    ranks the daemon ends on every rank."""


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


def _lines(stdin):
    """The request lines, on every rank.  At world size 1, stdin itself.
    Over ranks, rank 0 reads stdin on a thread and broadcasts each line,
    and None at the end of its input; after ``KEEPALIVE_S`` of silence it
    broadcasts a keep-alive, which every rank skips."""
    if comm.process_count() == 1:
        yield from stdin
        return
    if comm.is_primary():
        box = queue.Queue()

        def read():
            for line in stdin:
                box.put(line)
            box.put(None)

        threading.Thread(target=read, daemon=True, name="serve-stdin").start()
    while True:
        line = None
        if comm.is_primary():
            try:
                line = box.get(timeout=KEEPALIVE_S)
            except queue.Empty:
                line = _KEEPALIVE
        line = comm.broadcast_object(line)
        if line is None:
            return
        if line is not _KEEPALIVE:
            yield line


def _prepare(line: str, ctx: dict) -> dict:
    """Everything of a request before the ranks compute together: the JSON,
    the command, the name's validation, the overlap, the calibration range
    and the record read.  No collective.  Returns the request with what
    :func:`_handle` needs under keys of its own (``_overlap``,
    ``_rhc_minmax``, ``_data``)."""
    req = json.loads(line)
    if req.get("cmd") in ("quit", "ping"):
        return req
    params = ctx["params"]
    name = req["record"]
    if not _valid_record_name(name):
        raise ValueError(f"invalid record name {name!r} (bare names only)")
    overlap = int(float(req.get("overlap_s", 0.0)) * SAMPLE_FREQ)
    t = params.segment_samples
    if not 0 <= overlap < t:
        raise ValueError(f"overlap must be in [0, segment_samples={t}), got {overlap}")
    rhc_minmax = None
    if req.get("calibrate", ctx["calibrate"]):
        if ctx["rhc_minmax"] is None:  # daemon started without --calibrate
            ctx["rhc_minmax"] = cohort_rhc_minmax(params)
        rhc_minmax = ctx["rhc_minmax"]
    data = read_scg(params, name) if req.get("continuous") else read_windowed(params, name)
    return {**req, "_overlap": overlap, "_rhc_minmax": rhc_minmax, "_data": data}


def _handle(req: dict, ctx: dict) -> dict | None:
    """Compute a prepared request on every rank (a failure there raises
    :class:`RanksFailed`); rank 0 saves it and returns the response, the
    others None."""
    rhc_minmax, continuous = req["_rhc_minmax"], bool(req.get("continuous", False))
    try:
        if continuous:
            pred = predict_continuous(ctx["gen"], req["_data"], rhc_minmax)
        else:
            pred = predict_windows(ctx["gen"], ctx["params"], req["_data"], req["_overlap"],
                                   rhc_minmax, batch=ctx["stream_batch"], mesh=ctx["mesh"])
    except Exception as e:
        raise RanksFailed(f"{type(e).__name__}: {e}") from e
    if not comm.is_primary():
        return None
    name = req["record"]
    resp = {
        "record": name,
        "mode": "continuous" if continuous else "windowed",
        "n_samples": int(pred.shape[0]),
        "seconds": round(pred.shape[0] / SAMPLE_FREQ, 3),
        "checkpoint": ctx["ckpt_name"],
        "calibrated": rhc_minmax is not None,
        "ms": round((perf_counter() - req["_t0"]) * 1e3, 1),
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


def _handle_with_deadline(req: dict, ctx: dict, timeout_s) -> dict | None:
    """Run one prepared request with a wall-clock deadline (``--timeout
    S``).  On expiry the in-flight work is abandoned on its daemon thread,
    never killed, and a TimeoutError is raised (module doc: over ranks the
    daemon then ends)."""
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


def _error(e: BaseException) -> str:
    return e.args[0] if isinstance(e, RanksFailed) else f"{type(e).__name__}: {e}"


def _warm(ctx, n_windows: int):
    """Run both request paths once at ``n_windows`` windows — the float32
    path and the int16 ADC path with on-device calibration — on the
    daemon's mesh as an overlap-0 request of that size takes it, so the
    kernel build, library load and first launches happen before the first
    real request.  Every rank calls it."""
    params = ctx["params"]
    t = params.segment_samples
    c = len(params.in_channels)
    batch = ctx["stream_batch"]
    mesh = mesh_for_request(ctx["mesh"], n_windows * t, t, 0, batch)
    rng = np.random.default_rng(0)
    stream_infer(
        ctx["gen"], rng.random((c, n_windows * t)).astype(np.float32),
        segment_samples=t, batch=batch, mesh=mesh,
    )
    adc = rng.integers(-1000, 1000, (c, n_windows * t), dtype=np.int16)
    cal = (np.ones(c, np.float32), np.zeros(c, np.float32),
           np.full(c, -32768.0, np.float32))
    stream_infer(ctx["gen"], adc, segment_samples=t, batch=batch, calibration=cal, mesh=mesh)


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
    does not say otherwise; ``mesh`` (CLI ``--mesh``) shards the windowed
    requests past one chunk over the ranks; ``timeout`` (CLI ``--timeout
    S``) bounds each request's wall clock.  Over several ranks every rank
    calls it (module doc)."""
    comm.refuse_lone_rank()
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    start_time = time()
    ranks, primary = comm.process_count(), comm.is_primary()

    ckpt_name = resolve_checkpoint(params, checkpoint)
    ctx = {
        "params": params,
        "ckpt_name": ckpt_name,
        "gen": load_generator_params(params, ckpt_name, device),
        "calibrate": calibrate,
        "rhc_minmax": cohort_rhc_minmax(params) if calibrate else None,
        "out_dir": out_dir or os.path.join(params.dir_path, "predictions"),
        "mesh": make_mesh() if mesh else None,
        "stream_batch": stream_batch,
    }
    if warm:
        _warm(ctx, warm)
    if primary:
        print(timelog(f"Run waveform_serve for {params.dir_path} | {ckpt_name} | ready",
                      start_time), file=sys.stderr, flush=True)

    def answer(resp):
        if primary:
            print(json.dumps(resp), file=stdout, flush=True)

    served = 0
    for line in _lines(stdin):
        line = line.strip()
        if not line:
            continue
        t0 = perf_counter()
        req, err = None, None
        try:
            req = {**_prepare(line, ctx), "_t0": t0}
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        if ranks > 1:  # every rank skips a request that failed on any
            errs = comm.gather_objects(err)
            err = next((e if r == 0 else f"rank {r}: {e}" for r, e in enumerate(errs) if e),
                       None)
        if err is not None:
            answer({"error": err})
            continue
        if req.get("cmd") == "quit":
            break
        if req.get("cmd") == "ping":
            answer({"ok": True, "checkpoint": ckpt_name})
            continue
        try:
            resp = _handle_with_deadline(req, ctx, timeout)
            served += 1
        except TimeoutError as e:
            answer({"error": _error(e)})
            if ranks > 1:
                stdout.flush()
                os._exit(1)
            continue
        except RanksFailed as e:
            answer({"error": _error(e)})
            if ranks > 1:
                raise
            continue
        except Exception as e:  # rank 0's save or response: this request only
            resp = {"error": _error(e)}
        answer(resp)
    if primary:
        print(timelog(f"waveform_serve | {served} requests served", start_time),
              file=sys.stderr, flush=True)
    return served
