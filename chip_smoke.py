#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scgrhc_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``scgrhc_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the serving path
gives it and times both, then drives the serving path end to end through
``scgrhc_torch.pipeline.serve.run`` on synthetic records at the model's
full width (random weights from a fixed seed), counting kernel launches,
and cross-checks one short record against the same request served on the
CPU (the plain versions).  Any failure exits non-zero before the result
lines; without a CUDA device, or without the package beside it, it exits
non-zero at once.

The last three lines of standard output are the card (``nvidia-smi``'s
name and power limit), one ``{"kernels": [...]}`` JSON object, and
``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_CHUNK = 512  # windows per chunk on the serving path (STREAM_BATCH)
T = 750  # samples per window (segment_size 1.5 s at 500 Hz)
CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]
# served records (name, seconds): one chunk, three chunks (512 + 512 + 176
# windows), and a short one for the CPU cross-check
RECORDS = (("SYN000", 600.0), ("LONG030", 1800.0), ("SHORT030", 30.0))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# f32 kernel vs plain: summation order only; outputs are O(1).
TOL_F32 = 1e-4
# bf16 kernel vs the f32 plain version on the same bf16-rounded inputs: the
# kernel's extra rounding is the bf16 store (2^-9 relative).
TOL_BF16 = (3e-2, 1e-2)  # (atol, rtol)
# K4 repeats the plain version's exact f32 operations.
TOL_K4 = 1e-6
# The short record served on the card, served on the CPU, and the float64
# forward: on this record and seed the CPU's f32 forward alone sits 2.1e-3
# from the f64 forward (instance norm amplifies f32 rounding in
# low-variance windows; outputs span about [-3.9, 3.1]).
TOL_SERVE = 5e-3

OUT_DIR = "build"


class Smoke:
    def __init__(self):
        self.errors: list[str] = []

    def check(self, ok: bool, what: str) -> bool:
        if not ok:
            self.errors.append(what)
            print(f"FAIL: {what}", flush=True)
        return ok


def _time_ms(torch, fn, reps=5, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _layer_shapes(in_channels: int):
    """(C_in, O, T) of the 14 K1f launches of one generator forward, in order."""
    from scgrhc_torch.models.generator import BLOCKS

    lengths = (T, T - 2, T - 4, T - 6, T - 4, T - 2, T)
    shapes = []
    for (_, cin, cout), t in zip(BLOCKS, lengths):
        cin = in_channels if cin is None else cin
        shapes += [(cin, cout, t), (cout, cout, t)]
    return shapes


def check_conv_in_relu(torch, smoke: Smoke) -> dict:
    """K1f at every serving layer shape, N = 512, f32 and bf16."""
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu, conv_in_relu_plain

    shapes = _layer_shapes(len(CHANNELS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = {}
    for cin, o, t in dict.fromkeys(shapes):
        bound = 1.0 / math.sqrt(cin * 3)
        x = torch.randn(N_CHUNK, cin, t, device="cuda", generator=gen)
        w = (torch.rand(o, cin, 3, device="cuda", generator=gen) * 2 - 1) * bound
        b = (torch.rand(o, device="cuda", generator=gen) * 2 - 1) * bound
        y = conv_in_relu(x, w, b)
        ref = conv_in_relu_plain(x, w, b)
        torch.cuda.synchronize()
        err32 = float((y - ref).abs().max())
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        yb = conv_in_relu(xb, wb, bb).float()
        refb = conv_in_relu_plain(xb.float(), wb.float(), bb.float())
        diff = (yb - refb).abs()
        err16 = float(diff.max())
        ok16 = bool((diff <= TOL_BF16[0] + TOL_BF16[1] * refb.abs()).all())
        flops = 6.0 * cin * o * t * N_CHUNK
        nbytes = 4.0 * (N_CHUNK * cin * t + o * cin * 3 + o + N_CHUNK * o * t)
        rec = {
            "f32_max_abs_err": err32, "bf16_max_abs_err": err16,
            "ms": _time_ms(torch, lambda: conv_in_relu(x, w, b)),
            "plain_ms": _time_ms(torch, lambda: conv_in_relu_plain(x, w, b)),
            "bf16_ms": _time_ms(torch, lambda: conv_in_relu(xb, wb, bb)),
            "flop_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
            "byte_bound_ms": nbytes / PEAK_BYTES * 1e3,
        }
        per_shape[(cin, o, t)] = rec
        print(
            f"conv_in_relu N={N_CHUNK} C_in={cin} O={o} T={t}: f32 err {err32:.3g} "
            f"(tol {TOL_F32:g}), bf16 err {err16:.3g} (tol {TOL_BF16[0]:g} + "
            f"{TOL_BF16[1]:g}|ref|), kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, bf16 kernel {rec['bf16_ms']:.3f} ms, bound "
            f"{max(rec['flop_bound_ms'], rec['byte_bound_ms']):.3f} ms, library call none",
            flush=True,
        )
        smoke.check(err32 <= TOL_F32, f"conv_in_relu f32 {cin}x{o}x{t}: err {err32}")
        smoke.check(ok16, f"conv_in_relu bf16 {cin}x{o}x{t}: err {err16}")
        del x, w, b, y, ref, xb, wb, bb, yb, refb, diff
    # one generator forward's 14 launches at N = 512
    total = {k: sum(per_shape[s][k] for s in shapes)
             for k in ("ms", "plain_ms", "bf16_ms", "flop_bound_ms", "byte_bound_ms")}
    return {
        "max_abs_err": max(r["f32_max_abs_err"] for r in per_shape.values()),
        "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in per_shape.values()),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bf16_ms": total["bf16_ms"],
        "bound_ms": max(total["flop_bound_ms"], total["byte_bound_ms"]),
        "bound_by": "operations" if total["flop_bound_ms"] >= total["byte_bound_ms"]
        else "bytes",
        "per_shape": {"x".join(map(str, s)): r for s, r in per_shape.items()},
    }


def check_normalize_windows(torch, smoke: Smoke) -> dict:
    """K4 at (512, 4, 750), one window holding a NaN."""
    from scgrhc_torch.ops.kernels.dsp import normalize_windows, normalize_windows_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    c = len(CHANNELS)
    w = torch.randn(N_CHUNK, c, T, device="cuda", generator=gen) * 3 + 1
    w[7, 2, 300] = float("nan")
    got = normalize_windows(w)
    ref = normalize_windows_plain(w)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
    nan_window = bool(torch.isnan(got[7]).all())
    err = float((torch.nan_to_num(got) - torch.nan_to_num(ref)).abs().max())
    nbytes = 2.0 * 4 * w.numel()
    rec = {
        "max_abs_err": err,
        "ms": _time_ms(torch, lambda: normalize_windows(w), reps=20),
        "plain_ms": _time_ms(torch, lambda: normalize_windows_plain(w), reps=20),
        "bound_ms": max(nbytes / PEAK_BYTES, 3.0 * w.numel() / PEAK_F32_FLOPS) * 1e3,
        "bound_by": "bytes",
    }
    print(
        f"normalize_windows N={N_CHUNK} C={c} T={T}: err {err:.3g} (tol {TOL_K4:g}), "
        f"NaN window all-NaN {nan_window}, NaN pattern equal {same_nan}, kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms, library call none",
        flush=True,
    )
    smoke.check(same_nan and nan_window, "normalize_windows NaN propagation")
    smoke.check(err <= TOL_K4, f"normalize_windows err {err}")
    return rec


def write_experiment(root: str, torch) -> tuple[str, dict]:
    """Synthetic records of both stream paths and a 30-s one, an experiment
    dir taking all 4 SCG channels, and a reference-layout torch.save
    checkpoint of a seeded Generator."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.io.wfdb import rdrecord, wrrecord
    from scgrhc_torch.models.generator import Generator
    from scgrhc_torch.utils.synth import make_synthetic_database

    (first, first_s), *others = RECORDS
    processed = make_synthetic_database(os.path.join(root, "db"), n_records=1,
                                        duration_s=first_s, seed=0,
                                        flatline_in_first=False)
    records = {first: first_s}
    for seed, (name, seconds) in enumerate(others, start=1):
        other = make_synthetic_database(os.path.join(root, name), n_records=1,
                                        duration_s=seconds, seed=seed,
                                        flatline_in_first=False)
        rec = rdrecord(os.path.join(other, "SYN000"))
        wrrecord(os.path.join(processed, name), rec.fs, rec.sig_name, rec.p_signal)
        records[name] = seconds
    paths.set_data_path(os.path.dirname(processed))

    exp = os.path.join(root, "exp")
    os.makedirs(os.path.join(exp, "checkpoints"))
    cfg = {
        "dir_path": exp, "in_channels": CHANNELS, "chamber": "PA",
        "segment_size": 1.5, "batch_size": 32,
        "train_path": "loader_train.pickle", "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons", "pred_top_dir_path": "pred_top",
        "pred_rand_dir_path": "pred_rand", "alpha": 1e-4, "beta1": 0.5,
        "beta2": 0.999, "n_critic": 5, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 1, "min_RHC": -50, "use_global_min_max": False,
    }
    with open(os.path.join(exp, "params.json"), "w") as f:
        json.dump(cfg, f)
    gen = Generator(len(CHANNELS), torch.Generator().manual_seed(1234))
    torch.save(
        {"start_time": 0.0, "epoch": 1, "g_losses": [], "d_losses": [],
         "g_state_dict": gen.state_dict()},
        os.path.join(exp, "checkpoints", "001.checkpoint"),
    )
    return exp, records


def serve_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
    from scgrhc_torch.ops.kernels.dsp import normalize_windows
    from scgrhc_torch.pipeline import serve

    exp, records = write_experiment(root, torch)
    params = Params(os.path.join(exp, "params.json"))
    warm = 16
    requests = [
        {"cmd": "ping"},
        {"record": "SYN000"},
        {"record": "LONG030"},
        {"record": "SYN000", "overlap_s": 0.5, "save": False},
        {"record": "SHORT030", "save": False},
        {"record": "../etc/passwd"},
        {"cmd": "quit"},
    ]
    snaps = []

    def lines():
        for req in requests:
            snaps.append((conv_in_relu.launches, normalize_windows.launches))
            yield json.dumps(req) + "\n"
        snaps.append((conv_in_relu.launches, normalize_windows.launches))

    out = io.StringIO()
    conv_in_relu.launches = 0
    normalize_windows.launches = 0
    t0 = time.perf_counter()
    served = serve.run(params, checkpoint="last", warm=warm, stream_batch=N_CHUNK,
                       stdin=lines(), stdout=out)
    wall = time.perf_counter() - t0
    launches = {"conv_in_relu": conv_in_relu.launches,
                "normalize_windows": normalize_windows.launches}
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    smoke.check(served == 4, f"served {served} requests, expected 4")
    smoke.check(len(resp) == 6, f"{len(resp)} responses, expected 6")
    smoke.check(resp[0] == {"ok": True, "checkpoint": "001.checkpoint"}, "ping")
    smoke.check("error" in resp[-1] and "ValueError" in resp[-1]["error"],
                "bad record name is a per-request error")

    report = {"wall_s": wall, "launches": launches, "requests": []}
    chunks_total = 2 * math.ceil(warm / N_CHUNK)  # the two warm-up streams
    for i, (req, r) in enumerate(zip(requests[1:5], resp[1:5]), start=1):
        name = req["record"]
        if not smoke.check("error" not in r, f"{name}: {r.get('error')}"):
            continue
        hop = T - int(req.get("overlap_s", 0) * 500)
        n_win = (int(records[name] * 500) - T) // hop + 1
        n_samples = hop * (n_win - 1) + T
        chunks = math.ceil(n_win / N_CHUNK)
        chunks_total += chunks
        wave = (np.load(r["path"]) if "path" in r
                else np.asarray(r["waveform"], np.float32))
        d_k1 = snaps[i + 1][0] - snaps[i][0]
        d_k4 = snaps[i + 1][1] - snaps[i][1]
        smoke.check(r["n_samples"] == n_samples == wave.shape[0],
                    f"{name}: n_samples {r['n_samples']}, expected {n_samples}")
        smoke.check(bool(np.isfinite(wave).all()), f"{name}: non-finite output")
        smoke.check(d_k1 == 14 * chunks, f"{name}: {d_k1} K1f launches for {chunks} chunks")
        smoke.check(d_k4 == chunks, f"{name}: {d_k4} K4 launches for {chunks} chunks")
        rate = n_win / (r["ms"] / 1e3)
        print(f"serve {name} overlap_s={req.get('overlap_s', 0)}: {n_win} windows, "
              f"{chunks} chunks, {r['ms']} ms, {rate:.1f} windows/s, launches "
              f"K1f {d_k1} K4 {d_k4} on {card}", flush=True)
        report["requests"].append({"record": name, "overlap_s": req.get("overlap_s", 0),
                                   "windows": n_win, "chunks": chunks, "ms": r["ms"],
                                   "windows_per_s": rate, "k1f": d_k1, "k4": d_k4})
    smoke.check(launches["conv_in_relu"] == 14 * chunks_total,
                f"K1f launches {launches['conv_in_relu']}, expected {14 * chunks_total}")
    smoke.check(launches["normalize_windows"] == chunks_total,
                f"K4 launches {launches['normalize_windows']}, expected {chunks_total}")

    report.update(cross_check(torch, smoke, params, np.asarray(resp[4].get("waveform", []),
                                                               np.float32)))
    return report


def cross_check(torch, smoke: Smoke, params, gpu_wave) -> dict:
    """The short record served on the CPU (the plain versions, f32), and the
    same checkpoint's float64 forward on the CPU over the same windows."""
    from scgrhc_torch.io.catalog import read_record_digital
    from scgrhc_torch.ops.kernels.dsp import normalize_windows_plain
    from scgrhc_torch.parallel.stream import calibrate, frame_record
    from scgrhc_torch.pipeline import serve
    from scgrhc_torch.pipeline.predict import load_generator_params

    name = RECORDS[-1][0]
    cpu_out = io.StringIO()
    t0 = time.perf_counter()
    serve.run(params, checkpoint="last", device="cpu", stdout=cpu_out,
              stdin=io.StringIO(json.dumps({"record": name, "save": False}) + "\n"))
    cpu_s = time.perf_counter() - t0
    cpu_wave = np.asarray(json.loads(cpu_out.getvalue()).get("waveform", []), np.float32)

    adc, gain, base, sentinel = read_record_digital(name, params.in_channels)
    phys = calibrate(torch.from_numpy(np.ascontiguousarray(adc.T)),
                     *(torch.from_numpy(v) for v in (gain, base, sentinel)))
    w = normalize_windows_plain(frame_record(phys, T).contiguous())
    gen64 = load_generator_params(params, "001.checkpoint", "cpu").double()
    with torch.inference_mode():
        ref = gen64(w.double())[:, 0].reshape(-1).numpy()

    ok = gpu_wave.shape == cpu_wave.shape == ref.shape and ref.size > 0
    errs = {
        "cuda_vs_cpu": float(np.abs(gpu_wave - cpu_wave).max()) if ok else math.inf,
        "cuda_vs_f64": float(np.abs(gpu_wave - ref).max()) if ok else math.inf,
        "cpu_vs_f64": float(np.abs(cpu_wave - ref).max()) if ok else math.inf,
    }
    print(f"serve {name} cross-check (tol {TOL_SERVE:g}): cuda vs cpu "
          f"{errs['cuda_vs_cpu']:.3g}, cuda vs f64 {errs['cuda_vs_f64']:.3g}, cpu vs f64 "
          f"{errs['cpu_vs_f64']:.3g}; cpu request {cpu_s:.1f} s", flush=True)
    for k, v in errs.items():
        smoke.check(v <= TOL_SERVE, f"{name} {k} max abs err {v}")
    return {"cross_check_max_abs_err": errs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's serving path runs on CUDA",
              file=sys.stderr)
        return 2
    try:
        import scgrhc_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 3
    from scgrhc_torch.core.device import resolve_device
    from scgrhc_torch.ops.kernels import _build

    smoke = Smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{kind} x{count}", flush=True)
    resolve_device("cuda")  # TF32 off for the plain versions and the serve path

    t0 = time.perf_counter()
    build = _build.build()
    print(f"build: {build.path.name} in {build.seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with load)", flush=True)
    for line in build.log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    k1f = check_conv_in_relu(torch, smoke)
    k4 = check_normalize_windows(torch, smoke)

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serve = serve_end_to_end(torch, smoke, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = [
        {"name": "conv_in_relu", "route": "cuda",
         "source": "scgrhc_torch/csrc/conv_in_relu.cu",
         "replaces": "scgrhc/ops/pallas/conv_block.py:75",
         "launches": serve["launches"]["conv_in_relu"],
         "max_abs_err": k1f["max_abs_err"], "ms": k1f["ms"],
         "plain_ms": k1f["plain_ms"], "bound_ms": k1f["bound_ms"],
         "bound_by": k1f["bound_by"], "library_ms": None},
        {"name": "normalize_windows", "route": "cuda",
         "source": "scgrhc_torch/csrc/normalize_windows.cu",
         "replaces": "scgrhc/ops/pallas/dsp.py:157",
         "launches": serve["launches"]["normalize_windows"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
    ]
    for k in kernels:
        k["status"] = "fail" if smoke.errors else "ok"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "count": count,
                   "build_seconds": build.seconds, "build_log": build.log,
                   "conv_in_relu": k1f, "normalize_windows": k4, "serve": serve,
                   "errors": smoke.errors}, f, indent=1)
    if smoke.errors:
        print(f"chip_smoke: {len(smoke.errors)} check(s) failed", file=sys.stderr)
        for e in smoke.errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
