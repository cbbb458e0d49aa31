#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scgrhc_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``scgrhc_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes its path gives it
(f32 and bf16) and times both, then drives two paths end to end at the
model's full width, counting kernel launches from 0 just before each:

  * serving, through ``scgrhc_torch.pipeline.serve.run`` on synthetic
    records (random weights from a fixed seed), with one short record
    cross-checked against the same request served on the CPU;
  * training, through ``scgrhc_torch.train.run.run`` on the 400 windows of
    a 600-s synthetic record: 2 epochs in epoch mode, then a resume to a
    third in step mode, in this process and in a new one
    (``python -m scgrhc_torch train``), each held bit for bit to an
    uninterrupted 3-epoch run; one bfloat16 epoch beside the f32 losses;
    the step's gradients and losses cross-checked against the same step
    on the CPU with the same dropout masks and eps.

Any failure exits non-zero before the result lines; without a CUDA device,
or without the package beside it, it exits non-zero at once.

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
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_CHUNK = 512  # windows per chunk on the serving path (STREAM_BATCH)
N_TRAIN = 32  # batch_size of the training path
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
# The training kernels (K1b, K2f, K2dx, K2dw), by the relative L2 error
# |kernel - plain| / |plain|.  The one exception is the bias gradient of an
# in_relu layer: after an instance norm it is zero up to rounding, so it is
# held over |sum |dc|| instead (in relu and linear modes db is not small,
# and is held by its own norm).  f32 forward: summation order
# only.  f32 backward: a relu mask can also flip where x̂ is within f32
# rounding of 0, moving one dc element by rsig·dy.  bf16 against the f32
# plain version on the same bf16-rounded inputs: bf16 stores, dc rounded
# to bf16 for dx and dw, and more mask flips.
TOL_TRAIN = {"fwd": 1e-4, "bwd": 1e-3, "bf16": 3e-2}
# One WGAN-GP step on the card against the same step on the CPU (same
# weights, masks, eps; cross_check_step).  Gradients, as Adam's first
# moments after one step, by relative L2: a gradient of the wrong sign
# reads 2, a zero one 1.  The f32 envelope is set by the relu masks: where
# an x̂ sits within rounding of 0, its mask can flip on one device and not
# on the other, and the critic's input gradient, small beside its terms,
# moves by a few 1e-3 per flip (readings 3.6e-3 for G, 4.1e-3 for D on
# an H100; the CPU's f32 step against its f64 step, printed beside, reads
# 1.7e-3 for G and flipped no critic mask).
TOL_STEP_MOMENTS = 1e-2
# The first critic loss is a forward value; the gradient penalty in it
# moves with the same mask flips (reading 3.8e-4).
TOL_STEP_LOSS0 = 2e-3  # relative
# The losses after the first critic update: Adam's first steps move every
# weight by about alpha, whatever the size of its gradient, so a gradient
# within rounding of 0 moves a weight the other way on the other device
# (reading 5.6e-3).  The same step with the critic's updates reversed is
# read beside it (0.49) and must fall outside.
TOL_STEP_LOSSES = 2e-2  # relative
N_CRITIC = 5
ALPHA = 1e-4
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


def _write_params(exp: str, **extra) -> str:
    """The experiment's params.json at the published widths: 4 SCG
    channels, 750-sample windows, batch 32, n_critic 5, lambda_gp 10,
    lambda_aux 100."""
    cfg = {
        "dir_path": exp, "in_channels": CHANNELS, "chamber": "PA",
        "segment_size": 1.5, "batch_size": N_TRAIN,
        "train_path": "loader_train.pickle", "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons", "pred_top_dir_path": "pred_top",
        "pred_rand_dir_path": "pred_rand", "alpha": ALPHA, "beta1": 0.5,
        "beta2": 0.999, "n_critic": N_CRITIC, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 1, "min_RHC": -50, "use_global_min_max": False, **extra,
    }
    path = os.path.join(exp, "params.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


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
    _write_params(exp, total_epochs=1)
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


# ---- training kernels -------------------------------------------------------

CRITIC_LAYERS = ((len(CHANNELS) + 1, 64, "relu"), (64, 128, "in_relu"),
                 (128, 256, "in_relu"), (256, 512, "in_relu"), (512, 1, "linear"))


def _rel(got, want, floor: float = 0.0) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), floor, 1e-30))


def _db_floor(x, w, b, dy) -> float:
    """|sum |dc||, the scale an in_relu layer's bias gradient sums to zero."""
    from scgrhc_torch.ops.kernels import conv3

    dc = conv3.dc_from_dy(dy.float(), conv3.conv(x, w, b), "in_relu")
    return float(dc.abs().sum(dim=(0, 2)).norm())


def _bound_ms(flops: float, nbytes: float) -> tuple[float, float]:
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def _train_inputs(torch, gen, cin, o, t):
    bound = 1.0 / math.sqrt(cin * 3)
    x = torch.randn(N_TRAIN, cin, t, device="cuda", generator=gen)
    w = (torch.rand(o, cin, 3, device="cuda", generator=gen) * 2 - 1) * bound
    b = (torch.rand(o, device="cuda", generator=gen) * 2 - 1) * bound
    dy = torch.randn(N_TRAIN, o, t, device="cuda", generator=gen)
    return x, w, b, dy


def _hold(smoke, what, outs, refs, floors, tol) -> tuple[float, float]:
    """Relative L2 error (checked) and max abs error of kernel outputs."""
    rel = max(_rel(g, r, f) for g, r, f in zip(outs, refs, floors))
    err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(outs, refs))
    smoke.check(rel <= tol, f"{what}: relative error {rel} over {tol}")
    return rel, err


def _summary(per_shape: dict, keys) -> dict:
    """Sums over the layers of one pass (duplicated shapes counted once per
    layer), and the worst errors."""
    recs = list(per_shape.values())
    out = {k: sum(r[k] * r["layers"] for r in recs) for k in keys}
    flop, byte = out.pop("flop_bound_ms"), out.pop("byte_bound_ms")
    out.update(
        bound_ms=max(flop, byte), bound_by="operations" if flop >= byte else "bytes",
        max_abs_err=max(r["max_abs_err"] for r in recs),
        rel_err=max(r["rel_err"] for r in recs),
        bf16_rel_err=max(r["bf16_rel_err"] for r in recs),
        per_shape=per_shape,
    )
    return out


def check_conv_in_relu_bwd(torch, smoke: Smoke) -> dict:
    """K1b at the 14 generator layer shapes of one backward, N = 32 (and
    K1f's time at N = 32, the training forward's, for the step breakdown)."""
    from scgrhc_torch.ops.kernels.conv_block import (
        conv_in_relu,
        conv_in_relu_bwd,
        conv_in_relu_bwd_plain,
    )

    shapes = [(cin, o, t, i > 0) for i, (cin, o, t) in enumerate(_layer_shapes(len(CHANNELS)))]
    gen = torch.Generator(device="cuda").manual_seed(2)
    per_shape = {}
    for cin, o, t, need_dx in dict.fromkeys(shapes):
        x, w, b, dy = _train_inputs(torch, gen, cin, o, t)
        what = f"conv_in_relu_bwd {cin}x{o}x{t} dx={need_dx}"
        floors = (0.0, 0.0, _db_floor(x, w, b, dy))
        got = [g for g in conv_in_relu_bwd(x, w, b, dy, need_dx) if g is not None]
        ref = [r for r in conv_in_relu_bwd_plain(x, w, b, dy, need_dx) if r is not None]
        torch.cuda.synchronize()
        rel, err = _hold(smoke, what, got, ref, floors[-len(got):], TOL_TRAIN["bwd"])
        xb, wb, bb, dyb = (v.bfloat16() for v in (x, w, b, dy))
        got = [g for g in conv_in_relu_bwd(xb, wb, bb, dyb, need_dx) if g is not None]
        ref = [r for r in conv_in_relu_bwd_plain(*(v.float() for v in (xb, wb, bb, dyb)), need_dx)
               if r is not None]
        rel16, _ = _hold(smoke, what + " bf16", got, ref, floors[-len(got):], TOL_TRAIN["bf16"])
        n_conv = 3 if need_dx else 2  # recompute, dw, and dx
        flops = 6.0 * cin * o * t * N_TRAIN * n_conv
        nbytes = 4.0 * (N_TRAIN * t * (cin * (2 if need_dx else 1) + o) + 6 * o * cin + 2 * o)
        fb, bb_ = _bound_ms(flops, nbytes)
        rec = {
            "layers": shapes.count((cin, o, t, need_dx)), "rel_err": rel, "max_abs_err": err,
            "bf16_rel_err": rel16,
            "ms": _time_ms(torch, lambda: conv_in_relu_bwd(x, w, b, dy, need_dx)),
            "plain_ms": _time_ms(torch, lambda: conv_in_relu_bwd_plain(x, w, b, dy, need_dx)),
            "bf16_ms": _time_ms(torch, lambda: conv_in_relu_bwd(xb, wb, bb, dyb, need_dx)),
            "fwd_ms": _time_ms(torch, lambda: conv_in_relu(x, w, b)),
            "flop_bound_ms": fb, "byte_bound_ms": bb_,
        }
        per_shape[f"{cin}x{o}x{t}{'' if need_dx else ' no dx'}"] = rec
        print(f"conv_in_relu_bwd N={N_TRAIN} C_in={cin} O={o} T={t} dx={need_dx}: rel err "
              f"{rel:.3g} (tol {TOL_TRAIN['bwd']:g}), max abs err {err:.3g}, bf16 rel err "
              f"{rel16:.3g} (tol {TOL_TRAIN['bf16']:g}), kernel {rec['ms']:.3f} ms, plain "
              f"{rec['plain_ms']:.3f} ms, bf16 kernel {rec['bf16_ms']:.3f} ms, bound "
              f"{max(fb, bb_):.3f} ms, library call none; K1f at N={N_TRAIN} "
              f"{rec['fwd_ms']:.3f} ms", flush=True)
        del x, w, b, dy, xb, wb, bb, dyb, got, ref
    return _summary(per_shape, ("ms", "plain_ms", "bf16_ms", "fwd_ms", "flop_bound_ms",
                                "byte_bound_ms"))


def check_critic_layers(torch, smoke: Smoke) -> dict:
    """K2f, K2dx and K2dw at the 5 critic layer shapes, N = 32, T = 750."""
    import torch.nn.functional as F

    from scgrhc_torch.ops.kernels import critic_fused as k2

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"critic_layer": {}, "critic_layer_bwd_dx": {}, "critic_layer_bwd_dwdb": {}}
    for cin, o, mode in CRITIC_LAYERS:
        x, w, b, dy = _train_inputs(torch, gen, cin, o, T)
        xb, wb, bb, dyb = (v.bfloat16() for v in (x, w, b, dy))
        f16 = [v.float() for v in (xb, wb, bb, dyb)]
        db_floor = _db_floor(x, w, b, dy) if mode == "in_relu" else 0.0
        conv_flops = 6.0 * cin * o * T * N_TRAIN
        recompute = 0.0 if mode == "linear" else 1.0
        act_x, act_y, wts = 4.0 * N_TRAIN * cin * T, 4.0 * N_TRAIN * o * T, 4.0 * (3 * cin * o + o)
        lin = mode == "linear"
        cases = {
            # name: (kernel, plain, floors, flops, bytes, library call)
            "critic_layer": (
                lambda *v: [k2.critic_layer(*v[:3], mode)],
                lambda *v: [k2.critic_layer_plain(*v[:3], mode)], (0.0,), conv_flops,
                act_x + act_y + wts,
                (lambda: F.conv1d(x, w, b, padding=1)) if lin else None, "fwd"),
            "critic_layer_bwd_dx": (
                lambda *v: [k2.critic_layer_bwd_dx(*v, mode)],
                lambda *v: [k2.critic_layer_bwd_dx_plain(*v, mode)], (0.0,),
                conv_flops * (1 + recompute), act_x * (1 + recompute) + act_y + wts,
                (lambda: torch.nn.grad.conv1d_input(x.shape, w, dy, padding=1)) if lin else None,
                "bwd"),
            "critic_layer_bwd_dwdb": (
                lambda *v: list(k2.critic_layer_bwd_dwdb(*v, mode)),
                lambda *v: list(k2.critic_layer_bwd_dwdb_plain(*v, mode)), (0.0, db_floor),
                conv_flops * (1 + recompute) + N_TRAIN * o * T, act_x + act_y + 2 * wts,
                (lambda: torch.nn.grad.conv1d_weight(x, w.shape, dy, padding=1)) if lin else None,
                "bwd"),
        }
        for name, (kern, plain, floors, flops, nbytes, lib, kind) in cases.items():
            what = f"{name} {mode} {cin}x{o}x{T}"
            got, ref = kern(x, w, b, dy), plain(x, w, b, dy)
            torch.cuda.synchronize()
            rel, err = _hold(smoke, what, got, ref, floors, TOL_TRAIN[kind])
            rel16, _ = _hold(smoke, what + " bf16", kern(xb, wb, bb, dyb), plain(*f16), floors,
                             TOL_TRAIN["bf16"])
            fb, byb = _bound_ms(flops, nbytes)
            rec = {
                "layers": 1, "mode": mode, "rel_err": rel, "max_abs_err": err,
                "bf16_rel_err": rel16,
                "ms": _time_ms(torch, lambda: kern(x, w, b, dy), reps=10),
                "plain_ms": _time_ms(torch, lambda: plain(x, w, b, dy), reps=10),
                "bf16_ms": _time_ms(torch, lambda: kern(xb, wb, bb, dyb), reps=10),
                "library_ms": None if lib is None else _time_ms(torch, lib, reps=10),
                "flop_bound_ms": fb, "byte_bound_ms": byb,
            }
            out[name][f"{cin}x{o}x{T} {mode}"] = rec
            lib_txt = "none" if lib is None else f"{rec['library_ms']:.4f} ms"
            print(f"{name} N={N_TRAIN} C={cin} O={o} T={T} {mode}: rel err {rel:.3g} (tol "
                  f"{TOL_TRAIN[kind]:g}), max abs err {err:.3g}, bf16 rel err {rel16:.3g} "
                  f"(tol {TOL_TRAIN['bf16']:g}), kernel {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, bf16 kernel {rec['bf16_ms']:.4f} ms, bound "
                  f"{max(fb, byb):.4f} ms, library call {lib_txt}", flush=True)
        del x, w, b, dy, xb, wb, bb, dyb, f16
    keys = ("ms", "plain_ms", "bf16_ms", "flop_bound_ms", "byte_bound_ms")
    return {name: _summary(per, keys) for name, per in out.items()}


# ---- training end to end ----------------------------------------------------

TRAIN_KERNELS = ("conv_in_relu", "conv_in_relu_bwd", "critic_layer", "critic_layer_bwd_dx",
                 "critic_layer_bwd_dwdb")


def _kernel_fns():
    from scgrhc_torch.ops.kernels import conv_block, critic_fused

    return {name: getattr(conv_block if name.startswith("conv") else critic_fused, name)
            for name in TRAIN_KERNELS}


def write_train_data(root: str, duration_s: float = 600.0) -> tuple[str, int]:
    """The windows of a synthetic record (400 for 600 s), min-max
    normalized per window, as a native loader file; returns its path and
    the window count."""
    from scgrhc_torch.data.loaders import SegmentLoader
    from scgrhc_torch.data.store import SegmentStore
    from scgrhc_torch.io.wfdb import rdrecord
    from scgrhc_torch.utils.synth import make_synthetic_database

    db = make_synthetic_database(os.path.join(root, "train_db"), n_records=1,
                                 duration_s=duration_s, seed=0, flatline_in_first=False)
    rec = rdrecord(os.path.join(db, "SYN000"))
    sig = np.asarray(rec.p_signal, np.float64)
    n = sig.shape[0] // T
    cols = [list(rec.sig_name).index(c) for c in CHANNELS]
    rhc_col = list(rec.sig_name).index("RHC_pressure")
    scg = sig[: n * T, cols].reshape(n, T, len(CHANNELS))
    rhc = sig[: n * T, [rhc_col]].reshape(n, T, 1)
    store = SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(n) * T)
    path = os.path.join(root, "loader_train.pickle")
    SegmentLoader(store, N_TRAIN, seed=0).save(path)
    return path, n


def _train_exp(root: str, name: str, loader: str, **extra):
    from scgrhc_torch.core.params import Params

    exp = os.path.join(root, name)
    os.makedirs(exp, exist_ok=True)
    if not os.path.exists(os.path.join(exp, "loader_train.pickle")):
        shutil.copy(loader, os.path.join(exp, "loader_train.pickle"))
    return Params(_write_params(exp, **extra))


def _ckpt(params, epoch: int) -> dict:
    from scgrhc_torch.train import checkpoint

    return checkpoint.load(os.path.join(params.checkpoint_dir_path, f"{epoch:03d}.checkpoint"))


def _max_state_diff(a: dict, b: dict) -> float:
    diffs = []
    for k in ("g_state_dict", "d_state_dict"):
        diffs += [float(np.abs(a[k][p] - b[k][p]).max()) for p in a[k]]
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        for i, s in a[k]["state"].items():
            diffs += [float(np.abs(s[m] - b[k]["state"][i][m]).max())
                      for m in ("exp_avg", "exp_avg_sq")]
    return max(diffs)


def train_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    loader, n_windows = write_train_data(root)
    fns = _kernel_fns()

    def drive(params):
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = train_run.run(params, plot=False)
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0, {k: fn.launches for k, fn in fns.items()}

    report = cross_check_step(torch, smoke)

    # the main path, the process's first training run: 2 epochs in epoch
    # mode, then resumed to 3 in step mode
    run_b = _train_exp(root, "resumed", loader, total_epochs=2, train_mode="epoch")
    stats, wall, launches = drive(run_b)
    n_batches = math.ceil(n_windows / N_TRAIN)
    steps = sum(e["steps"] for e in stats["epochs"])
    smoke.check(steps == 2 * n_batches, f"{steps} steps in 2 epochs, expected {2 * n_batches}")
    per_step = launches_per_step(TrainConfig.from_params(run_b))
    want = {k: v * steps for k, v in per_step.items()}
    smoke.check(launches == want, f"training launches {launches}, expected {want}")
    report.update(launches=launches, steps=steps, wall_s=wall, epochs=stats["epochs"])
    keys = {"format", "start_time", "epoch", "g_losses", "d_losses", "g_state_dict",
            "d_state_dict", "g_optimizer_state_dict", "d_optimizer_state_dict"}
    for e in (0, 1):
        ck = _ckpt(run_b, e)
        smoke.check(set(ck) == keys and ck["epoch"] == e, f"checkpoint {e:03d} keys {sorted(ck)}")
        smoke.check(len(ck["g_losses"]) == (e + 1) * n_batches
                    and len(ck["d_losses"]) == N_CRITIC * (e + 1) * n_batches,
                    f"checkpoint {e:03d} loss history lengths")
        smoke.check(bool(np.isfinite(ck["g_losses"] + ck["d_losses"]).all()),
                    f"checkpoint {e:03d}: non-finite losses")
        smoke.check(ck["d_optimizer_state_dict"]["state"][0]["step"]
                    == N_CRITIC * (e + 1) * n_batches, "critic Adam step count")
    # the steady epoch (the first pays for cuDNN set-up and the store upload)
    ms_step = stats["epochs"][-1]["seconds"] / n_batches * 1e3
    rate = n_windows / stats["epochs"][-1]["seconds"]
    print(f"train: {steps} steps in {wall:.1f} s; epoch 1: {ms_step:.1f} ms per step, "
          f"{rate:.1f} windows/s (checkpoint write included) at B={N_TRAIN} on {card}; "
          f"launches per step " + ", ".join(f"{k} {v // steps}" for k, v in launches.items()),
          flush=True)
    report.update(ms_per_step=ms_step, windows_per_s=rate)

    run_b = _train_exp(root, "resumed", loader, total_epochs=3, train_mode="step")
    stats, wall, launches = drive(run_b)
    smoke.check([e["epoch"] for e in stats["epochs"]] == [2], f"resume ran {stats['epochs']}")
    want = {k: v * n_batches for k, v in per_step.items()}
    smoke.check(launches == want, f"resumed launches {launches}, expected {want}")

    # the user's resume: a new process, from the main path's epochs 0 and 1
    run_f = _train_exp(root, "fresh", loader, total_epochs=3, train_mode="step")
    os.makedirs(run_f.checkpoint_dir_path, exist_ok=True)
    for e in (0, 1):
        name = f"{e:03d}.checkpoint"
        shutil.copy(os.path.join(run_b.checkpoint_dir_path, name),
                    os.path.join(run_f.checkpoint_dir_path, name))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "scgrhc_torch", "train", run_f.dir_path],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    smoke.check(proc.returncode == 0, f"resume in a new process: rc {proc.returncode}\n"
                                      f"{proc.stderr[-2000:]}")

    run_a = _train_exp(root, "straight", loader, total_epochs=3, train_mode="epoch")
    drive(run_a)
    diffs = {}
    for what, run, e in (("resumed in this process, step mode", run_b, 2),
                         ("resumed in a new process, step mode", run_f, 2),
                         ("epoch 0 of the process's first run", run_b, 0),
                         ("epoch 1 of the process's first run", run_b, 1)):
        a = _ckpt(run_a, e)
        b = _ckpt(run, e) if run is run_b or proc.returncode == 0 else None
        same = b is not None and a["g_losses"] == b["g_losses"] and a["d_losses"] == b["d_losses"]
        diff = math.inf if b is None else _max_state_diff(a, b)
        diffs[what] = {"losses_equal": same, "max_diff": diff}
        print(f"reproducibility: {what} vs epoch {e} of 3 straight epochs run later in this "
              f"process: losses equal {same}, max weight/moment diff {diff:.3g}", flush=True)
        smoke.check(same and diff == 0.0, f"{what} differs from the straight run (max diff {diff})")
    print(f"resume in a new process: {fresh_s:.1f} s (process start and kernel library load "
          f"included)", flush=True)
    report.update(reproducibility=diffs, fresh_process_resume_s=fresh_s)

    run_c = _train_exp(root, "bf16", loader, total_epochs=1, train_dtype="bfloat16")
    stats16, _, _ = drive(run_c)
    c16, c32 = _ckpt(run_c, 0), _ckpt(run_a, 0)
    smoke.check(bool(np.isfinite(c16["g_losses"] + c16["d_losses"]).all()),
                "bf16 epoch: non-finite losses")
    g_rel = float(np.max(np.abs(np.subtract(c16["g_losses"], c32["g_losses"]))
                         / np.abs(c32["g_losses"])))
    print(f"bf16 epoch 0 G losses {np.round(c16['g_losses'], 3).tolist()}\n"
          f"f32  epoch 0 G losses {np.round(c32['g_losses'], 3).tolist()}\n"
          f"bf16 epoch 0 D losses (mean per step) "
          f"{np.round(np.reshape(c16['d_losses'], (-1, N_CRITIC)).mean(1), 3).tolist()}\n"
          f"f32  epoch 0 D losses (mean per step) "
          f"{np.round(np.reshape(c32['d_losses'], (-1, N_CRITIC)).mean(1), 3).tolist()}\n"
          f"bf16 vs f32 G loss max relative difference {g_rel:.3g}; bf16 epoch "
          f"{stats16['epochs'][0]['seconds']:.2f} s", flush=True)
    report.update(bf16_g_losses=c16["g_losses"], f32_g_losses=c32["g_losses"],
                  bf16_g_loss_max_rel_diff=g_rel, bf16_epoch_s=stats16["epochs"][0]["seconds"])
    return report


# Biases that feed an instance norm: their gradient is zero up to rounding,
# so its sign, and Adam's first move of them, is noise.
IN_BIASES = frozenset(
    {f"{blk}.{i}.bias" for blk in ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1")
     for i in (0, 3)}
    | {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g", "psi")}
    | {f"d.model.{i}.bias" for i in (2, 5, 8)}
)


def _pinned_step(torch, dev, dtype, inputs, n_critic: int, reverse_critic: bool = False):
    """One WGAN-GP step from seed-7 weights on ``dev`` in ``dtype``, the
    dropout masks and eps pinned through the seams.  ``reverse_critic``
    applies each critic update against its gradient: a wrong update, to
    read what the checks must catch.  Returns the losses, the Adam first
    moments by parameter name (critic's prefixed ``d.``) and the seconds."""
    from scgrhc_torch.models import generator as gen_mod
    from scgrhc_torch.train import wgan

    scg, rhc, eps = inputs
    cfg = wgan.TrainConfig(n_critic=n_critic, alpha=ALPHA)
    draws = {"mask": 0, "eps": 0}

    def dropout(x, rate, rng_, train):
        draws["mask"] += 1
        m = np.random.default_rng(1000 + draws["mask"]).random(tuple(x.shape)) < 1.0 - rate
        return x * torch.from_numpy(m).to(x) / (1.0 - rate)

    def draw_eps(rng_, n, device):
        draws["eps"] += 1
        return torch.from_numpy(eps[draws["eps"] - 1]).to(device)

    state = wgan.init_state(7, len(CHANNELS), cfg, dev)
    state.generator.to(dtype)
    state.critic.to(dtype)

    def apply(opt, params, loss):
        sign = -1.0 if reverse_critic and opt is state.d_opt else 1.0
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = sign * g
        opt.step()

    seams = (gen_mod.dropout, wgan._draw_eps, wgan._apply)
    gen_mod.dropout, wgan._draw_eps, wgan._apply = dropout, draw_eps, apply
    try:
        t0 = time.perf_counter()
        d, g = wgan.train_step(state, torch.from_numpy(scg).to(dev, dtype),
                               torch.from_numpy(rhc).to(dev, dtype), None, cfg)
        losses = np.append(d.cpu().double().numpy(), float(g))
        seconds = time.perf_counter() - t0
    finally:
        gen_mod.dropout, wgan._draw_eps, wgan._apply = seams
    moments = {}
    for prefix, module, opt in (("", state.generator, state.g_opt),
                                ("d.", state.critic, state.d_opt)):
        for name, p in module.named_parameters():
            moments[prefix + name] = opt.state[p]["exp_avg"].detach().cpu().double().numpy()
    return losses, moments, seconds


def _moments_rel(a: dict, b: dict, critic: bool) -> float:
    """Relative L2 distance of one module's first moments, the biases that
    feed an instance norm left out."""
    keys = [k for k in b if k.startswith("d.") == critic and k not in IN_BIASES]
    x, y = (np.concatenate([m[k].ravel() for k in keys]) for m in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def cross_check_step(torch, smoke: Smoke) -> dict:
    """The WGAN-GP step at full width (B = 4) on the card against the same
    step on the CPU, same weights, dropout masks and eps:

      * the gradients, as Adam's first moments after a step with n_critic 1
        (exp_avg = (1 - beta1)·g at the starting weights: the critic's at
        init, the generator's too, as its adversarial term scores the real
        rhc), and the float64 CPU step beside them for the f32 envelope;
      * the losses of a full step (n_critic 5), and beside them the same
        step on the CPU with the critic's updates reversed.
    """
    rng = np.random.default_rng(11)
    b = 4
    scg = rng.random((b, len(CHANNELS), T)).astype(np.float32)
    rhc = rng.random((b, 1, T)).astype(np.float32)
    eps = [rng.random((b, 1, 1)).astype(np.float32) for _ in range(N_CRITIC)]
    inputs = (scg, rhc, eps)
    f32, f64 = torch.float32, torch.float64

    _, m_card, _ = _pinned_step(torch, "cuda", f32, inputs, 1)
    _, m_cpu, _ = _pinned_step(torch, "cpu", f32, inputs, 1)
    _, m_64, _ = _pinned_step(torch, "cpu", f64, inputs, 1)
    mom = {f"{who}_{mod}": _moments_rel(x, y, mod == "d")
           for who, (x, y) in (("card_vs_cpu", (m_card, m_cpu)), ("card_vs_f64", (m_card, m_64)),
                               ("cpu_vs_f64", (m_cpu, m_64)))
           for mod in ("g", "d")}

    l_card, _, s_card = _pinned_step(torch, "cuda", f32, inputs, N_CRITIC)
    l_cpu, _, s_cpu = _pinned_step(torch, "cpu", f32, inputs, N_CRITIC)
    l_rev, _, _ = _pinned_step(torch, "cpu", f32, inputs, N_CRITIC, reverse_critic=True)
    rel = np.abs(l_card - l_cpu) / np.abs(l_cpu)
    rel_rev = np.abs(l_rev - l_cpu) / np.abs(l_cpu)
    # the critic losses after the first update (the generator's loss, last,
    # is taken before its own update and moves little with the critic's)
    later, later_rev = float(rel[1:N_CRITIC].max()), float(rel_rev[1:N_CRITIC].max())
    print(f"train step cross-check (B={b}, full width): first moments, relative L2 without "
          f"the biases before an instance norm (tol {TOL_STEP_MOMENTS:g}): G card vs cpu "
          f"{mom['card_vs_cpu_g']:.3g}, D card vs cpu {mom['card_vs_cpu_d']:.3g}; card vs f64 "
          f"G {mom['card_vs_f64_g']:.3g} D {mom['card_vs_f64_d']:.3g}; cpu f32 vs f64 G "
          f"{mom['cpu_vs_f64_g']:.3g} D {mom['cpu_vs_f64_d']:.3g}", flush=True)
    print(f"train step cross-check losses (n_critic {N_CRITIC}), card vs cpu relative: first "
          f"critic loss {rel[0]:.3g} (tol {TOL_STEP_LOSS0:g}), later critic losses max "
          f"{later:.3g} (tol {TOL_STEP_LOSSES:g}), generator loss {rel[-1]:.3g} (tol "
          f"{TOL_STEP_LOSSES:g}); the critic's updates reversed, on the cpu: later critic "
          f"losses max {later_rev:.3g}; cpu step {s_cpu:.1f} s, card step {s_card:.2f} s",
          flush=True)
    for mod in ("g", "d"):
        smoke.check(mom[f"card_vs_cpu_{mod}"] <= TOL_STEP_MOMENTS,
                    f"step cross-check {mod} first moments {mom[f'card_vs_cpu_{mod}']}")
    smoke.check(rel[0] <= TOL_STEP_LOSS0, f"step cross-check first loss {rel[0]}")
    smoke.check(max(later, rel[-1]) <= TOL_STEP_LOSSES, f"step cross-check losses {rel}")
    smoke.check(later_rev > TOL_STEP_LOSSES,
                f"step cross-check: a reversed critic update reads {later_rev}, inside the "
                f"loss tolerance {TOL_STEP_LOSSES}")
    return {"step_cross_check": {"loss_rel_diffs": rel.tolist(),
                                 "reversed_critic_loss_rel_diffs": rel_rev.tolist(),
                                 "first_moment_rel_l2": mom}}


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
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", build.log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", build.log)]
    print(f"ptxas: {len(regs)} kernel instances, registers {min(regs, default=0)}-"
          f"{max(regs, default=0)}, {sum(n > 0 for n in spills)} with spill stores (up to "
          f"{max(spills, default=0)} bytes); full log in {OUT_DIR}/chip_smoke.json", flush=True)

    k1f = check_conv_in_relu(torch, smoke)
    k4 = check_normalize_windows(torch, smoke)
    k1b = check_conv_in_relu_bwd(torch, smoke)
    k2 = check_critic_layers(torch, smoke)

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serve = serve_end_to_end(torch, smoke, os.path.join(root, "serve"), card)
        train = train_end_to_end(torch, smoke, os.path.join(root, "train"), card)
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
        {"name": "conv_in_relu_bwd", "route": "cuda",
         "source": "scgrhc_torch/csrc/conv_in_relu.cu",
         "replaces": "scgrhc/ops/pallas/conv_block.py:82", "launches":
         train["launches"]["conv_in_relu_bwd"], "max_abs_err": k1b["max_abs_err"],
         "ms": k1b["ms"], "plain_ms": k1b["plain_ms"], "bound_ms": k1b["bound_ms"],
         "bound_by": k1b["bound_by"], "library_ms": None},
    ]
    # K2: one critic pass (the 5 layers).  One PyTorch call computes only
    # the linear layer (conv4, 512 -> 1): library_ms is that call's time,
    # beside the kernel's on the same layer (library_layer_ms).
    for name, line in (("critic_layer", 196), ("critic_layer_bwd_dx", 205),
                       ("critic_layer_bwd_dwdb", 222)):
        rec = k2[name]
        lin = next(r for r in rec["per_shape"].values() if r["mode"] == "linear")
        kernels.append({
            "name": name, "route": "cuda", "source": "scgrhc_torch/csrc/critic_layer.cu",
            "replaces": f"scgrhc/ops/pallas/critic_fused.py:{line}",
            "launches": train["launches"][name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": lin["library_ms"],
            "library_covers": "conv4 (512->1, linear) only", "library_layer_ms": lin["ms"],
        })
    for k in kernels:
        k["status"] = "fail" if smoke.errors else "ok"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "count": count,
                   "build_seconds": build.seconds, "build_log": build.log,
                   "conv_in_relu": k1f, "normalize_windows": k4,
                   "conv_in_relu_bwd": k1b, **k2, "serve": serve, "train": train,
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
