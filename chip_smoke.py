#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scgrhc_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``scgrhc_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes its path gives it
(f32 and bf16) and times both, then drives three paths end to end at the
model's full width, counting kernel launches from 0 just before each:

  * serving, through ``scgrhc_torch.pipeline.serve.run`` on synthetic
    records (random weights from a fixed seed), with one short record
    cross-checked against the same request served on the CPU;
  * whole records, through the daemon's continuous mode (``{"record": ...,
    "continuous": true}``: 14 K1f launches a record, at N = 1 and T = L)
    on the 600-s and 1800-s records, with each request's time and peak
    device memory, the 600-s answer held to the float64 forward within
    twice the CPU's own f32 distance (float64 on the card, the plain
    versions), and ``python -m scgrhc_torch predict
    <dir> SYN000 last --continuous`` in a new process; K1f alone at the 14
    layer shapes of the 1800-s record (T = 900,000), against float64 and
    its plain version, timed and split by trace into the conv core and the
    row pass;
  * training, through ``scgrhc_torch.train.run.run`` on the 400 windows of
    a 600-s synthetic record: 2 epochs in epoch mode, then a resume to a
    third in step mode, in this process and in a new one
    (``python -m scgrhc_torch train``), each held bit for bit to an
    uninterrupted 3-epoch run; one bfloat16 epoch beside the f32 losses;
  * the experiment pipeline, ``python -m scgrhc_torch <dir>`` in a new
    process (data with K3 → train 2 epochs → test valid all → select →
    test test best) on a synthetic database of 4 records x 1800 s, its
    loader files held to the host-gated data stage's, its comparison CSVs'
    scores to a float64 recomputation and a few predictions to the CPU's;
    then ``test <dir> train last``, timed;
  * windows of 3 s (``segment_size`` 3.0, T = 1500): the layer kernels and
    K3 held against their plain versions at T = 1500, a 600-s record served
    on the card and on the CPU, and 2 epochs of training at B = 32, with the
    same launch counts as at T = 750.

Then more phases:

  * the record read (the ``record_read`` phase): the C WFDB decoder
    (``scgrhc_torch/native``, built with the host compiler) that
    ``io/wfdb.rdrecord`` takes, against the NumPy decode it replaced, on a
    4-h 500-Hz record of 5 channels in formats 16 and 212 with sentinel
    samples (equal bit for bit; each path's median ms of 3 reads and
    ``tracemalloc``'s peak bytes), and the 1800-s continuous request's
    read against that request's ``ms``;

  * the loader artifacts: the pipeline experiment's data stage again with
    ``loader_backend: "torch"`` (pickled torch DataLoaders), read back by
    the port to the native files' arrays exactly, and one epoch trained
    from each set of files to the same losses;
  * calibration: the daemon with ``--calibrate`` on the pipeline
    experiment, its calibrated waveform held to the normalized one × (hi −
    lo) + lo, (lo, hi) to a float64 reduction of the train loader's RHC
    (min, max);
  * int8: the 17 quantized convs' int8 products at N = 512 equal in int32
    to the CPU's, the int8 forward against f32 above a PCC of 0.9 a window
    at tests/test_quant.py's conditions (random weights, uniform windows),
    and ``test <dir> valid last`` with ``"dtype": "int8"`` beside float32
    (finite scores; each window's PCC against float32 and against the
    CPU's int8 read), both timed;
  * a traced training epoch: ``SCGRHC_PROFILE_DIR`` set around one epoch
    of the 600-s record, the Chrome trace checked for the ``train_epoch``
    span and the port's kernels, and the step's device time split from it
    (busy share, the ten costliest device operations, the time in no
    kernel of the port, and that time by the autograd node that launched
    it), and by phase span from ``phases.json``;
  * the host-side CLI (the ``cli`` phase): ``demo`` on 2 synthetic 60-s
    records in process (the five training kernels counted from 0; without
    matplotlib its figures are skipped with a line that says so),
    ``export`` of its best checkpoint read back as ``torch.save`` and
    through the port's loader, ``report`` over its root, waveform_07 (PA, 2
    SCG channels) trained 1 epoch in f32 with ``channel_bucket`` off and on
    (the port reads the key and ignores it, so the checkpoints must be
    equal bit for bit), ``run_sweep`` in process on
    waveform_23 and waveform_07 under ``train_profile: "fast"``, and
    ``summary`` on the demo's database, each sub-phase's seconds printed;
  * the data axis (the ``dist`` phase): ``torchrun --nproc-per-node=2 -m
    scgrhc_torch <dir> --device cuda:0`` on the pipeline's configuration,
    both ranks on this card over gloo (NCCL refuses two ranks on one
    device), against the pipeline phase's run at world size 1 (the loader
    files and record log equal, rank 1 writing nothing, each rank's kernel
    launches, the weights after 2 epochs within a bound, both wall times:
    two ranks sharing one card is no scaling figure); ``predict <dir>
    LONG030 last --mesh`` (1200 windows) at world
    size 2 over gloo against world size 1, both timed;
  * Orbax checkpoints (the ``orbax`` phase): ``python -m scgrhc_torch
    <dir>`` with ``checkpoint_backend: "orbax"`` on the pipeline phase's
    configuration, held to that phase's pickle-backend run (each epoch's
    weights and Adam moments bit for bit, the CSVs and
    ``checkpoint_best.txt`` byte for byte), one more epoch resumed from the
    last ``.orbax`` dir against the same resume from the pickle, a copy of
    that dir split into the chunk grids Orbax writes on 4 devices (loaded
    onto the card bit for bit against the one-chunk dir, both loads timed,
    and the same epoch resumed from it), ``predict`` (max-abs 0.0, 14 K1f
    and 1 K4 a chunk) and ``export`` from the best ``.orbax``, and one full
    checkpoint saved (blocking and in the background) and loaded by each
    backend, timed, with its bytes on disk; its figures on a
    ``{"orbax": ...}`` line before the record read's.

K3 is also held at T = 12,289 and timed at N = 37, 300, 2,400 and 19,200
beside an empty kernel on its grid (the launch floor); the data stage's
device backend is split, for one interval, into host framing, upload, K3
and the download of ``keep``.

It also checks the build: tensor-core instructions (HMMA, and HGMMA in the
f32 core's warpgroup-MMA instances) in every conv core and dw instance of
the layer's source (``csrc/conv_layer.cu``); the training phase prints the conv launches by path
(``conv3.path_launches``) and fails if an f32 one took mma.sync, and the
dw launches by path (``conv3.dw_path_launches``), failing unless every
f32 dw from 16 output channels took the warpgroup MMA, and those by how
they copied their rows (``conv3.dw_copy_launches``), failing if one took
cp.async where a tensor map fits but was not made.

Any failure exits non-zero before the result lines; without a CUDA device,
or without the package beside it, it exits non-zero at once.

The last five lines of standard output are the Orbax phase's figures
(``{"orbax": {...}}``), the record read's (``{"record_read": {...}}``), the card (``nvidia-smi``'s name and power
limit), one ``{"kernels": [...]}`` JSON object, and ``{"ok": true,
"device": {...}}``.  A kernel's ``ms`` is the time of
back-to-back calls of its wrapper; K3 and K4, whose wrappers cost more
on the host than their kernels on the card, also carry ``graph_ms``, the
same calls replayed from a CUDA graph.  Details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import bisect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc

import numpy as np

N_CHUNK = 512  # windows per chunk on the serving path (STREAM_BATCH)
N_TRAIN = 32  # batch_size of the training path
T = 750  # samples per window (segment_size 1.5 s at 500 Hz)
CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]
# served records (name, seconds): one chunk, three chunks (512 + 512 + 176
# windows), and a short one for the CPU cross-check
RECORDS = (("SYN000", 600.0), ("LONG030", 1800.0), ("SHORT030", 30.0))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): f32 outside the
# tensor cores, the tensor cores in TF32 (the dw product in f32 runs three
# TF32 passes, so a third of it) and in bf16, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
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
# The dw product alone in f32 (K2dw's dw, K1b's dw): 3xTF32 on the tensor
# cores sits within f32 rounding of the plain product; one TF32 pass would
# read about 5e-4, inside TOL_TRAIN["bwd"].
TOL_DW_F32 = 1e-5
N_CRITIC = 5
ALPHA = 1e-4
# The short record served on the card, served on the CPU, and the float64
# forward: on this record and seed the CPU's f32 forward alone sits 2.1e-3
# from the f64 forward (instance norm amplifies f32 rounding in
# low-variance windows; outputs span about [-3.9, 3.1]).
TOL_SERVE = 5e-3

# The pipeline's comparison CSVs: each metric column against its float64
# recomputation from the row's own real_rhc/pred_rhc strings (the device
# computes them in float32), relative to max(1, |value|); reading 1.3e-7 on
# an H100.
TOL_METRIC = 1e-5
MIN_RHC = -50.0
PIPELINE_RECORDS, PIPELINE_SECONDS = 4, 1800.0

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


def _graph_ms(torch, fn, reps=20) -> float:
    """The card's time per call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so the wrapper's host cost (checks,
    allocations, the ctypes call) is out of the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as graph capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # a failed capture fails the run
        for _ in range(reps):
            fn()
    return _time_ms(torch, graph.replay, reps=5, warmup=1) / reps


def _layer_shapes(in_channels: int, t: int = T):
    """(C_in, O, T) of the 14 K1f launches of one generator forward at
    windows of t steps, in order."""
    from scgrhc_torch.models.generator import BLOCKS

    lengths = (t, t - 2, t - 4, t - 6, t - 4, t - 2, t)
    shapes = []
    for (_, cin, cout), t in zip(BLOCKS, lengths):
        cin = in_channels if cin is None else cin
        shapes += [(cin, cout, t), (cout, cout, t)]
    return shapes


def _kernel_label(kernel: str, args: str) -> str:
    """A short name for a conv3.cuh kernel instance from its mangled
    template arguments."""
    dtype = "bf16" if "nv_bfloat16" in args else "f32"
    if kernel == "dw_mma_kernel" and "DwWgTile" in args:
        return "<f32, wgmma>"
    if kernel == "dw_mma_kernel":  # DwTile: bf16 only
        return f"<bf16, {8 if 'Lb1E' in args else 4}-byte copies>"
    if kernel == "conv_mma_kernel" and "WgTile" in args:
        bn, mw, stages, pw = re.search(r"WgTileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", args).groups()
        return (f"<f32, wgmma, {bn} cols x {128 * int(mw)} steps, {stages} stages, {pw} "
                f"producer warps>")
    if kernel == "conv_mma_kernel":
        transw, relu, pairs = (f == "1" for f in re.findall(r"Lb(\d)E", args))
        types = args[:args.index("Lb")]
        out = ", f32 out" if dtype == "bf16" and not transw and types.endswith("f") else ""
        return (f"<{dtype}, {'dx' if transw else 'conv'}{', relu' if relu else ''}{out}, "
                f"{8 if pairs else 4}-byte copies>")
    omax, vec = re.search(r"Li(\d+)ELi(\d+)E", args).groups()
    out = ", f32 out" if kernel == "conv_stream_kernel" and dtype == "bf16" and args[
        :args.index("Li")].endswith("f") else ""
    return f"<{dtype}{out}, O <= {omax}, {vec} a load>"


TC_KERNELS = ("dw_mma_kernel", "conv_mma_kernel")  # every instance must hold HMMA or HGMMA
# The one source of the library that includes conv3.cuh (csrc/conv_layer.cu):
# its kernel instances carry the name in their anonymous namespace.
LAYER_SOURCE = "conv_layer"


def _source(line: str) -> str:
    return LAYER_SOURCE if LAYER_SOURCE in line else "another source"


def sass_hmma(smoke: Smoke, lib_path) -> dict | None:
    """Tensor-core instructions in the built library's SASS (``cuobjdump
    -sass``): HMMA (mma.sync) and HGMMA (the warpgroup MMA of the f32
    conv core and dw stage), per instance of the dw stage's and the conv
    core's kernels, by source; every dw_mma_kernel and conv_mma_kernel
    instance must hold some, and the layer's source must hold
    conv_mma_kernel and dw_mma_kernel instances on HGMMA.  None when the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.isfile(tool) else shutil.which("cuobjdump")
    if tool is None:
        print("sass: no cuobjdump; HMMA count not measured", flush=True)
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(dw_mma_kernel|dw_stream_kernel|conv_mma_kernel|conv_stream_kernel|"
                          r"dx_stream_kernel)I(\w*?)Ev(?:PK|\d+CUtensorMap)", line)
            name = None
            if m:
                name = f"{m.group(1)}{_kernel_label(m.group(1), m.group(2))} ({_source(line)})"
                counts[name] = 0
        elif name and re.search(r"\bH(?:G)?MMA\.", line):
            counts[name] += 1
    tc = {k: v for k, v in counts.items() if k.startswith(TC_KERNELS)}
    for kernel in ("conv_mma_kernel", "dw_mma_kernel"):
        smoke.check(any(k.startswith(f"{kernel}<f32, wgmma") and k.endswith(f"({LAYER_SOURCE})")
                        for k in tc),
                    f"sass: no warpgroup-MMA {kernel} instance from {LAYER_SOURCE}.cu")
    smoke.check(all(v > 0 for v in tc.values()),
                f"sass: tensor-core kernel instances without HMMA or HGMMA: "
                f"{ {k: v for k, v in tc.items() if v == 0} }")
    for kernel in ("dw_mma_kernel", "dw_stream_kernel", "conv_mma_kernel", "conv_stream_kernel",
                   "dx_stream_kernel"):
        print(f"sass: HMMA and HGMMA instructions per {kernel} instance "
              f"{ {k[len(kernel):]: v for k, v in counts.items() if k.startswith(kernel)} }",
              flush=True)
    return counts


ROW_MODES = ("in_relu fwd", "relu fwd", "in_relu dc", "relu dc")  # conv3.cuh: RowMode


def ptxas_lines(log: str) -> dict:
    """Registers and spill bytes per kernel instance of the conv core and
    the dw stage's tensor-core paths, by source, from the build's ``-Xptxas
    -v`` lines."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(conv_mma_kernel|conv_stream_kernel|"
                      r"dx_stream_kernel|row_kernel|dw_mma_kernel)I(\w*?)EEv\w*'", line)
        if "Compiling entry function" in line:
            name = None
            if m:
                if m.group(1) == "row_kernel":
                    mode = int(re.search(r"Li(\d)E", m.group(2)).group(1))
                    label = (f"<{'bf16' if 'nv_bfloat16' in m.group(2) else 'f32'}, "
                             f"{ROW_MODES[mode]}>")
                else:
                    label = _kernel_label(m.group(1), m.group(2))
                name = f"{m.group(1)}{label} ({_source(line)})"
                out[name] = {"registers": 0, "spill_bytes": 0}
        elif name and "spill stores" in line:
            out[name]["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def check_conv_in_relu(torch, smoke: Smoke) -> dict:
    """K1f at every serving layer shape, N = 512, f32 and bf16; bounds at
    the f32 FMA peak and at the rates the kernel runs at (the conv on the
    tensor cores: 3xTF32 in f32, bf16)."""
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
            "byte_bound_ms": nbytes / PEAK_BYTES * 1e3, **_rate_bounds(0.0, flops, nbytes),
        }
        per_shape[(cin, o, t)] = rec
        print(
            f"conv_in_relu N={N_CHUNK} C_in={cin} O={o} T={t}: f32 err {err32:.3g} "
            f"(tol {TOL_F32:g}), bf16 err {err16:.3g} (tol {TOL_BF16[0]:g} + "
            f"{TOL_BF16[1]:g}|ref|), kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, bf16 kernel {rec['bf16_ms']:.3f} ms, bound "
            f"{max(rec['flop_bound_ms'], rec['byte_bound_ms']):.3f} ms (f32 FMA), "
            f"{rec['rate_bound_ms']:.3f} ms at the kernel's rate (3xTF32; bf16 "
            f"{rec['bf16_rate_bound_ms']:.3f}), library call none",
            flush=True,
        )
        smoke.check(err32 <= TOL_F32, f"conv_in_relu f32 {cin}x{o}x{t}: err {err32}")
        smoke.check(ok16, f"conv_in_relu bf16 {cin}x{o}x{t}: err {err16}")
        del x, w, b, y, ref, xb, wb, bb, yb, refb, diff
    # one generator forward's 14 launches at N = 512
    total = {k: sum(per_shape[s][k] for s in shapes)
             for k in ("ms", "plain_ms", "bf16_ms", "flop_bound_ms", "byte_bound_ms",
                       "rate_bound_ms", "bf16_rate_bound_ms")}
    bound = max(total["flop_bound_ms"], total["byte_bound_ms"])
    print(f"conv_in_relu N={N_CHUNK}, the 14 layers of a generator forward: kernel "
          f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, bf16 kernel "
          f"{total['bf16_ms']:.3f} ms, bound {bound:.3f} ms (f32 FMA), "
          f"{total['rate_bound_ms']:.3f} ms at the kernel's rate (bf16 "
          f"{total['bf16_rate_bound_ms']:.3f})", flush=True)
    return {
        "max_abs_err": max(r["f32_max_abs_err"] for r in per_shape.values()),
        "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in per_shape.values()),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bf16_ms": total["bf16_ms"],
        "rate_bound_ms": total["rate_bound_ms"],
        "bf16_rate_bound_ms": total["bf16_rate_bound_ms"],
        "bound_ms": bound,
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
        "graph_ms": _graph_ms(torch, lambda: normalize_windows(w)),
        "plain_ms": _time_ms(torch, lambda: normalize_windows_plain(w), reps=20),
        "bound_ms": max(nbytes / PEAK_BYTES, 3.0 * w.numel() / PEAK_F32_FLOPS) * 1e3,
        "bound_by": "bytes",
    }
    print(
        f"normalize_windows N={N_CHUNK} C={c} T={T}: err {err:.3g} (tol {TOL_K4:g}), "
        f"NaN window all-NaN {nan_window}, NaN pattern equal {same_nan}, kernel "
        f"{rec['ms']:.4f} ms ({rec['graph_ms']:.4f} ms in a CUDA graph), plain "
        f"{rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.4f} ms, library call none",
        flush=True,
    )
    smoke.check(same_nan and nan_window, "normalize_windows NaN propagation")
    smoke.check(err <= TOL_K4, f"normalize_windows err {err}")
    return rec


def _gate_windows(torch, n: int, c: int, t: int = T):
    """Pressure-like windows away from the gate's thresholds, with window 3
    flat, 5 a ramp, 7 dipping below MIN_RHC and 11 holding a NaN."""
    rng = np.random.default_rng(n + c)
    tt = np.arange(t) / 500.0
    rhc = (20 + 10 * np.sin(2 * np.pi * rng.uniform(0.9, 1.5, (n, 1)) * tt)
           + rng.standard_normal((n, t)))
    scg = rng.standard_normal((n, c, t)) * rng.uniform(0.01, 2, (n, 1, 1))
    rhc[3] = 7.25
    rhc[5] = np.linspace(0, 30, t) + 0.01 * rng.standard_normal(t)
    rhc[7, t // 7] = MIN_RHC - 30
    rhc[11, t // 3] = np.nan
    scg[11, 0, t // 2] = np.nan
    return (torch.from_numpy(scg.astype(np.float32)).cuda(),
            torch.from_numpy(rhc.astype(np.float32)).cuda())


def hold_gate_normalize(torch, smoke: Smoke, n: int, c: int, t: int) -> float:
    """K3 against its plain version on _gate_windows: keep equal (the edge
    windows dropped, the others kept), (lo, hi) equal, NaN in the same
    places, the normalized windows within TOL_K4; its largest error."""
    from scgrhc_torch.ops.kernels.dsp import gate_and_normalize, gate_and_normalize_plain

    scg, rhc = _gate_windows(torch, n, c, t)
    got = gate_and_normalize(scg, rhc, MIN_RHC)
    ref = gate_and_normalize_plain(scg, rhc, MIN_RHC)
    torch.cuda.synchronize()
    keep_equal = bool(torch.equal(got[0], ref[0]))
    nan_equal = all(bool(torch.equal(torch.isnan(g), torch.isnan(r)))
                    for g, r in zip(got[1:], ref[1:]))
    mm_equal = all(bool(torch.equal(torch.nan_to_num(g), torch.nan_to_num(r)))
                   for g, r in zip(got[3:], ref[3:]))
    err = max(float((torch.nan_to_num(g) - torch.nan_to_num(r)).abs().max())
              for g, r in zip(got[1:3], ref[1:3]))
    edges = not bool(got[0][[3, 5, 7, 11]].any()) and int(got[0].sum()) == n - 4
    what = f"gate_and_normalize N={n} C={c} T={t}"
    print(f"{what}: keep equal {keep_equal} (kept {int(got[0].sum())}, edge windows dropped "
          f"{edges}), (lo, hi) equal {mm_equal}, NaN pattern equal {nan_equal}, normalized err "
          f"{err:.3g} (tol {TOL_K4:g})", flush=True)
    smoke.check(keep_equal and edges, f"{what}: keep")
    smoke.check(mm_equal and nan_equal, f"{what}: (lo, hi) or NaN")
    smoke.check(err <= TOL_K4, f"{what}: err {err}")
    return err


# K3 is timed at a ragged interval, a 450-s chamber interval (the main
# path's size), and throughput probes 8 and 64 times that.
K3_TIMING_N = (37, 300, 2_400, 19_200)
K3_LONG_T = 12_289  # one sample past the longest window K3 took before its redesign


def check_gate_normalize(torch, smoke: Smoke, card: str) -> dict:
    """K3 at the data stage's shapes: a 450-s chamber interval (300 windows)
    with 4 and with 1 SCG channel, a ragged 37 windows, and 37 windows of
    K3_LONG_T samples.  Times at (N, 4, 750) for N in K3_TIMING_N: the
    wrapper back to back, the kernel in a CUDA graph, and an empty kernel on
    the same grid in a graph (the launch floor), each beside its byte
    bound; the numbers of the kernels line are those at N = 300."""
    from scgrhc_torch.ops.kernels import _build
    from scgrhc_torch.ops.kernels.dsp import gate_and_normalize, gate_and_normalize_plain

    errs = [hold_gate_normalize(torch, smoke, n, c, t)
            for n, c, t in ((300, 4, T), (300, 1, T), (37, 4, T), (37, 4, K3_LONG_T))]
    lib, c = _build.library(), len(CHANNELS)

    def floor(n):
        _build.check(lib.scgrhc_gate_normalize_floor(n, torch.cuda.current_stream().cuda_stream),
                     "gate_normalize_floor")

    per_n = {}
    for n in K3_TIMING_N:
        scg, rhc = _gate_windows(torch, n, c)
        # bytes: each input read once, each output written once; operations
        # per rhc sample: a sliding max and min (3 comparisons each, van
        # Herk), the flat test, the mean, yc, yc*xc, yc^2 and the range test,
        # the window's min and max, and the normalizing subtraction and
        # division (16); per scg sample its min, max, subtraction and
        # division (4)
        nbytes = 2.0 * 4 * n * (c + 1) * T + n * (1 + 2 * 2 * 4)
        ops = n * T * 16.0 + n * c * T * 4.0
        rec = {
            "ms": _time_ms(torch, lambda: gate_and_normalize(scg, rhc, MIN_RHC), reps=20),
            "graph_ms": _graph_ms(torch, lambda: gate_and_normalize(scg, rhc, MIN_RHC)),
            "floor_graph_ms": _graph_ms(torch, lambda: floor(n)),
            "plain_ms": _time_ms(torch, lambda: gate_and_normalize_plain(scg, rhc, MIN_RHC),
                                 reps=20),
            "bound_ms": max(nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS) * 1e3,
            "bound_by": "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32_FLOPS else "operations",
        }
        per_n[n] = rec
        share = 100 * rec["bound_ms"] / rec["graph_ms"]
        print(f"gate_and_normalize N={n} C={c} T={T}: wrapper {rec['ms']:.4f} ms back to back, "
              f"kernel {rec['graph_ms']:.4f} ms in a CUDA graph ({share:.0f} % of its bound), "
              f"empty kernel on its grid {rec['floor_graph_ms']:.4f} ms in a graph, plain "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"library call none, on {card}", flush=True)
        del scg, rhc
    return {**per_n[300], "max_abs_err": max(errs), "per_n": per_n}


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

    report = {"wall_s": wall, "launches": launches, "requests": [], "exp": exp}
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
    from scgrhc_torch.pipeline import serve

    name = RECORDS[-1][0]
    cpu_out = io.StringIO()
    t0 = time.perf_counter()
    serve.run(params, checkpoint="last", device="cpu", stdout=cpu_out,
              stdin=io.StringIO(json.dumps({"record": name, "save": False}) + "\n"))
    cpu_s = time.perf_counter() - t0
    cpu_wave = np.asarray(json.loads(cpu_out.getvalue()).get("waveform", []), np.float32)

    ref = _f64_waveform(torch, params, name, T)

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


def _train_inputs(torch, gen, cin, o, t, n=N_TRAIN):
    bound = 1.0 / math.sqrt(cin * 3)
    x = torch.randn(n, cin, t, device="cuda", generator=gen)
    w = (torch.rand(o, cin, 3, device="cuda", generator=gen) * 2 - 1) * bound
    b = (torch.rand(o, device="cuda", generator=gen) * 2 - 1) * bound
    dy = torch.randn(n, o, t, device="cuda", generator=gen)
    return x, w, b, dy


def _hold(smoke, what, outs, refs, floors, tol) -> tuple[float, float]:
    """Relative L2 error (checked) and max abs error of kernel outputs."""
    rel = max(_rel(g, r, f) for g, r, f in zip(outs, refs, floors))
    err = max(float((g.double() - r.double()).abs().max()) for g, r in zip(outs, refs))
    smoke.check(rel <= tol, f"{what}: relative error {rel} over {tol}")
    return rel, err


def _hold_dw(smoke, what, torch, again, got, ref) -> float:
    """The f32 dw alone (``got[-2]``) against the plain version, checked
    against TOL_DW_F32, and ``again()``, a second launch, equal to ``got``
    bit for bit."""
    rel = _rel(got[-2], ref[-2])
    smoke.check(rel <= TOL_DW_F32, f"{what}: dw relative error {rel} over {TOL_DW_F32}")
    smoke.check(all(torch.equal(a, g) for a, g in zip(again(), got)),
                f"{what}: a repeated launch gave other bits")
    return rel


def _dc_on_masks(torch, x, w, b, dy, mode, mask):
    """dc from the plain backward's formulas in float64, with the relu mask
    ``mask`` in place of the plain version's own sign test.  With the
    kernels' own masks (the forward kernel's output > 0) it is the
    reference of the backward kernels: their dc pass sums the conv in
    another order than cuDNN, so a mask can flip between a kernel and the
    plain f32 version where c or x̂ lies within f32 rounding of 0, and one
    flip moves dw by a few 1e-5 at N = 32, dx by up to 1e-3."""
    from scgrhc_torch.ops.kernels import conv3

    x64, w64, b64, dy64 = (v.double() for v in (x, w, b, dy))
    g = dy64 * mask.double()
    if mode == "in_relu":
        c = conv3.conv(x64, w64, b64)
        mean = c.mean(dim=-1, keepdim=True)
        rsig = torch.rsqrt(torch.clamp_min((c * c).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
                           + conv3.IN_EPS)
        xhat = (c - mean) * rsig
        dc = rsig * (g - g.mean(dim=-1, keepdim=True)
                     - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        del c, xhat
    else:
        dc = dy64 if mode == "linear" else g
    return dc


def _dwdb_on_masks(torch, x, w, b, dy, mode, mask) -> list:
    """[dw, db] of the plain backward in float64 on the relu mask ``mask``
    (:func:`_dc_on_masks`): dw over dc rounded to x's dtype."""
    dc = _dc_on_masks(torch, x, w, b, dy, mode, mask)
    dw = torch.nn.grad.conv1d_weight(x.double(), w.shape, dc.to(x.dtype).double(), padding=1)
    return [dw, dc.sum(dim=(0, 2))]


def _dx_on_masks(torch, x, w, b, dy, mode, mask):
    """dx of the plain backward in float64 on the relu mask ``mask``: the
    conv's adjoint over dc rounded to x's dtype."""
    dc = _dc_on_masks(torch, x, w, b, dy, mode, mask)
    return torch.nn.functional.conv_transpose1d(dc.to(x.dtype).double(), w.double(), padding=1)


# The share of relu masks on which the kernels' forward and the plain f32
# version may disagree (a few in a million lie within f32 rounding of 0).
MASK_FLIP_SHARE = 1e-5


def _mask_flips(smoke, what, y, ref) -> int:
    """The relu masks (> 0) on which a forward kernel's output ``y`` and the
    plain version's ``ref`` disagree, checked against MASK_FLIP_SHARE."""
    flips = int(((y > 0) != (ref > 0)).sum())
    smoke.check(flips <= MASK_FLIP_SHARE * y.numel(),
                f"{what}: {flips} relu masks differ from the plain version's")
    return flips


def _rate_bounds(fma_flops: float, tc_flops: float, nbytes: float) -> dict:
    """Bounds at the rates the kernels use: ``fma_flops`` on the f32 FMA
    units, ``tc_flops`` on the tensor cores (3xTF32 for f32; bf16); bytes
    at 3.35 TB/s (half as many in bf16)."""
    f32 = max(fma_flops / PEAK_F32_FLOPS + tc_flops / PEAK_TF32X3_FLOPS, nbytes / PEAK_BYTES)
    b16 = max(fma_flops / PEAK_F32_FLOPS + tc_flops / PEAK_BF16_FLOPS, nbytes / 2 / PEAK_BYTES)
    return {"rate_bound_ms": f32 * 1e3, "bf16_rate_bound_ms": b16 * 1e3}


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
    for k in ("dw_rel_err", "bf16_dw_rel_err"):
        if k in recs[0]:
            out[k] = max(r[k] for r in recs)
    return out


def check_conv_in_relu_bwd(torch, smoke: Smoke) -> dict:
    """K1b at the 14 generator layer shapes of one backward, N = 32 (and
    K1f's time at N = 32, the training forward's, for the step breakdown).
    Its dw alone is held to float64 on K1f's relu masks, the kernels' own:
    K1b's dc pass recomputes c on the same tensor-core core, which sums in
    another order than cuDNN, so a mask can flip against the plain f32
    version (one flip moves dw by a few 1e-5 at N = 32)."""
    from scgrhc_torch.ops.kernels.conv_block import (
        conv_in_relu,
        conv_in_relu_bwd,
        conv_in_relu_bwd_plain,
        conv_in_relu_plain,
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
        y = conv_in_relu(x, w, b)
        flips = _mask_flips(smoke, what, y, conv_in_relu_plain(x, w, b))
        dw_rel = _hold_dw(smoke, what, torch, lambda: [g for g in conv_in_relu_bwd(
            x, w, b, dy, need_dx) if g is not None], got,
            _dwdb_on_masks(torch, x, w, b, dy, "in_relu", y > 0))
        del y
        xb, wb, bb, dyb = (v.bfloat16() for v in (x, w, b, dy))
        got = [g for g in conv_in_relu_bwd(xb, wb, bb, dyb, need_dx) if g is not None]
        ref = [r for r in conv_in_relu_bwd_plain(*(v.float() for v in (xb, wb, bb, dyb)), need_dx)
               if r is not None]
        rel16, _ = _hold(smoke, what + " bf16", got, ref, floors[-len(got):], TOL_TRAIN["bf16"])
        dw_rel16 = _rel(got[-2], ref[-2])
        n_conv = 3 if need_dx else 2  # recompute, dw, and dx
        conv = 6.0 * cin * o * t * N_TRAIN
        nbytes = 4.0 * (N_TRAIN * t * (cin * (2 if need_dx else 1) + o) + 6 * o * cin + 2 * o)
        fb, bb_ = _bound_ms(conv * n_conv, nbytes)
        rates = _rate_bounds(0.0, conv * n_conv, nbytes)  # every product on the tensor cores
        rec = {
            "layers": shapes.count((cin, o, t, need_dx)), "rel_err": rel, "max_abs_err": err,
            "mask_flips": flips,
            "bf16_rel_err": rel16, "dw_rel_err": dw_rel, "bf16_dw_rel_err": dw_rel16, **rates,
            "ms": _time_ms(torch, lambda: conv_in_relu_bwd(x, w, b, dy, need_dx)),
            "plain_ms": _time_ms(torch, lambda: conv_in_relu_bwd_plain(x, w, b, dy, need_dx)),
            "bf16_ms": _time_ms(torch, lambda: conv_in_relu_bwd(xb, wb, bb, dyb, need_dx)),
            "fwd_ms": _time_ms(torch, lambda: conv_in_relu(x, w, b)),
            "flop_bound_ms": fb, "byte_bound_ms": bb_,
        }
        per_shape[f"{cin}x{o}x{t}{'' if need_dx else ' no dx'}"] = rec
        print(f"conv_in_relu_bwd N={N_TRAIN} C_in={cin} O={o} T={t} dx={need_dx}: rel err "
              f"{rel:.3g} (tol {TOL_TRAIN['bwd']:g}), max abs err {err:.3g}, dw rel err "
              f"{dw_rel:.3g} (tol {TOL_DW_F32:g}), bf16 rel err {rel16:.3g} (dw {dw_rel16:.3g}; "
              f"tol {TOL_TRAIN['bf16']:g}), kernel {rec['ms']:.3f} ms, plain "
              f"{rec['plain_ms']:.3f} ms, bf16 kernel {rec['bf16_ms']:.3f} ms, bound "
              f"{max(fb, bb_):.3f} ms (f32 FMA), {rates['rate_bound_ms']:.3f} ms at the kernel's "
              f"rate (3xTF32; bf16 {rates['bf16_rate_bound_ms']:.3f}), relu masks flipped "
              f"against the plain version {flips}, library call none; K1f at "
              f"N={N_TRAIN} {rec['fwd_ms']:.3f} ms", flush=True)
        del x, w, b, dy, xb, wb, bb, dyb, got, ref
    return _summary(per_shape, ("ms", "plain_ms", "bf16_ms", "fwd_ms", "flop_bound_ms",
                                "byte_bound_ms", "rate_bound_ms", "bf16_rate_bound_ms"))


def check_critic_layers(torch, smoke: Smoke) -> dict:
    """K2f, K2dx and K2dw at the 5 critic layer shapes, N = 32, T = 750."""
    import torch.nn.functional as F

    from scgrhc_torch.ops.kernels import conv3
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
        # the operations on each unit: the conv core (recompute, forward, dx) on
        # the tensor cores from 16 output channels, else the streams on the
        # FMA units; the dw product on its path's units ("stream": the FMA
        # units), db on the FMA units
        core = "mma" if o >= conv3.CONV_STREAM_BELOW else "fma"
        dw_path = conv3.dw_plan(N_TRAIN, cin, o).path
        units = {
            "critic_layer": {core: conv_flops},
            "critic_layer_bwd_dx": {core: conv_flops * (1 + recompute)},
            "critic_layer_bwd_dwdb": {core: conv_flops * recompute},
        }
        dwdb = units["critic_layer_bwd_dwdb"]
        dw_unit = "mma" if dw_path == "wgmma" else dw_path  # both on the tensor cores
        dwdb[dw_unit] = dwdb.get(dw_unit, 0.0) + conv_flops
        dwdb["fma"] = dwdb.get("fma", 0.0) + N_TRAIN * o * T
        for name, (kern, plain, floors, flops, nbytes, lib, kind) in cases.items():
            what = f"{name} {mode} {cin}x{o}x{T}"
            got, ref = kern(x, w, b, dy), plain(x, w, b, dy)
            torch.cuda.synchronize()
            if name == "critic_layer":
                ref_y = ref[0]  # the plain forward's relu masks, for K2dw's reference
            rel, err = _hold(smoke, what, got, ref, floors, TOL_TRAIN[kind])
            got16, ref16 = kern(xb, wb, bb, dyb), plain(*f16)
            rel16, _ = _hold(smoke, what + " bf16", got16, ref16, floors, TOL_TRAIN["bf16"])
            fb, byb = _bound_ms(flops, nbytes)
            extra = _rate_bounds(units[name].get("fma", 0.0) + units[name].get("stream", 0.0),
                                 units[name].get("mma", 0.0), nbytes)
            if name == "critic_layer_bwd_dwdb":
                y = k2.critic_layer(x, w, b, mode)
                flips = 0 if lin else _mask_flips(smoke, what, y, ref_y)
                extra.update(
                    path=dw_path, mask_flips=flips,
                    dw_rel_err=_hold_dw(smoke, what, torch, lambda: kern(x, w, b, dy), got,
                                        _dwdb_on_masks(torch, x, w, b, dy, mode, y > 0)),
                    bf16_dw_rel_err=_rel(got16[0], ref16[0]))
                del y
            else:
                smoke.check(all(torch.equal(a, g) for a, g in zip(kern(x, w, b, dy), got)),
                            f"{what}: a repeated launch gave other bits")
            rec = {
                "layers": 1, "mode": mode, "rel_err": rel, "max_abs_err": err,
                "bf16_rel_err": rel16, **extra,
                "ms": _time_ms(torch, lambda: kern(x, w, b, dy), reps=10),
                "plain_ms": _time_ms(torch, lambda: plain(x, w, b, dy), reps=10),
                "bf16_ms": _time_ms(torch, lambda: kern(xb, wb, bb, dyb), reps=10),
                "library_ms": None if lib is None else _time_ms(torch, lib, reps=10),
                "flop_bound_ms": fb, "byte_bound_ms": byb,
            }
            if name != "critic_layer_bwd_dwdb" or lin:
                # the card's time alone, the wrapper's host cost out (a
                # library call that cannot be captured reads None)
                rec["graph_ms"] = _graph_ms(torch, lambda: kern(x, w, b, dy))
                if lib is not None:
                    try:
                        rec["library_graph_ms"] = _graph_ms(torch, lib)
                    except RuntimeError:
                        rec["library_graph_ms"] = None
            out[name][f"{cin}x{o}x{T} {mode}"] = rec
            lib_txt = "none" if lib is None else f"{rec['library_ms']:.4f} ms"
            dw_txt = "" if "dw_rel_err" not in rec else (
                f", dw on the {rec['path']} path, dw rel err {rec['dw_rel_err']:.3g} (tol "
                f"{TOL_DW_F32:g}), bf16 dw rel err {rec['bf16_dw_rel_err']:.3g}")
            graph_txt = f" ({rec['graph_ms']:.4f} ms in a CUDA graph)" if "graph_ms" in rec else ""
            print(f"{name} N={N_TRAIN} C={cin} O={o} T={T} {mode}: rel err {rel:.3g} (tol "
                  f"{TOL_TRAIN[kind]:g}), max abs err {err:.3g}, bf16 rel err {rel16:.3g} "
                  f"(tol {TOL_TRAIN['bf16']:g}), kernel {rec['ms']:.4f} ms{graph_txt}, plain "
                  f"{rec['plain_ms']:.4f} ms, bf16 kernel {rec['bf16_ms']:.4f} ms, bound "
                  f"{max(fb, byb):.4f} ms (f32 FMA), {rec['rate_bound_ms']:.4f} ms at the units "
                  f"it runs on (bf16 {rec['bf16_rate_bound_ms']:.4f}){dw_txt}, library call "
                  f"{lib_txt}", flush=True)
        del x, w, b, dy, xb, wb, bb, dyb, f16
    keys = ("ms", "plain_ms", "bf16_ms", "flop_bound_ms", "byte_bound_ms", "rate_bound_ms",
            "bf16_rate_bound_ms")
    for name, call in (("critic_layer", "F.conv1d"), ("critic_layer_bwd_dx", "conv1d_input"),
                       ("critic_layer_bwd_dwdb", "conv1d_weight")):
        lin = out[name][f"{CRITIC_LAYERS[-1][0]}x1x{T} linear"]
        print(f"{name} at the 512 -> 1 layer: kernel {lin['ms']:.4f} ms, {call} "
              f"{lin['library_ms']:.4f} ms, timed alike: kernel faster "
              f"{lin['ms'] < lin['library_ms']}; in a CUDA graph kernel {lin['graph_ms']:.4f} ms, "
              f"{call} {lin['library_graph_ms']} ms", flush=True)
    return {name: _summary(per, keys + (("graph_ms",) if all(
        "graph_ms" in r for r in per.values()) else ())) for name, per in out.items()}


N_GP = 64  # waveform_06's published batch, at which train.w06 runs the GP


def check_gp_vjp(torch, smoke: Smoke) -> dict:
    """BwdDx's backward, K2dx's closed-form vjp (the gradient penalty's
    second order), one node per critic layer at B = N_GP, T = 750, every
    input needing a gradient: each gradient against the plain input
    gradient's vjp in float64 on the kernels' own relu masks (K2f's, which
    K2dx's dc pass recomputes), within TOL_TRAIN["bwd"] (an in_relu bias
    gradient over |Σ|d_c||, the scale it sums to zero from), one launch of
    the vjp a node, and its time (the backward of a recorded K2dx, CUDA
    events) beside its bound: its products (v = conv(u, w) and dw over
    (u, dc); in in_relu also dx and dw over (x, d_c)) at 495/3 TFLOP/s and
    its inputs and outputs (x, u, c, dc, dy, w; dx, d_dy, dw) at 3.35 TB/s."""
    from scgrhc_torch.ops.kernels import conv3
    from scgrhc_torch.ops.kernels import critic_fused as k2

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for cin, o, mode in CRITIC_LAYERS:
        x, w, b, dy = _train_inputs(torch, gen, cin, o, T, N_GP)
        u = torch.randn(x.shape, device="cuda", generator=gen)
        ins = [t.clone().requires_grad_() for t in (x, w, b, dy)]
        before = k2.critic_layer_bwd_dx_vjp.launches
        dxk = k2.fused_layer_bwd_dx(*ins, mode)
        got = torch.autograd.grad(dxk, ins, u, retain_graph=True, allow_unused=True)
        torch.cuda.synchronize()
        what = f"critic_layer_bwd_dx_vjp {mode} {cin}x{o}x{T} N={N_GP}"
        smoke.check(k2.critic_layer_bwd_dx_vjp.launches == before + 1,
                    f"{what}: {k2.critic_layer_bwd_dx_vjp.launches - before} vjp launches")
        mask = k2.critic_layer(x, w, b, mode) > 0
        ins64 = [t.double().requires_grad_() for t in (x, w, b, dy)]
        want = torch.autograd.grad(_dx_on_masks(torch, *ins64, mode, mask), ins64, u.double(),
                                   allow_unused=True)
        floor = 0.0
        if mode == "in_relu":
            x64, w64, b64, dy64 = (t.detach() for t in ins64)
            c64 = conv3.conv(x64, w64, b64)
            v64 = torch.nn.functional.conv1d(u.double(), w64, padding=1)
            d_c = k2.dx_vjp_row_plain(c64, k2.row_stats_plain(c64), dy64, v64, mode)[1]
            floor = float(d_c.abs().sum(dim=(0, 2)).norm())
            del x64, w64, b64, dy64, c64, v64, d_c
        rels = {}
        for name, g, r in zip(("x", "w", "b", "dy"), got, want):
            smoke.check((g is None) == (r is None), f"{what}: d{name} None {g is None}, "
                                                    f"float64 None {r is None}")
            if g is not None and r is not None:
                rels[name] = _rel(g, r, floor if name == "b" else 0.0)
        rel = max(rels.values())
        smoke.check(rel <= TOL_TRAIN["bwd"], f"{what}: relative errors {rels}")
        del ins64, want
        conv_flops = 6.0 * N_GP * cin * o * T
        nct, nott, wts = N_GP * cin * T, N_GP * o * T, 3 * cin * o
        products = 4 if mode == "in_relu" else 2
        elems = {"linear": nct + 2 * nott, "relu": nct + 3 * nott,
                 "in_relu": 3 * nct + 4 * nott}[mode] + 2 * wts
        flop_ms = products * conv_flops / PEAK_TF32X3_FLOPS * 1e3
        byte_ms = 4.0 * elems / PEAK_BYTES * 1e3
        ms = _time_ms(torch, lambda: torch.autograd.grad(dxk, ins, u, retain_graph=True,
                                                         allow_unused=True), reps=10)
        rec = {"mode": mode, "n": N_GP, "rel_err": rel, "rel_errs": rels, "ms": ms,
               "flop_bound_ms": flop_ms, "byte_bound_ms": byte_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
        out[f"{cin}x{o}x{T} {mode}"] = rec
        print(f"{what}: one BwdDx backward {ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {products} products at 495/3 TFLOP/s {flop_ms:.4f} ms, "
              f"{4.0 * elems / 1e6:.1f} MB at 3.35 TB/s {byte_ms:.4f} ms), relative errors "
              f"against float64 on the kernels' masks {rels} (tol {TOL_TRAIN['bwd']:g})",
              flush=True)
        del x, w, b, dy, u, ins, dxk, got, mask
    total = {k: sum(r[k] for r in out.values()) for k in ("ms", "bound_ms")}
    print(f"critic_layer_bwd_dx_vjp: the 5 layers at N={N_GP} {total['ms']:.4f} ms against "
          f"{total['bound_ms']:.4f} ms bound", flush=True)
    return {**total, "rel_err": max(r["rel_err"] for r in out.values()), "per_shape": out}


# ---- training end to end ----------------------------------------------------

TRAIN_KERNELS = ("conv_in_relu", "conv_in_relu_bwd", "critic_layer", "critic_layer_bwd_dx",
                 "critic_layer_bwd_dwdb", "critic_layer_bwd_dx_vjp")


def write_train_data(root: str, duration_s: float = 600.0, t: int = T) -> tuple[str, int]:
    """The windows of t steps of a synthetic record (400 for 600 s at
    T = 750), min-max normalized per window, as a native loader file;
    returns its path and the window count."""
    from scgrhc_torch.data.loaders import SegmentLoader
    from scgrhc_torch.data.store import SegmentStore
    from scgrhc_torch.io.wfdb import rdrecord
    from scgrhc_torch.utils.synth import make_synthetic_database

    db = make_synthetic_database(os.path.join(root, "train_db"), n_records=1,
                                 duration_s=duration_s, seed=0, flatline_in_first=False)
    rec = rdrecord(os.path.join(db, "SYN000"))
    sig = np.asarray(rec.p_signal, np.float64)
    n = sig.shape[0] // t
    cols = [list(rec.sig_name).index(c) for c in CHANNELS]
    rhc_col = list(rec.sig_name).index("RHC_pressure")
    scg = sig[: n * t, cols].reshape(n, t, len(CHANNELS))
    rhc = sig[: n * t, [rhc_col]].reshape(n, t, 1)
    store = SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(n) * t)
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
    from scgrhc_torch.ops.kernels import conv3
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    loader, n_windows = write_train_data(root)
    fns = {k: fn for k, fn in _kernel_counters().items() if k in TRAIN_KERNELS}
    copies0 = {}  # conv3.dw_copy_launches() as the last drive began

    def drive(params):
        for fn in fns.values():
            fn.launches = 0
        for path in conv3.path_launches:
            conv3.path_launches[path] = 0
        for path in conv3.dw_path_launches:
            conv3.dw_path_launches[path] = 0
        copies0.update(conv3.dw_copy_launches())
        t0 = time.perf_counter()
        stats = train_run.run(params, plot=False)
        torch.cuda.synchronize()
        return stats, time.perf_counter() - t0, {k: fn.launches for k, fn in fns.items()}

    report = {}

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
    # every f32 conv of the step from 16 output channels on the warpgroup-MMA
    # core, the score layer's on the streams, none on mma.sync
    paths = dict(conv3.path_launches)
    smoke.check(paths["mma"] == 0 and paths["wgmma"] > 0 and paths["stream"] > 0,
                f"f32 training's conv launches by path {paths}")
    print(f"train: conv launches by path (conv3.path_launches) {paths}, a step "
          + ", ".join(f"{k} {v / steps:g}" for k, v in paths.items()), flush=True)
    # every f32 dw from 16 output channels on the warpgroup MMA, the score
    # layer's (three per critic update) on the stream, none on mma.sync
    dw_paths = dict(conv3.dw_path_launches)
    want_dw = {"mma": 0, "stream": steps * 3 * N_CRITIC}
    smoke.check(dw_paths["wgmma"] > 0 and all(dw_paths[k] == v for k, v in want_dw.items()),
                f"f32 training's dw launches by path {dw_paths}, expected {want_dw} and wgmma")
    print(f"train: dw launches by path (conv3.dw_path_launches) {dw_paths}, a step "
          + ", ".join(f"{k} {v / steps:g}" for k, v in dw_paths.items()), flush=True)
    # each of them copied its rows by tensor maps or, where the shape or the
    # alignment gives none, by cp.async; never by cp.async for want of a map
    # that fits (less than half the rate)
    copies = {k: v - copies0[k] for k, v in conv3.dw_copy_launches().items()}
    smoke.check(sum(copies.values()) == dw_paths["wgmma"] and copies["tma"] > 0
                and copies["cp.async, no map made"] == 0,
                f"f32 training's warpgroup-MMA dw launches by copy {copies}")
    print(f"train: warpgroup-MMA dw launches by copy (conv3.dw_copy_launches) {copies}, a step "
          + ", ".join(f"{k} {v / steps:g}" for k, v in copies.items()), flush=True)
    report.update(launches=launches, steps=steps, wall_s=wall, epochs=stats["epochs"],
                  path_launches=paths, dw_path_launches=dw_paths, dw_copy_launches=copies)
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


# ---- windows of 3 s ----------------------------------------------------------

T_LONG = 1500  # segment_size 3.0 at 500 Hz: past the 1024 steps the card once refused


def check_long_kernels(torch, smoke: Smoke) -> dict:
    """K1f and K1b at the generator's 14 layer shapes and K2f, K2dx and K2dw
    at the critic's 5 layers, N = 32, on windows of T_LONG steps, f32:
    K1f within TOL_F32 (max abs) and K2f within TOL_TRAIN of the plain
    versions, their relu masks within MASK_FLIP_SHARE of the plain
    versions'; the backward kernels within TOL_TRAIN (relative L2; an
    in_relu layer's db over |sum |dc||) of the plain backward in float64 on
    the forward kernel's masks, the kernels' own (on an H100 one flip moved
    K1b at 64 -> 64 by 1.04e-3 from the plain f32 version).  K1f's and
    K1b's times over the 14 layers.  K3 at (300, 4, T_LONG) against its
    plain version."""
    from scgrhc_torch.ops.kernels import critic_fused as k2
    from scgrhc_torch.ops.kernels.conv_block import (
        conv_in_relu,
        conv_in_relu_bwd,
        conv_in_relu_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(cin, o, t, i > 0)
              for i, (cin, o, t) in enumerate(_layer_shapes(len(CHANNELS), T_LONG))]
    out = {"k1f_max_abs_err": 0.0, "k1b_rel_err": 0.0, "k1f_ms": 0.0, "k1b_ms": 0.0,
           "mask_flips": 0, "critic_rel_err": {}}
    for cin, o, t, need_dx in dict.fromkeys(shapes):
        layers = shapes.count((cin, o, t, need_dx))
        x, w, b, dy = _train_inputs(torch, gen, cin, o, t)
        what = f"T={T_LONG} conv_in_relu {cin}x{o}x{t}"
        y, ref = conv_in_relu(x, w, b), conv_in_relu_plain(x, w, b)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        smoke.check(err <= TOL_F32, f"{what}: err {err} over {TOL_F32}")
        out["mask_flips"] += _mask_flips(smoke, what, y, ref)
        got = [g for g in conv_in_relu_bwd(x, w, b, dy, need_dx) if g is not None]
        want = ([_dx_on_masks(torch, x, w, b, dy, "in_relu", y > 0)] if need_dx else []) + \
            _dwdb_on_masks(torch, x, w, b, dy, "in_relu", y > 0)
        floors = (0.0, 0.0, _db_floor(x, w, b, dy))[-len(got):]
        rel, _ = _hold(smoke, f"{what} bwd dx={need_dx}", got, want, floors, TOL_TRAIN["bwd"])
        out["k1f_max_abs_err"] = max(out["k1f_max_abs_err"], err)
        out["k1b_rel_err"] = max(out["k1b_rel_err"], rel)
        out["k1f_ms"] += layers * _time_ms(torch, lambda: conv_in_relu(x, w, b))
        out["k1b_ms"] += layers * _time_ms(torch, lambda: conv_in_relu_bwd(x, w, b, dy, need_dx))
        del x, w, b, dy, y, ref, got, want
    for cin, o, mode in CRITIC_LAYERS:
        x, w, b, dy = _train_inputs(torch, gen, cin, o, T_LONG)
        what = f"T={T_LONG} critic {mode} {cin}x{o}"
        db_floor = _db_floor(x, w, b, dy) if mode == "in_relu" else 0.0
        y, ref = k2.critic_layer(x, w, b, mode), k2.critic_layer_plain(x, w, b, mode)
        if mode != "linear":
            out["mask_flips"] += _mask_flips(smoke, what, y, ref)
        rels = {
            "critic_layer": _hold(smoke, f"{what} K2f", [y], [ref], (0.0,), TOL_TRAIN["fwd"])[0],
            "critic_layer_bwd_dx": _hold(smoke, f"{what} K2dx",
                                         [k2.critic_layer_bwd_dx(x, w, b, dy, mode)],
                                         [_dx_on_masks(torch, x, w, b, dy, mode, y > 0)],
                                         (0.0,), TOL_TRAIN["bwd"])[0],
            "critic_layer_bwd_dwdb": _hold(smoke, f"{what} K2dw",
                                           list(k2.critic_layer_bwd_dwdb(x, w, b, dy, mode)),
                                           _dwdb_on_masks(torch, x, w, b, dy, mode, y > 0),
                                           (0.0, db_floor), TOL_TRAIN["bwd"])[0],
        }
        out["critic_rel_err"][f"{cin}x{o} {mode}"] = rels
        del x, w, b, dy, y, ref
    worst = {k: max(r[k] for r in out["critic_rel_err"].values())
             for k in ("critic_layer", "critic_layer_bwd_dx", "critic_layer_bwd_dwdb")}
    out["k3_max_abs_err"] = hold_gate_normalize(torch, smoke, 300, len(CHANNELS), T_LONG)
    print(f"T={T_LONG}, N={N_TRAIN}, f32: K1f max abs err {out['k1f_max_abs_err']:.3g} (tol "
          f"{TOL_F32:g}), K2f rel err {worst['critic_layer']:.3g} (tol {TOL_TRAIN['fwd']:g}) "
          f"against the plain versions, {out['mask_flips']} relu masks flipped; on the kernels' "
          f"masks in float64, K1b rel err {out['k1b_rel_err']:.3g}, K2dx "
          f"{worst['critic_layer_bwd_dx']:.3g}, K2dw {worst['critic_layer_bwd_dwdb']:.3g} (tol "
          f"{TOL_TRAIN['bwd']:g}); the 14 layers: K1f {out['k1f_ms']:.3f} ms, K1b "
          f"{out['k1b_ms']:.3f} ms", flush=True)
    return out


# The 600-s record at T = 1500 against float64: the card's waveform within
# ENVELOPE_FACTOR times the CPU's own f32 distance from float64.  On a
# record that long every f32 path leaves TOL_SERVE (set on 20 windows) in
# a few windows, where an instance norm over a near-flat channel amplifies
# f32 rounding: on an H100 (scgrhc_torch/bench/serve_envelope.py) the CPU's
# f32 forward of the 600-s record sat 5.9e-3 from float64 at T = 750 and
# 4.4e-3 at T = 1500, cuDNN's f32 path on the card 5.1e-3 and 4.1e-3, the
# kernels 5.0e-3 and 5.6e-3, all with a median per-window maximum near 1e-3.
ENVELOPE_FACTOR = 2.0


def serve_long(torch, smoke: Smoke, root: str, card: str) -> dict:
    """Serving at segment_size 3.0 (windows of T_LONG steps): a 600-s
    synthetic record (200 windows, one chunk) twice, the first request
    warming, and the 30-s record of the T = 750 phase (10 windows), with 14
    K1f launches a chunk.  The 30-s record against the CPU and float64
    within TOL_SERVE, as at T = 750; the 600-s record against float64
    within ENVELOPE_FACTOR times the CPU's own f32 distance from it."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.io.wfdb import rdrecord, wrrecord
    from scgrhc_torch.models.generator import Generator
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
    from scgrhc_torch.ops.kernels.dsp import normalize_windows
    from scgrhc_torch.pipeline import serve
    from scgrhc_torch.utils.synth import make_synthetic_database

    records = {"SYN000": 600.0, RECORDS[-1][0]: RECORDS[-1][1]}
    db = make_synthetic_database(os.path.join(root, "db"), n_records=1, duration_s=600.0,
                                 seed=3, flatline_in_first=False)
    short = make_synthetic_database(os.path.join(root, "short"), n_records=1,
                                    duration_s=RECORDS[-1][1], seed=len(RECORDS) - 1,
                                    flatline_in_first=False)
    rec = rdrecord(os.path.join(short, "SYN000"))
    wrrecord(os.path.join(db, RECORDS[-1][0]), rec.fs, rec.sig_name, rec.p_signal)
    paths.set_data_path(os.path.dirname(db))
    exp = os.path.join(root, "exp")
    os.makedirs(os.path.join(exp, "checkpoints"))
    params = Params(_write_params(exp, segment_size=T_LONG / 500))
    gen = Generator(len(CHANNELS), torch.Generator().manual_seed(1234))
    torch.save({"start_time": 0.0, "epoch": 1, "g_losses": [], "d_losses": [],
                "g_state_dict": gen.state_dict()},
               os.path.join(exp, "checkpoints", "001.checkpoint"))
    reqs = [json.dumps({"record": r, "save": False}) + "\n"
            for r in ("SYN000", "SYN000", RECORDS[-1][0])]
    out = io.StringIO()
    conv_in_relu.launches = 0
    normalize_windows.launches = 0
    serve.run(params, checkpoint="last", stream_batch=N_CHUNK, stdin=io.StringIO("".join(reqs)),
              stdout=out)
    launches = {"conv_in_relu": conv_in_relu.launches,
                "normalize_windows": normalize_windows.launches}
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    cpu_out = io.StringIO()
    t0 = time.perf_counter()
    serve.run(params, checkpoint="last", device="cpu", stdin=io.StringIO(reqs[0] + reqs[2]),
              stdout=cpu_out)
    cpu_s = time.perf_counter() - t0
    cpu = [json.loads(line) for line in cpu_out.getvalue().splitlines()]
    ok = len(resp) == 3 and len(cpu) == 2 and all("waveform" in r for r in resp + cpu)
    smoke.check(ok, f"T={T_LONG} serve: responses {[r.get('error') for r in resp + cpu]}")
    wins = {k: int(v * 500) // T_LONG for k, v in records.items()}
    chunks = {k: math.ceil(v / N_CHUNK) for k, v in wins.items()}
    want = 2 * chunks["SYN000"] + chunks[RECORDS[-1][0]]
    smoke.check(launches == {"conv_in_relu": 14 * want, "normalize_windows": want},
                f"T={T_LONG} serve: launches {launches} for {want} chunks")
    errs = {}
    if ok:
        smoke.check(resp[0]["waveform"] == resp[1]["waveform"],
                    f"T={T_LONG} serve: a repeated request gave other values")
        for name, card_r, cpu_r in (("SYN000", resp[1], cpu[0]), (RECORDS[-1][0], resp[2], cpu[1])):
            card_wave, cpu_wave = (np.asarray(r["waveform"], np.float32) for r in (card_r, cpu_r))
            ref = _f64_waveform(torch, params, name, T_LONG)
            smoke.check(card_wave.shape == cpu_wave.shape == ref.shape == (wins[name] * T_LONG,)
                        and bool(np.isfinite(card_wave).all()),
                        f"T={T_LONG} serve {name}: waveform {card_wave.shape}, finite "
                        f"{bool(np.isfinite(card_wave).all())}")
            if card_wave.shape == cpu_wave.shape == ref.shape:
                errs[name] = {k: float(np.abs(a - r).max()) for k, (a, r) in {
                    "cuda_vs_cpu": (card_wave, cpu_wave), "cuda_vs_f64": (card_wave, ref),
                    "cpu_vs_f64": (cpu_wave, ref)}.items()}
    short_errs = errs.get(RECORDS[-1][0], {"missing": math.inf})
    for k, v in short_errs.items():
        smoke.check(v <= TOL_SERVE, f"T={T_LONG} serve {RECORDS[-1][0]}: {k} max abs err {v}")
    long_errs = errs.get("SYN000", {"cuda_vs_f64": math.inf, "cpu_vs_f64": 0.0})
    smoke.check(long_errs["cuda_vs_f64"] <= ENVELOPE_FACTOR * long_errs["cpu_vs_f64"],
                f"T={T_LONG} serve SYN000: cuda vs f64 {long_errs['cuda_vs_f64']}, over "
                f"{ENVELOPE_FACTOR} x the cpu's f32 {long_errs['cpu_vs_f64']}")
    ms = resp[1].get("ms", math.nan) if ok else math.nan

    def fmt(e):
        return ", ".join(f"{k.replace('_vs_', ' vs ')} {v:.3g}" for k, v in e.items())

    print(f"serve at T={T_LONG} (segment_size {T_LONG / 500:g}), 600-s record: "
          f"{wins['SYN000']} windows, {chunks['SYN000']} chunk, {ms} ms "
          f"({wins['SYN000'] / (ms / 1e3):.1f} windows/s); launches K1f {launches['conv_in_relu']}"
          f" K4 {launches['normalize_windows']} for {want} chunks; max abs err {fmt(long_errs)} "
          f"(cuda vs f64 within {ENVELOPE_FACTOR:g} x cpu vs f64); {RECORDS[-1][0]} "
          f"({wins[RECORDS[-1][0]]} windows): {fmt(short_errs)} (tol {TOL_SERVE:g}); cpu "
          f"requests {cpu_s:.1f} s, on {card}", flush=True)
    return {"windows": wins["SYN000"], "chunks": chunks["SYN000"], "ms": ms,
            "launches": launches, "max_abs_err": errs, "cpu_s": cpu_s}


def _f64_waveform(torch, params, name: str, t: int):
    """The checkpoint's float64 forward on the CPU over the record's windows
    of t steps, as serving frames and normalizes them (no overlap)."""
    from scgrhc_torch.io.catalog import read_record_digital
    from scgrhc_torch.ops.kernels.dsp import normalize_windows_plain
    from scgrhc_torch.parallel.stream import calibrate, frame_record
    from scgrhc_torch.pipeline.predict import load_generator_params

    adc, gain, base, sentinel = read_record_digital(name, params.in_channels)
    phys = calibrate(torch.from_numpy(np.ascontiguousarray(adc.T)),
                     *(torch.from_numpy(v) for v in (gain, base, sentinel)))
    w = normalize_windows_plain(frame_record(phys, t).contiguous())
    gen64 = load_generator_params(params, "001.checkpoint", "cpu").double()
    with torch.inference_mode():
        return gen64(w.double())[:, 0].reshape(-1).numpy()


def train_long(torch, smoke: Smoke, root: str, card: str) -> dict:
    """Two epochs of WGAN-GP at B = 32 on the 200 windows of T_LONG steps of
    a 600-s record (7 steps an epoch): the launches per step as at T = 750,
    finite losses; ms per step from the second epoch."""
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    loader, n_windows = write_train_data(root, t=T_LONG)
    fns = {k: fn for k, fn in _kernel_counters().items() if k in TRAIN_KERNELS}
    params = _train_exp(root, "long", loader, total_epochs=2, train_mode="epoch",
                        segment_size=T_LONG / 500)
    for fn in fns.values():
        fn.launches = 0
    stats = train_run.run(params, plot=False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in fns.items()}
    n_batches = math.ceil(n_windows / N_TRAIN)
    steps = sum(e["steps"] for e in stats["epochs"])
    smoke.check(steps == 2 * n_batches, f"T={T_LONG} train: {steps} steps")
    want = {k: v * steps for k, v in launches_per_step(TrainConfig.from_params(params)).items()}
    smoke.check(launches == want, f"T={T_LONG} train: launches {launches}, expected {want}")
    ck = _ckpt(params, 1)
    smoke.check(bool(np.isfinite(ck["g_losses"] + ck["d_losses"]).all()),
                f"T={T_LONG} train: non-finite losses")
    ms_step = stats["epochs"][-1]["seconds"] / n_batches * 1e3
    print(f"train at T={T_LONG}: {steps} steps at B={N_TRAIN}, epoch 1 {ms_step:.1f} ms per step "
          f"({n_windows / stats['epochs'][-1]['seconds']:.1f} windows/s); launches per step "
          + ", ".join(f"{k} {v // steps}" for k, v in launches.items()) + f" on {card}",
          flush=True)
    return {"steps": steps, "launches": launches, "ms_per_step": ms_step,
            "g_losses": ck["g_losses"]}


# ---- the experiment pipeline ------------------------------------------------

ALL_KERNELS = {"conv_in_relu": "conv_block", "conv_in_relu_bwd": "conv_block",
               "conv_in_relu_part": "conv_block", "conv_in_relu_apply": "conv_block",
               "critic_layer": "critic_fused", "critic_layer_bwd_dx": "critic_fused",
               "critic_layer_bwd_dwdb": "critic_fused",
               "critic_layer_bwd_dx_vjp": "critic_fused", "gate_and_normalize": "dsp",
               "normalize_windows": "dsp"}
N_EVAL = 1024  # eval_batch

# ``python -m scgrhc_torch <dir>`` as ``-m`` runs it (runpy, run_name
# __main__) in a new process, with the kernel launch counts set to 0 just
# before and printed as the last line just after.
_PIPELINE_PROC = r"""
import importlib, json, runpy, sys
kernels = json.loads(sys.argv[2])
fns = {k: getattr(importlib.import_module("scgrhc_torch.ops.kernels." + m), k)
       for k, m in kernels.items()}
for fn in fns.values():
    fn.launches = 0
sys.argv = ["scgrhc_torch", sys.argv[1]]
try:
    runpy.run_module("scgrhc_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code not in (0, None):
        raise
print(json.dumps({k: fn.launches for k, fn in fns.items()}))
"""


def _kernel_counters() -> dict:
    import importlib

    return {k: getattr(importlib.import_module(f"scgrhc_torch.ops.kernels.{m}"), k)
            for k, m in ALL_KERNELS.items()}


def _loader_files(params) -> dict:
    import pickle

    out = {}
    for path in (params.train_path, params.valid_path, params.test_path):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = pickle.load(f)
    return out


def _same_loaders(a: dict, b: dict) -> bool:
    """Two sets of loader files equal array for array."""
    head = ("format", "batch_size", "shuffle", "seed")
    for name, x in a.items():
        y = b[name]
        if [x[k] for k in head] != [y[k] for k in head] or x["store"].keys() != y["store"].keys():
            return False
        for k, v in x["store"].items():
            w = y["store"][k]
            if isinstance(v, np.ndarray):
                if v.dtype != w.dtype or v.shape != w.shape or not np.array_equal(v, w):
                    return False
            elif v != w:
                return False
    return True


def _read_csv(path: str) -> list[dict]:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _metric_errs(rows: list[dict]) -> float:
    """The largest distance of a CSV metric column from its float64
    recomputation from the row's own real_rhc/pred_rhc, relative to
    max(1, |value|); NaN must sit where the recomputation has NaN."""
    from scgrhc_torch.eval.metrics import global_scores
    from scgrhc_torch.select.run import get_float_array

    worst = 0.0
    for row in rows:
        ref = global_scores(get_float_array(row["real_rhc"]), get_float_array(row["pred_rhc"]))
        for k, v in ref.items():
            got = float(row[k]) if row[k] else math.nan
            if math.isnan(v) or math.isnan(got):
                worst = max(worst, 0.0 if math.isnan(v) and math.isnan(got) else math.inf)
            else:
                worst = max(worst, abs(got - v) / max(1.0, abs(v)))
    return worst


def device_interval_split(torch, params, card: str, reps: int = 5) -> dict:
    """One interval of the device backend (the first record's first chamber
    interval), its time split as ``segment_interval_device`` spends it:
    framing on the host, the upload of both window arrays, K3 (the wrapper
    and a synchronize) and the download of ``keep``.  Host clock, median of
    ``reps`` runs after one warm-up; ms."""
    from scgrhc_torch.io.catalog import SAMPLE_FREQ, get_channels, get_record_names, read_record
    from scgrhc_torch.io.sidecar import get_chamber_intervals
    from scgrhc_torch.ops.kernels.dsp import frame_windows, gate_and_normalize

    name = get_record_names()[0]
    record = read_record(name)
    start, stop = get_chamber_intervals(name, params.chamber)[0]
    scg_signal = get_channels(record, params.in_channels, start, stop)
    rhc_signal = get_channels(record, ["RHC_pressure"], start, stop)[:, 0]
    t = int(params.segment_size * SAMPLE_FREQ)
    runs = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scg_w, rhc_w = frame_windows(scg_signal, rhc_signal, t)
        t1 = time.perf_counter()
        scg_d, rhc_d = torch.from_numpy(scg_w).to("cuda"), torch.from_numpy(rhc_w).to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        keep_d = gate_and_normalize(scg_d, rhc_d, params.min_RHC)[0]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        keep_d.cpu().numpy()
        t4 = time.perf_counter()
        runs.append([(b - a) * 1e3 for a, b in ((t0, t1), (t1, t2), (t2, t3), (t3, t4))])
    split = dict(zip(("frame_ms", "upload_ms", "k3_ms", "download_ms"),
                     np.median(np.array(runs[1:]), axis=0).tolist()))
    split.update(windows=int(scg_w.shape[0]), channels=int(scg_w.shape[1]), t=t)
    print(f"data stage, one device-backend interval ({split['windows']} windows x "
          f"{split['channels']} x {t}): host framing {split['frame_ms']:.4f} ms, upload "
          f"{split['upload_ms']:.4f} ms, K3 {split['k3_ms']:.4f} ms (wrapper and synchronize), "
          f"keep download {split['download_ms']:.4f} ms (host clock, median of {reps}) on {card}",
          flush=True)
    return split


def pipeline_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    """The data stage on both backends in this process (timed, K3 counted),
    then the whole pipeline through ``python -m scgrhc_torch <dir>`` in a new
    process, its artifacts checked, then ``test <dir> train last`` here."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.data import run as data_run
    from scgrhc_torch.data.loaders import load_dataloader
    from scgrhc_torch.eval import infer
    from scgrhc_torch.eval import run as eval_run
    from scgrhc_torch.models.convert import generator_from_state_dict
    from scgrhc_torch.select.run import get_float_array
    from scgrhc_torch.train import checkpoint as ckpt_io
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step
    from scgrhc_torch.utils.synth import make_synthetic_database

    t0 = time.perf_counter()
    db = make_synthetic_database(os.path.join(root, "db"), n_records=PIPELINE_RECORDS,
                                 duration_s=PIPELINE_SECONDS, seed=0)
    db_s = time.perf_counter() - t0
    data_root = os.path.dirname(db)
    paths.set_data_path(data_root)
    fns = _kernel_counters()

    def exp(name, **extra):
        d = os.path.join(root, name)
        os.makedirs(d)
        return Params(_write_params(d, total_epochs=2, eval_stack=8, eval_batch=N_EVAL,
                                    seed=0, **extra))

    report = {"db_s": db_s, "data_root": data_root, "data_stage": {}}
    for backend in ("host", "device"):
        params = exp(f"data_{backend}", data_backend=backend)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        data_run.run(params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k3 = fns["gate_and_normalize"].launches
        report["data_stage"][backend] = {"s": secs, "k3_launches": k3}
        print(f"data stage, data_backend {backend}: {secs:.2f} s for {PIPELINE_RECORDS} records "
              f"x {PIPELINE_SECONDS:.0f} s, K3 launches {k3} on {card}", flush=True)
        smoke.check(k3 == (PIPELINE_RECORDS if backend == "device" else 0),
                    f"data stage {backend}: {k3} K3 launches")
    report["device_interval"] = device_interval_split(torch, params, card)
    host = _loader_files(Params(os.path.join(root, "data_host", "params.json")))
    smoke.check(_same_loaders(_loader_files(params), host),
                "data stage: device-gated loader files differ from the host-gated ones")

    # the main path: a new process, as a user runs it
    params = exp("pipeline", data_backend="device")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _PIPELINE_PROC, params.dir_path, json.dumps(ALL_KERNELS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=900, env=dict(os.environ, SCGRHC_DATA=data_root),
    )
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_pipeline.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if not smoke.check(proc.returncode == 0, f"python -m scgrhc_torch <dir>: rc "
                                             f"{proc.returncode}\n{proc.stderr[-3000:]}"):
        return report
    launches = json.loads(proc.stdout.strip().splitlines()[-1])
    report.update(wall_s=wall, launches=launches)

    # (a) the loader files, (b) K3 once per PA interval
    files = _loader_files(params)
    smoke.check(_same_loaders(files, host), "pipeline: loader files differ from the host run's")
    smoke.check(launches["gate_and_normalize"] == PIPELINE_RECORDS,
                f"pipeline: {launches['gate_and_normalize']} K3 launches")
    # (c) every artifact of the reference contract, parsed
    stores = {k: load_dataloader(getattr(params, f"{k}_path")).dataset
              for k in ("train", "valid", "test")}
    log = open(os.path.join(params.dir_path, "record_log.txt")).read().splitlines()
    counts = {k: len(v) for k, v in stores.items()}
    smoke.check(log[1:] == [f"All segments: {sum(counts.values())}",
                            f"Valid segments: {counts['valid']}",
                            f"Train segments: {counts['train']}",
                            f"Test segments: {counts['test']}"], f"record_log.txt {log}")
    ckpts = ckpt_io.list_checkpoints(params.checkpoint_dir_path)
    smoke.check(ckpts == ["000.checkpoint", "001.checkpoint"], f"checkpoints {ckpts}")
    best = open(os.path.join(params.dir_path, "checkpoint_best.txt")).read()
    best_name = best.splitlines()[0].split()[1]
    scores = _read_csv(os.path.join(params.dir_path, "checkpoint_scores.csv"))
    smoke.check([r["checkpoint"] for r in scores] == ckpts, "checkpoint_scores.csv")
    top = max(scores, key=lambda r: float(r["pcc_r"]))
    smoke.check(top["checkpoint"] == best_name, f"checkpoint_best.txt names {best_name}")
    csvs = {f"valid/{c.split('.')[0]}.csv": counts["valid"] for c in ckpts}
    csvs[f"test/{best_name.split('.')[0]}.csv"] = counts["test"]
    worst, rows = 0.0, {}
    for rel, n in csvs.items():
        path = os.path.join(params.comparison_dir_path, rel)
        if not smoke.check(os.path.exists(path), f"missing comparisons/{rel}"):
            continue
        rows[rel] = _read_csv(path)
        smoke.check(len(rows[rel]) == n and list(rows[rel][0]) == eval_run.CSV_COLUMNS,
                    f"comparisons/{rel}: {len(rows[rel])} rows, expected {n}")
        # (d) the metric columns against float64
        worst = max(worst, _metric_errs(rows[rel]))
    smoke.check(worst <= TOL_METRIC, f"comparison metrics against float64: {worst}")
    # (e) a few test windows' predictions against the checkpoint on the CPU
    test_rows = {(r["filename"], int(r["start_idx"])): r
                 for r in rows.get(f"test/{best_name.split('.')[0]}.csv", [])}
    store, k = stores["test"], min(4, counts["test"])
    gen = generator_from_state_dict(ckpt_io.load(os.path.join(
        params.checkpoint_dir_path, best_name))["g_state_dict"]).eval()
    with torch.inference_mode():
        cpu = gen(torch.from_numpy(store.scg[:k]))[:, 0].double().numpy()
    mm = store.minmax_rhc[:k].astype(np.float32).astype(np.float64)
    try:
        card_pred = np.stack([get_float_array(test_rows[(store.record_names[i],
                                                         int(store.start_idx[i]))]["pred_rhc"])
                              for i in range(k)])
        pred_err = float(np.abs((card_pred - mm[:, :1]) / (mm[:, 1:] - mm[:, :1]) - cpu).max())
    except KeyError:
        pred_err = math.inf
    smoke.check(pred_err <= TOL_SERVE, f"pipeline test predictions against the CPU: {pred_err}")
    # the launches of the whole run: two epochs of training steps, then one
    # generator forward per chunk and checkpoint (valid all, test best)
    steps = 2 * math.ceil(counts["train"] / N_TRAIN)
    per_step = launches_per_step(TrainConfig.from_params(params))
    eval_chunks = 2 * math.ceil(counts["valid"] / N_EVAL) + math.ceil(counts["test"] / N_EVAL)
    want = {k: per_step.get(k, 0) * steps for k in ALL_KERNELS}
    want["conv_in_relu"] += 14 * eval_chunks
    want["gate_and_normalize"] = PIPELINE_RECORDS
    smoke.check(launches == want, f"pipeline launches {launches}, expected {want}")
    print(f"pipeline: python -m scgrhc_torch <dir> in {wall:.1f} s (process start included): "
          f"{counts} windows, {steps} training steps, best {best_name}; metric columns against "
          f"float64 {worst:.3g} (tol {TOL_METRIC:g}); test predictions against the CPU "
          f"{pred_err:.3g} (tol {TOL_SERVE:g}); launches {launches} on {card}", flush=True)
    report.update(windows=counts, steps=steps, best=best_name, metric_err=worst,
                  pred_vs_cpu_err=pred_err)

    # test <dir> train last, in this process
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eval_run.run(params, "train", "last")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in fns.items()}
    chunks = math.ceil(counts["train"] / N_EVAL)
    smoke.check(got == {k: 14 * chunks if k == "conv_in_relu" else 0 for k in ALL_KERNELS},
                f"test train last: launches {got} for {chunks} chunks")
    # its device part alone: the split's forward, denormalization and scores
    gen = generator_from_state_dict(ckpt_io.load(os.path.join(
        params.checkpoint_dir_path, ckpts[-1]))["g_state_dict"], "cuda").eval()
    infer.predict_split(gen, stores["train"], batch=N_EVAL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer.predict_split(gen, stores["train"], batch=N_EVAL)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    rate, device_rate = counts["train"] / stage_s, counts["train"] / predict_s
    print(f"test train last: {counts['train']} windows in {chunks} chunks, {stage_s:.2f} s "
          f"({rate:.1f} windows/s, checkpoint load and CSV write included); the scoring alone "
          f"{predict_s * 1e3:.1f} ms ({device_rate:.1f} windows/s); K1f launches "
          f"{got['conv_in_relu']} on {card}", flush=True)
    report.update(eval_train={"windows": counts["train"], "chunks": chunks, "s": stage_s,
                              "windows_per_s": rate, "predict_s": predict_s,
                              "predict_windows_per_s": device_rate, "launches": got})
    return report


# ---- a traced training epoch --------------------------------------------------

# The port's kernels as CUPTI names them (csrc/*.cu, conv3.cuh).
PORT_KERNEL = re.compile(r"\b(?:conv_mma|conv_stream|dx_stream|dw_mma|dw_stream|dw_reduce|db|"
                         r"dc_linear|row|row_part|row_sum|row_apply|conv_weight_split|"
                         r"dx_vjp_row|gate_normalize|normalize_windows)_kernel\b")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The device time of a step by who launched it: the port's kernels, cuDNN's
# convolutions (the plain ops left on the path: the attention 1x1 convs,
# up*, final), PyTorch's own elementwise and reduction
# kernels (instance norms, Adam, the losses), and copies and fills.
OP_CLASSES = (("port kernels", PORT_KERNEL),
              ("cuDNN convolutions", re.compile(r"cudnn|xmma|implicit_gemm|cutlass|gemm")),
              ("PyTorch elementwise and reductions", re.compile(r"at::native|at::cuda")),
              ("copies and fills", re.compile(r"^Memcpy|^Memset")))


def _busy_us(events, lo: float, hi: float) -> float:
    """The union of the events' [ts, ts + dur) inside [lo, hi), in µs."""
    busy, end = 0.0, lo
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


OUTSIDE = "no backward node (forwards, losses, Adam)"


def _launching_nodes(events) -> dict:
    """correlation id → the autograd node whose backward launched the kernel:
    the outermost ``evaluate_function: <node>`` around the launch on its
    thread, with the innermost after a "/" where a backward ran inside it
    (bf16's ``_plain_vjp``, ``autograd.grad`` inside ``BwdDxBackward``), or
    ``OUTSIDE`` where none ran.  In f32 BwdDx's backward, the GP's second
    order, launches its kernels itself, so its gaps read ``BwdDxBackward``."""
    spans: dict = {}
    for e in events:
        if e["name"].startswith("autograd::engine::evaluate_function: "):
            spans.setdefault(e["tid"], []).append(e)
    starts, parent = {}, {}
    for tid, v in spans.items():
        v.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in v]
        stack: list[int] = []
        for i, e in enumerate(v):  # nested spans: the parent is the open one
            while stack and v[stack[-1]]["ts"] + v[stack[-1]]["dur"] < e["ts"]:
                stack.pop()
            parent[tid, i] = stack[-1] if stack else None
            stack.append(i)
    out = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") != "cuda_runtime" or corr is None or e["tid"] not in spans:
            if corr is not None and e.get("cat") == "cuda_runtime":
                out[corr] = OUTSIDE
            continue
        v, i = spans[e["tid"]], bisect.bisect_right(starts[e["tid"]], e["ts"]) - 1
        while i is not None and i >= 0 and v[i]["ts"] + v[i]["dur"] < e["ts"]:
            i = parent[e["tid"], i]
        chain = []
        while i is not None and i >= 0:
            chain.append(v[i]["name"].split(": ", 1)[1])
            i = parent[e["tid"], i]
        out[corr] = (OUTSIDE if not chain else chain[-1] if len(chain) == 1
                     else f"{chain[-1]}/{chain[0]}")
    return out


def _short_name(name: str, width: int = 70) -> str:
    m = PORT_KERNEL.search(name)
    if m:  # a port kernel: its name and template arguments, no namespace
        return name[m.start():][:width]
    return name[:width]


def trace_training(torch, smoke: Smoke, root: str, card: str, loader: str,
                   untraced_ms: float) -> dict:
    """One epoch of the 600-s record (epoch mode, B = 32) through
    ``train.run.run`` with ``SCGRHC_PROFILE_DIR`` set: a Chrome trace must
    appear under ``train/`` with the ``train_epoch`` span and the port's
    kernels in it.  From the trace: the device's busy share inside the
    span, the ten device operations with the most time per step, and the
    time per step in none of the port's kernels.  ``untraced_ms``: the
    training phase's steady step with tracing off, to read the profiler's
    cost against."""
    from scgrhc_torch.core import trace as trace_mod
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    params = _train_exp(root, "traced", loader, total_epochs=1)
    fns = {k: fn for k, fn in _kernel_counters().items() if k in TRAIN_KERNELS}
    out = os.path.join(root, "profile")
    for fn in fns.values():
        fn.launches = 0
    os.environ[trace_mod.ENV_VAR] = out
    try:
        t0 = time.perf_counter()
        stats = train_run.run(params, plot=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ[trace_mod.ENV_VAR]
    n_steps = stats["epochs"][0]["steps"]
    launches = {k: fn.launches for k, fn in fns.items()}
    want = {k: v * n_steps for k, v in launches_per_step(TrainConfig.from_params(params)).items()}
    smoke.check(launches == want, f"traced epoch: launches {launches}, expected {want}")
    files = sorted(f for f in os.listdir(os.path.join(out, "train"))
                   if f != trace_mod.PHASES_FILE) if os.path.isdir(
        os.path.join(out, "train")) else []
    if not smoke.check(len(files) == 1 and files[0].endswith(".json"),
                       f"traced epoch: trace files under train/: {files}"):
        return {"files": files}
    path = os.path.join(out, "train", files[0])
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == "train_epoch"
             and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    for e in device:
        e["port"] = e["cat"] == "kernel" and bool(PORT_KERNEL.search(e["name"]))
    port = [e for e in device if e["port"]]
    smoke.check(len(spans) == 1, f"traced epoch: {len(spans)} train_epoch spans")
    smoke.check(bool(port), f"traced epoch: no kernel of the port among {len(device)} device "
                            f"events")
    if not spans or not port:
        return {"files": files, "device_events": len(device)}
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    inside = [e for e in device if lo <= e["ts"] < hi]
    per_op: dict[str, float] = {}
    per_class = dict.fromkeys([c for c, _ in OP_CLASSES] + ["other"], 0.0)
    per_node: dict[str, float] = {}  # the device ops outside the port's kernels
    launcher = _launching_nodes(events)
    for e in inside:
        key = _short_name(e["name"])
        per_op[key] = per_op.get(key, 0.0) + e["dur"]
        cls = next((c for c, pat in OP_CLASSES if pat.search(e["name"])), "other")
        per_class[cls] += e["dur"] / n_steps / 1e3
        if not e["port"]:
            node = launcher.get(e.get("args", {}).get("correlation"), "unknown")
            per_node[node] = per_node.get(node, 0.0) + e["dur"] / n_steps / 1e3
    step_ms = (hi - lo) / n_steps / 1e3
    busy_ms = _busy_us(inside, lo, hi) / n_steps / 1e3
    port_ms = sum(e["dur"] for e in inside if e["port"]) / n_steps / 1e3
    other_ms = sum(e["dur"] for e in inside if not e["port"]) / n_steps / 1e3
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    report = {
        "trace_bytes": os.path.getsize(path), "wall_s": wall, "steps": n_steps,
        "step_ms": step_ms, "device_busy_share": busy_ms / step_ms,
        "port_kernel_ms_per_step": port_ms, "other_device_ms_per_step": other_ms,
        "not_in_port_kernels_ms_per_step": step_ms - port_ms,
        "idle_ms_per_step": step_ms - busy_ms,
        "top10_ms_per_step": [[k, v / n_steps / 1e3] for k, v in top],
        "by_class_ms_per_step": per_class, "untraced_ms_per_step": untraced_ms,
        "not_port_by_node_ms_per_step": per_node,
        "launches": launches,
    }
    phases_path = os.path.join(out, "train", trace_mod.PHASES_FILE)
    if smoke.check(os.path.isfile(phases_path), "traced epoch: no phases.json beside the trace"):
        with open(phases_path) as f:
            phases = json.load(f)
        smoke.check(phases.get("train_step", {}).get("calls") == n_steps,
                    f"traced epoch: phases.json counts {phases.get('train_step')} train_step "
                    f"spans for {n_steps} steps")
        report["phase_ms_per_step"] = {k: v.get("device_ms", 0.0) / n_steps
                                       for k, v in phases.items()}
        print("trace: device ms per step by phase span: " + ", ".join(
            f"{k} {v:.2f}" for k, v in report["phase_ms_per_step"].items()), flush=True)
    print(f"trace: one epoch ({n_steps} steps, B={N_TRAIN}) traced in {wall:.1f} s, "
          f"{report['trace_bytes'] / 1e6:.1f} MB of trace; inside train_epoch "
          f"{step_ms:.2f} ms per step (profiler on), device busy {100 * busy_ms / step_ms:.1f} %, "
          f"port kernels {port_ms:.2f} ms, other device ops {other_ms:.2f} ms, idle "
          f"{step_ms - busy_ms:.2f} ms; not in a port kernel {step_ms - port_ms:.2f} ms per step; "
          f"top ten per step: " + "; ".join(f"{k} {v / n_steps / 1e3:.3f} ms" for k, v in top)
          + f" on {card}", flush=True)
    print("trace: device ms per step by class: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_class.items()) + f"; the same epoch untraced "
        f"{untraced_ms:.2f} ms per step (tracing adds {step_ms - untraced_ms:.2f} ms a step)",
        flush=True)
    print("trace: device ms per step outside the port's kernels, by the autograd node that "
          "launched them: " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(per_node.items(), key=lambda kv: -kv[1])[:10]),
          flush=True)
    return report


# ---- the reference's loader artifacts -------------------------------------------


def loader_artifacts(torch, smoke: Smoke, root: str, card: str) -> dict:
    """The pipeline experiment's data stage (``data_backend: "device"``) run
    again with ``loader_backend: "torch"``: its three pickled DataLoaders,
    read by the port's ``load_dataloader``, must equal the native files
    array for array, with the same names and (lo, hi); one epoch trained
    from each set of files must give the same losses."""
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.data import run as data_run
    from scgrhc_torch.data.loaders import load_dataloader
    from scgrhc_torch.train import run as train_run

    native = Params(os.path.join(root, "data_device", "params.json"))
    exp = os.path.join(root, "data_torch")
    os.makedirs(exp)
    params = Params(_write_params(exp, total_epochs=1, seed=0, data_backend="device",
                                  loader_backend="torch"))
    t0 = time.perf_counter()
    data_run.run(params)
    secs = time.perf_counter() - t0
    fields = ("scg", "rhc", "start_idx", "stop_idx", "minmax_scg", "minmax_rhc")
    counts = {}
    for split in ("train", "valid", "test"):
        path = getattr(params, f"{split}_path")
        with open(path, "rb") as f:
            raw = f.read()
        smoke.check(b"scgrhc" not in raw and b"torch.utils.data" in raw,
                    f"loader artifacts: {split} pickle names more than torch")
        a = load_dataloader(getattr(native, f"{split}_path"))
        b = load_dataloader(path)
        same = (a.batch_size == b.batch_size and a.dataset.record_names == b.dataset.record_names
                and all(getattr(a.dataset, k).dtype == getattr(b.dataset, k).dtype
                        and np.array_equal(getattr(a.dataset, k), getattr(b.dataset, k))
                        for k in fields))
        smoke.check(same, f"loader artifacts: the {split} pickle differs from the native file")
        counts[split] = len(b.dataset)
    losses = {}
    for name, src in (("native", native), ("torch", params)):
        run = _train_exp(root, f"train_from_{name}", src.train_path, total_epochs=1)
        train_run.run(run, plot=False)
        losses[name] = _ckpt(run, 0)
    same = (losses["native"]["g_losses"] == losses["torch"]["g_losses"]
            and losses["native"]["d_losses"] == losses["torch"]["d_losses"])
    smoke.check(same, "loader artifacts: one epoch from the torch pickles gave other losses")
    print(f"loader artifacts: data stage with loader_backend torch in {secs:.2f} s, {counts} "
          f"windows, equal to the native files; one epoch from each set: losses equal {same} "
          f"on {card}", flush=True)
    return {"data_stage_s": secs, "windows": counts, "losses_equal": same}


# ---- whole records, calibration and int8 ---------------------------------------

# The continuous mode runs K1f at N = 1 and T = L, the whole record: 900,000
# steps on the 1800-s record.
T_RECORD = int(RECORDS[1][1] * 500)
# An int8 window's output against the f32 path's, per window, at the
# conditions tests/test_quant.py asks it at: random weights and uniform
# inputs.  On SCG windows the JAX package's int8 forward itself falls
# below it (tests/test_torch_quant.py), so there the phase reads the PCC,
# and that of the card's int8 against the CPU's, without holding them.
MIN_INT8_PCC = 0.9


def _kernel_split(torch, fn) -> dict:
    """Device ms of one call of ``fn`` by kernel name (a torch.profiler
    trace of the CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "kernel"]
    finally:
        os.remove(path)
    out: dict[str, float] = {}
    for e in events:
        m = PORT_KERNEL.search(e["name"])
        key = m.group(0) if m else "other"
        out[key] = out.get(key, 0.0) + e["dur"] / 1e3
    return out


def check_whole_record_k1f(torch, smoke: Smoke) -> dict:
    """K1f at the continuous mode's 14 layer shapes on the 1800-s record
    (N = 1, T = 900,000), inputs uniform in [0, 1) like the normalized
    record: each layer's kernel and plain f32 version against the layer in
    float64 (the plain version on the card in f64); the kernel must stay
    within ENVELOPE_FACTOR times the plain f32 version's distance.  Times
    of the kernel and the plain version, the kernel's split between the
    conv core and the row pass, and its bounds: the convs' operations at
    the f32 FMA peak and at 3xTF32, the bytes of x, y and the f32
    scratch."""
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu, conv_in_relu_plain

    t = T_RECORD
    shapes = [(cin, o, t) for cin, o, _ in _layer_shapes(len(CHANNELS))]
    gen = torch.Generator(device="cuda").manual_seed(5)
    per_shape, split = {}, {}
    for cin, o, _ in dict.fromkeys(shapes):
        bound = 1.0 / math.sqrt(cin * 3)
        x = torch.rand(1, cin, t, device="cuda", generator=gen)
        w = (torch.rand(o, cin, 3, device="cuda", generator=gen) * 2 - 1) * bound
        b = (torch.rand(o, device="cuda", generator=gen) * 2 - 1) * bound
        y = conv_in_relu(x, w, b)
        plain = conv_in_relu_plain(x, w, b)
        ref = conv_in_relu_plain(x.double(), w.double(), b.double())
        errs = {"kernel_vs_f64": float((y - ref).abs().max()),
                "plain_vs_f64": float((plain - ref).abs().max()),
                "kernel_vs_plain": float((y - plain).abs().max())}
        del y, plain, ref
        ms = _time_ms(torch, lambda: conv_in_relu(x, w, b), reps=3, warmup=1)
        for _ in range(3):  # a profiler session now and then comes back empty
            traced = _kernel_split(torch, lambda: conv_in_relu(x, w, b))
            if sum(traced.values()) > ms / 2:
                break
        for k, v in traced.items():
            split[k] = split.get(k, 0.0) + v * shapes.count((cin, o, t))
        flops = 6.0 * cin * o * t
        nbytes = 4.0 * (cin * t + 2 * o * t)  # x, y and the f32 scratch
        rec = {**errs, "layers": shapes.count((cin, o, t)), "trace_ms": traced, "ms": ms,
               "plain_ms": _time_ms(torch, lambda: conv_in_relu_plain(x, w, b), reps=3,
                                    warmup=1),
               "flop_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
               "byte_bound_ms": nbytes / PEAK_BYTES * 1e3,
               "rate_bound_ms": max(flops / PEAK_TF32X3_FLOPS, nbytes / PEAK_BYTES) * 1e3}
        per_shape[f"{cin}x{o}x{t}"] = rec
        print(f"conv_in_relu N=1 C_in={cin} O={o} T={t}: max abs err kernel vs f64 "
              f"{errs['kernel_vs_f64']:.3g}, plain f32 vs f64 {errs['plain_vs_f64']:.3g}, "
              f"kernel vs plain {errs['kernel_vs_plain']:.3g}; kernel {rec['ms']:.3f} ms, plain "
              f"{rec['plain_ms']:.3f} ms", flush=True)
        del x, w, b
    total = {k: sum(r[k] * r["layers"] for r in per_shape.values())
             for k in ("ms", "plain_ms", "flop_bound_ms", "byte_bound_ms", "rate_bound_ms")}
    bound = max(total["flop_bound_ms"], total["byte_bound_ms"])
    print(f"conv_in_relu N=1 T={t}, the 14 layers of a continuous forward: kernel "
          f"{total['ms']:.2f} ms (by the trace: conv core {split.get('conv_mma_kernel', 0.0):.2f}, "
          f"row pass {split.get('row_part_kernel', 0.0):.2f} + "
          f"{split.get('row_sum_kernel', 0.0):.2f} + "
          f"{split.get('row_apply_kernel', 0.0):.2f} in pieces, "
          f"{split.get('row_kernel', 0.0):.2f} a warp a row, other "
          f"{split.get('other', 0.0):.2f}), plain {total['plain_ms']:.2f} ms, bound {bound:.3f} ms (f32 FMA), "
          f"{total['rate_bound_ms']:.3f} ms at 3xTF32 (bytes of x, y and the scratch)",
          flush=True)
    return {**total, "bound_ms": bound, "trace_ms": split,
            "bound_by": "operations" if total["flop_bound_ms"] >= total["byte_bound_ms"]
            else "bytes",
            "max_kernel_vs_f64": max(r["kernel_vs_f64"] for r in per_shape.values()),
            "per_shape": per_shape}


# Arrays that a later phase holds its own to (never written to the JSON):
# "continuous": (record, its float64 continuous forward, the CPU f32
# path's max-abs distance from it); "windowed": (record, predict --mesh's
# waveform at world size 1).
_REFS: dict = {}


def _f64_continuous(torch, params, name: str):
    """The checkpoint's continuous forward in float64 (the plain blocks, on
    the card: cuDNN and PyTorch's reductions in float64, a second of work
    where the CPU takes half a minute), from the record's float32 samples,
    normalized in float64."""
    from scgrhc_torch.models.cp import apply_continuous
    from scgrhc_torch.models.generator import plain_block
    from scgrhc_torch.pipeline.predict import load_generator_params, read_scg

    x = read_scg(params, name).T.astype(np.float32).astype(np.float64)
    x = (x - x.min()) / (x.max() - x.min() + 1e-4)
    gen64 = load_generator_params(params, "001.checkpoint", "cuda").double()
    with torch.inference_mode():
        y = apply_continuous(gen64, torch.from_numpy(x).cuda()[None], block=plain_block)
        return y[0, 0].cpu().numpy()


def continuous_end_to_end(torch, smoke: Smoke, exp: str, card: str) -> dict:
    """The serving phase's records through the daemon's continuous mode
    (``{"record": ..., "continuous": true}``), K1f counted from 0 and read
    per request (14 a record), the peak device memory per request; the
    600-s answer against the float64 forward within ENVELOPE_FACTOR times
    the CPU's own f32 distance from it; then
    ``python -m scgrhc_torch predict <dir> SYN000 last --continuous`` in a
    new process, its .npy equal to the daemon's answer and its sidecar in
    the continuous mode."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
    from scgrhc_torch.ops.kernels.dsp import normalize_windows
    from scgrhc_torch.pipeline import serve
    from scgrhc_torch.pipeline.predict import load_generator_params, predict_continuous, read_scg

    params = Params(os.path.join(exp, "params.json"))
    # the 600-s record twice: the first request warms the path (cuDNN, the
    # caching allocator), and the first answer is held to float64
    names = [RECORDS[0][0], RECORDS[0][0], RECORDS[1][0]]
    snaps, peaks = [], []

    def lines():
        for name in names:
            snaps.append(conv_in_relu.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            yield json.dumps({"record": name, "continuous": True}) + "\n"
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
        snaps.append(conv_in_relu.launches)

    out = io.StringIO()
    conv_in_relu.launches = 0
    normalize_windows.launches = 0
    serve.run(params, checkpoint="last", stdin=lines(), stdout=out)
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    smoke.check(normalize_windows.launches == 0,
                f"continuous: {normalize_windows.launches} K4 launches, expected 0")
    report = {"requests": []}
    waves = {}
    smoke.check(len(resp) == len(names), f"continuous: {len(resp)} responses for {len(names)}")
    for i, (name, r) in enumerate(zip(names, resp)):
        if not smoke.check("error" not in r and r.get("mode") == "continuous",
                           f"continuous {name}: {r}"):
            continue
        n = int(dict(RECORDS)[name] * 500)
        wave = np.load(r["path"])
        if name in waves:
            smoke.check(np.array_equal(wave, waves[name]),
                        f"continuous {name}: a repeated request gave other values")
        waves[name] = wave
        k1 = snaps[i + 1] - snaps[i]
        smoke.check(k1 == 14, f"continuous {name}: {k1} K1f launches, expected 14")
        smoke.check(r["n_samples"] == n == waves[name].shape[0]
                    and bool(np.isfinite(waves[name]).all()),
                    f"continuous {name}: {r['n_samples']} samples, expected {n}, finite "
                    f"{bool(np.isfinite(waves[name]).all())}")
        rec = {"record": name, "samples": n, "ms": r["ms"], "k1f": k1, "warm": i > 0,
               "peak_gb": peaks[i] / 1e9, "msamples_per_s": n / r["ms"] / 1e3}
        report["requests"].append(rec)
        print(f"continuous {name}{' (first request)' if i == 0 else ''}: {n} samples in one "
              f"pass, {r['ms']} ms "
              f"({rec['msamples_per_s']:.2f} Msamples/s), peak device memory "
              f"{rec['peak_gb']:.2f} GB, K1f launches {k1} on {card}", flush=True)
    name = names[0]
    if name in waves:
        t0 = time.perf_counter()
        cpu = predict_continuous(load_generator_params(params, "001.checkpoint", "cpu"),
                                 read_scg(params, name))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = _f64_continuous(torch, params, name)
        f64_s = time.perf_counter() - t0
        errs = {"cuda_vs_f64": float(np.abs(waves[name] - ref).max()),
                "cpu_vs_f64": float(np.abs(cpu - ref).max()),
                "cuda_vs_cpu": float(np.abs(waves[name] - cpu).max())}
        smoke.check(errs["cuda_vs_f64"] <= ENVELOPE_FACTOR * errs["cpu_vs_f64"],
                    f"continuous {name}: cuda vs f64 {errs['cuda_vs_f64']}, over "
                    f"{ENVELOPE_FACTOR} x the cpu's f32 {errs['cpu_vs_f64']}")
        print(f"continuous {name} against float64 (outputs within [{ref.min():.3g}, "
              f"{ref.max():.3g}]): max abs err " + ", ".join(
                  f"{k.replace('_vs_', ' vs ')} {v:.3g}" for k, v in errs.items())
              + f" (cuda vs f64 within {ENVELOPE_FACTOR:g} x cpu vs f64); cpu f32 {cpu_s:.1f} s, "
              f"f64 on the card {f64_s:.1f} s", flush=True)
        report.update(max_abs_err=errs, cpu_s=cpu_s, f64_s=f64_s)
        _REFS["continuous"] = (name, ref, errs["cpu_vs_f64"])
    # the CLI, in a new process
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "scgrhc_torch", "predict", exp, name, "last", "--continuous"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600, env=dict(os.environ, SCGRHC_DATA=paths.DATA_PATH),
    )
    cli_s = time.perf_counter() - t0
    if smoke.check(proc.returncode == 0, f"predict --continuous: rc {proc.returncode}\n"
                                         f"{proc.stderr[-3000:]}"):
        pred_dir = os.path.join(exp, "predictions")
        side = json.load(open(os.path.join(pred_dir, f"{name}.json")))
        npy = np.load(os.path.join(pred_dir, f"{name}.npy"))
        same = name in waves and np.array_equal(npy, waves[name])
        smoke.check(side["mode"] == "continuous" and side["n_samples"] == npy.shape[0]
                    and same, f"predict --continuous: sidecar {side}, equal to the daemon's "
                              f"answer {same}")
        print(f"predict {name} last --continuous in a new process: {cli_s:.1f} s (process "
              f"start and kernel load included), {npy.shape[0]} samples, equal to the "
              f"daemon's answer {same}, sidecar mode {side['mode']}", flush=True)
        report.update(cli_s=cli_s, cli_equal=same)
    return report


# ---- the record read: the C WFDB decoder against its NumPy decode -----------

READ_SECONDS = 4 * 3600.0  # a 4-h record at 500 Hz: 7,200,000 samples a channel
READ_FMTS = ("16", "212")  # the dataset's format, and the packed 12-bit one
READ_REPS = 3
READ_SENTINELS = 8  # sentinel samples put into each record's .dat


def _read_timed(fn, path) -> tuple[float, int, object]:
    """Median ms of READ_REPS calls, then one more call's peak bytes as
    ``tracemalloc`` sees them (NumPy reports its arrays to it), and that
    call's result."""
    times = []
    for _ in range(READ_REPS):
        t0 = time.perf_counter()
        fn(path)
        times.append((time.perf_counter() - t0) * 1e3)
    tracemalloc.start()
    try:
        out = fn(path)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return statistics.median(times), peak, out


def record_read(smoke: Smoke, root: str, card: str, exp: str, continuous: dict) -> dict:
    """The port's record read, ``io/wfdb.rdrecord`` (the C decoder of
    ``scgrhc_torch/native``), against the NumPy decode it replaced
    (``rdrecord_numpy``) on a 4-h 500-Hz record of the 5 synthetic
    channels, in formats 16 and 212 with sentinel samples: equal bit for
    bit with the NaNs in the same places, the median ms of READ_REPS reads
    and the peak bytes of each path.  Then the continuous phase's 1800-s
    request: its record read (``read_scg``, as ``serve._prepare`` calls
    it) on both paths against the request's ``ms``."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.io import wfdb
    from scgrhc_torch.io.catalog import get_channels
    from scgrhc_torch.pipeline.predict import read_scg
    from scgrhc_torch.utils.synth import ALL_CHANNELS

    os.makedirs(root)
    n = int(READ_SECONDS * 500)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    adc = rng.integers(-2000, 2000, size=(n, len(ALL_CHANNELS)), endpoint=True,
                       dtype=np.int32)
    at = rng.choice(adc.size, READ_SENTINELS, replace=False)
    report = {"samples": n, "channels": len(ALL_CHANNELS), "formats": {}}
    for fmt in READ_FMTS:
        path = os.path.join(root, f"REC{fmt}")
        wfdb.wrrecord(path, 500, ALL_CHANNELS, adc / 200.0, gain=200.0, fmt=fmt)
        flat = adc.reshape(-1).copy()
        flat[at] = wfdb.SENTINELS[fmt]
        wfdb._encode_stream(flat, fmt, path + ".dat")
        del flat
        dat_mb = os.path.getsize(path + ".dat") / 1e6
        c_ms, c_peak, got = _read_timed(wfdb.rdrecord, path)
        np_ms, np_peak, ref = _read_timed(wfdb.rdrecord_numpy, path)
        same = (got.p_signal.shape == (n, len(ALL_CHANNELS))
                and np.array_equal(got.p_signal.view(np.uint64), ref.p_signal.view(np.uint64)))
        nans = int(np.isnan(got.p_signal).sum())
        smoke.check(same and nans == READ_SENTINELS
                    and bool(np.isnan(got.p_signal.reshape(-1)[at]).all()),
                    f"record read, format {fmt}: C against NumPy equal bit for bit {same}, "
                    f"{nans} NaN for {READ_SENTINELS} sentinels")
        del got, ref
        rec = {"dat_mb": dat_mb, "c_ms": c_ms, "numpy_ms": np_ms, "c_peak_bytes": c_peak,
               "numpy_peak_bytes": np_peak, "speedup": np_ms / c_ms,
               "peak_ratio": np_peak / c_peak, "equal_bits": same}
        report["formats"][fmt] = rec
        print(f"record read, format {fmt}: {n} samples x {len(ALL_CHANNELS)} channels "
              f"({dat_mb:.1f} MB .dat), C {c_ms:.1f} ms, NumPy {np_ms:.1f} ms (median of "
              f"{READ_REPS}; {rec['speedup']:.2f}x), peak {c_peak / 1e6:.1f} MB against "
              f"{np_peak / 1e6:.1f} MB ({rec['peak_ratio']:.2f}x), equal bit for bit {same}, "
              f"on the host of {card}", flush=True)
    shutil.rmtree(root, ignore_errors=True)

    # the continuous phase's 1800-s request: its read against its ms
    name = RECORDS[1][0]
    req = next((r for r in continuous.get("requests", []) if r["record"] == name), None)
    if smoke.check(req is not None, f"record read: no continuous {name} request to hold to"):
        params = Params(os.path.join(exp, "params.json"))
        rec_path = os.path.join(paths.PROCESSED_DATA_PATH, name)
        c_ms = _read_timed(lambda _: read_scg(params, name), None)[0]
        np_ms = _read_timed(lambda p: get_channels(
            wfdb.rdrecord_numpy(p), params.in_channels, 0, int(RECORDS[1][1] * 500)),
            rec_path)[0]
        report["continuous"] = {"record": name, "request_ms": req["ms"], "read_ms": c_ms,
                                "numpy_read_ms": np_ms, "share": c_ms / req["ms"],
                                "numpy_share": np_ms / req["ms"]}
        print(f"record read in the continuous {name} request ({req['ms']} ms): read_scg "
              f"{c_ms:.1f} ms through C ({c_ms / req['ms']:.1%} of the request), "
              f"{np_ms:.1f} ms through NumPy ({np_ms / req['ms']:.1%})", flush=True)
    report["phase_s"] = time.perf_counter() - t0
    print(f"record read phase: {report['phase_s']:.1f} s", flush=True)
    return report


def calibrate_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    """On the pipeline phase's experiment (it has a train split): the daemon
    started with ``--calibrate`` answers a windowed request with
    ``"calibrated": true`` and a continuous one too, and a request that
    sets ``"calibrate": false`` with the normalized waveform; the
    calibrated waveform equals the normalized one × (hi − lo) + lo within
    f32 rounding, with (lo, hi) a float64 reduction of the train loader's
    stored RHC (min, max).  K1f and K4 counted from 0 over the three
    requests."""
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.data.loaders import load_dataloader
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
    from scgrhc_torch.ops.kernels.dsp import normalize_windows
    from scgrhc_torch.pipeline import serve
    from scgrhc_torch.pipeline.predict import cohort_rhc_minmax

    params = Params(os.path.join(root, "pipeline", "params.json"))
    mm = load_dataloader(params.train_path).dataset.minmax_rhc.astype(np.float64)
    lo, hi = float(mm[:, 0].min()), float(mm[:, 1].max())
    smoke.check(cohort_rhc_minmax(params) == (lo, hi),
                f"calibrate: cohort_rhc_minmax {cohort_rhc_minmax(params)}, float64 {(lo, hi)}")
    name = "SYN001"
    reqs = [{"record": name, "save": False}, {"record": name, "save": False, "calibrate": False},
            {"record": name, "save": False, "continuous": True}]
    out = io.StringIO()
    conv_in_relu.launches = 0
    normalize_windows.launches = 0
    serve.run(params, checkpoint="last", calibrate=True, stream_batch=N_CHUNK,
              stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)), stdout=out)
    launches = (conv_in_relu.launches, normalize_windows.launches)
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    if not smoke.check(len(resp) == 3 and all("waveform" in r for r in resp),
                       f"calibrate: responses {[r.get('error') for r in resp]}"):
        return {}
    chunks = math.ceil(int(PIPELINE_SECONDS * 500) // T / N_CHUNK)
    smoke.check(launches == (14 * (2 * chunks + 1), 2 * chunks),
                f"calibrate: launches K1f, K4 {launches} for 2 x {chunks} chunks and a record")
    smoke.check([r["calibrated"] for r in resp] == [True, False, True]
                and [r["mode"] for r in resp] == ["windowed", "windowed", "continuous"],
                f"calibrate: flags {[(r['calibrated'], r['mode']) for r in resp]}")
    cal, raw = (np.asarray(r["waveform"], np.float32) for r in resp[:2])
    want = raw.astype(np.float64) * (hi - lo) + lo
    # f32 rounding of the device's (hi - lo), product and sum: a few ulps
    slack = 1e-6 * (np.abs(raw) * abs(hi - lo) + abs(lo))
    err = float(np.abs(cal - want).max())
    smoke.check(cal.shape == raw.shape and bool((np.abs(cal - want) <= slack).all()),
                f"calibrate: calibrated waveform off the normalized one x (hi - lo) + lo by "
                f"{err}")
    print(f"calibrate: serve --calibrate on the pipeline experiment, record {name}: (lo, hi) "
          f"= ({lo}, {hi}) mmHg from {len(mm)} train windows, equal to float64; calibrated "
          f"request {resp[0]['ms']} ms, uncalibrated {resp[1]['ms']} ms, calibrated continuous "
          f"{resp[2]['ms']} ms; max abs err against raw x (hi - lo) + lo {err:.3g}; launches "
          f"K1f {launches[0]} K4 {launches[1]} on {card}", flush=True)
    return {"lo": lo, "hi": hi, "ms": [r["ms"] for r in resp], "max_abs_err": err,
            "launches": {"conv_in_relu": launches[0], "normalize_windows": launches[1]}}


def _int8_conv_inputs(q):
    """(name, module, C_in, T_in) of the 17 quantized convs at the windowed
    path's lengths (T = 750)."""
    from scgrhc_torch.models.generator import BLOCKS

    out = []
    for (name, _, _), (cin, _, t) in zip(BLOCKS, _layer_shapes(len(CHANNELS))[::2]):
        convs = getattr(q, name)
        out += [(f"{name}.0", convs[0], cin, t), (f"{name}.3", convs[1], convs[0].wq.shape[0], t)]
    for name, t in (("up3", T - 6), ("up2", T - 4), ("up1", T - 2)):
        up = getattr(q, name)
        out.append((name, up, up.wq.shape[1], t))
    return out


def check_int8_products(torch, smoke: Smoke, card: str) -> dict:
    """Each of the 17 quantized convs' int8 product on the card at N = 512
    equal in int32 to the same product on the CPU, from the same int8
    inputs, and timed (``models.quant.int8_conv``: ``torch._int_mm`` over an
    im2col of the three taps); then the int8 forward at N = 512 on uniform
    windows with random weights, each window correlated with the f32
    forward above MIN_INT8_PCC."""
    from scgrhc_torch.models.generator import Generator
    from scgrhc_torch.models.quant import int8_conv

    q = Generator(len(CHANNELS), torch.Generator().manual_seed(1234)).cuda().cast(torch.int8)
    rng = torch.Generator(device="cuda").manual_seed(7)
    report, equal, card_ms, cpu_s = {"convs": {}}, True, 0.0, 0.0
    for name, conv, cin, t in _int8_conv_inputs(q):
        xq = torch.randint(-127, 128, (N_CHUNK, cin, t), device="cuda", generator=rng,
                           dtype=torch.int8)
        y = int8_conv(xq, conv.wq, conv.padding)
        t0 = time.perf_counter()
        ref = int8_conv(xq.cpu(), conv.wq.cpu(), conv.padding)
        cpu_s += time.perf_counter() - t0
        same = y.dtype == ref.dtype == torch.int32 and torch.equal(y.cpu(), ref)
        ms = _time_ms(torch, lambda: int8_conv(xq, conv.wq, conv.padding), reps=3, warmup=1)
        card_ms += ms
        equal &= same
        report["convs"][name] = {"shape": [N_CHUNK, cin, t, conv.wq.shape[0]], "equal": same,
                                 "ms": ms}
        smoke.check(same, f"int8 {name} ({N_CHUNK}, {cin}, {t}) -> {conv.wq.shape[0]}: the "
                          f"card's int32 differs from the CPU's")
        del xq, y, ref
    print(f"int8: the 17 quantized convs' products at N={N_CHUNK} equal to the CPU's in int32: "
          f"{equal}; card {card_ms:.2f} ms for the 17 (torch._int_mm with its im2col), the CPU "
          f"{cpu_s:.1f} s on {card}", flush=True)
    # the whole int8 forward against f32 at tests/test_quant.py's conditions
    gen = Generator(len(CHANNELS), torch.Generator().manual_seed(1234)).cuda().eval()
    x = torch.rand(N_CHUNK, len(CHANNELS), T, device="cuda", generator=rng)
    with torch.inference_mode():
        yq, y = (g(x)[:, 0].double().cpu().numpy() for g in (q, gen))
    pcc = [float(np.corrcoef(a, b)[0, 1]) for a, b in zip(y, yq)]
    smoke.check(bool(np.isfinite(yq).all()) and min(pcc) > MIN_INT8_PCC,
                f"int8 forward at N={N_CHUNK}, uniform windows: least PCC against f32 "
                f"{min(pcc)}")
    print(f"int8: the generator's int8 forward at N={N_CHUNK} on uniform windows, random "
          f"weights: per-window PCC against f32 min {min(pcc):.4f} (> {MIN_INT8_PCC:g})",
          flush=True)
    report.update(all_equal=equal, card_ms=card_ms, cpu_s=cpu_s, uniform_pcc_min=min(pcc))
    return report


def int8_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    """``test <dir> valid last`` on the pipeline's experiment with ``"dtype":
    "int8"`` and in float32, each in a directory of its own: the same rows,
    finite scores, no K1f launch in int8; each window's int8 prediction
    read against the float32 one and against the same int8 scoring on the
    CPU; both stages and the train split's scoring alone timed."""
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.data.loaders import load_dataloader
    from scgrhc_torch.eval import infer
    from scgrhc_torch.eval import run as eval_run
    from scgrhc_torch.models.convert import generator_from_state_dict
    from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
    from scgrhc_torch.select.run import get_float_array
    from scgrhc_torch.train import checkpoint as ckpt_io

    report = {}
    src = Params(os.path.join(root, "pipeline", "params.json"))
    stages, preds = {}, {}
    for dtype in ("float32", "int8"):
        d = os.path.join(root, f"eval_{dtype}")
        os.makedirs(d)
        for f in ("checkpoints", os.path.basename(src.train_path),
                  os.path.basename(src.valid_path), os.path.basename(src.test_path)):
            os.symlink(os.path.join(src.dir_path, f), os.path.join(d, f))
        params = Params(_write_params(d, total_epochs=2, eval_batch=N_EVAL, seed=0, dtype=dtype))
        conv_in_relu.launches = 0
        t0 = time.perf_counter()
        eval_run.run(params, "valid", "last")
        torch.cuda.synchronize()
        stages[dtype] = {"s": time.perf_counter() - t0, "k1f": conv_in_relu.launches}
        ckpt = ckpt_io.get_last_checkpoint_path(params.checkpoint_dir_path)
        rows = _read_csv(os.path.join(params.comparison_dir_path, "valid",
                                      f"{ckpt.split('.')[0]}.csv"))
        preds[dtype] = {(r["filename"], r["start_idx"]): (get_float_array(r["pred_rhc"]),
                                                           float(r["pcc_r"])) for r in rows}
    chunks = math.ceil(len(load_dataloader(src.valid_path).dataset) / N_EVAL)
    smoke.check(stages["int8"]["k1f"] == 0 and stages["float32"]["k1f"] == 14 * chunks,
                f"int8 eval: K1f launches {stages} for {chunks} chunks")
    keys = sorted(preds["float32"])
    pcc = [float(np.corrcoef(preds["float32"][k][0], preds["int8"][k][0])[0, 1]) for k in keys]
    finite = all(np.isfinite(preds["int8"][k][0]).all() and np.isfinite(preds["int8"][k][1])
                 for k in keys)
    smoke.check(bool(keys) and sorted(preds["int8"]) == keys and finite,
                f"int8 eval: {len(keys)} windows (float32 {len(preds['float32'])}), finite "
                f"{finite}")
    # the same checkpoint's int8 scoring of the valid split on the CPU
    sd = ckpt_io.load(os.path.join(src.checkpoint_dir_path, ckpt))["g_state_dict"]
    valid = load_dataloader(src.valid_path).dataset
    _, cpu_pred, _ = infer.predict_split(generator_from_state_dict(sd).eval().cast(torch.int8),
                                         valid, batch=N_EVAL)
    by_key = {(n, str(int(i))): k for k, (n, i) in enumerate(zip(valid.record_names,
                                                                 valid.start_idx))}
    cpu_pcc = [float(np.corrcoef(preds["int8"][k][0], cpu_pred[by_key[k]])[0, 1])
               for k in keys]
    # the scoring alone, on the train split in chunks of eval_batch
    store = load_dataloader(src.train_path).dataset
    gen = generator_from_state_dict(sd, "cuda").eval()
    scoring = {}
    for dtype, g in (("float32", gen), ("int8", gen.cast(torch.int8))):
        infer.predict_split(g, store, batch=N_EVAL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer.predict_split(g, store, batch=N_EVAL)
        torch.cuda.synchronize()
        scoring[dtype] = time.perf_counter() - t0
    print(f"int8: test <dir> valid last, {len(keys)} windows: int8 {stages['int8']['s']:.2f} s, "
          f"float32 {stages['float32']['s']:.2f} s (checkpoint load and CSV write included); "
          f"per-window PCC of int8 against float32 min {min(pcc):.4f}, median "
          f"{float(np.median(pcc)):.4f}; of the card's int8 against the CPU's int8 min "
          f"{min(cpu_pcc):.4f}, median {float(np.median(cpu_pcc)):.4f} (read, not held: "
          f"the JAX package's int8 loses the same correlation on SCG windows); the train "
          f"split's scoring alone ({len(store)} windows, "
          f"chunks of {N_EVAL}): int8 {scoring['int8'] * 1e3:.1f} ms, float32 "
          f"{scoring['float32'] * 1e3:.1f} ms on {card}", flush=True)
    report.update(eval=stages, pcc_min=min(pcc), pcc_median=float(np.median(pcc)),
                  cpu_pcc_min=min(cpu_pcc), cpu_pcc_median=float(np.median(cpu_pcc)),
                  scoring_s=scoring, windows=len(keys))
    return report


# ---- the host-side CLI: demo, export, report, channel_bucket, sweep --fast, summary --------

# The channel_bucket runs: waveform_07 of the sweep (PA, 2 SCG channels,
# batch 64) on a synthetic database of 4 records x 120 s.
BUCKET_RECORDS, BUCKET_SECONDS = 4, 120.0


def cli_end_to_end(torch, smoke: Smoke, root: str, card: str) -> dict:
    """The host-side CLI on the card: ``demo`` in process (the five training
    kernels counted from 0), ``export`` of its best checkpoint read back
    both ways, ``report`` over its root, waveform_07 trained with
    ``channel_bucket`` off and on (equal checkpoints), ``run_sweep``
    in process on waveform_23 and _07 under ``train_profile: "fast"``, and
    ``summary`` on the demo's database."""
    import contextlib
    import importlib.util

    from scgrhc_torch import summary
    from scgrhc_torch.__main__ import main as cli
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.data import run as data_run
    from scgrhc_torch.pipeline import demo, sweep
    from scgrhc_torch.train import checkpoint as ckpt_io
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.utils.experiments import make_params_dict, write_experiments
    from scgrhc_torch.utils.synth import make_synthetic_database

    fns = {k: fn for k, fn in _kernel_counters().items() if k in TRAIN_KERNELS}
    report, log = {}, io.StringIO()

    def zero():
        for fn in fns.values():
            fn.launches = 0

    def timed(what, fn):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        report.setdefault("seconds", {})[what] = secs
        print(f"cli {what}: {secs:.2f} s on {card}", flush=True)
        return out

    # demo: the synthetic database, the pipeline on the card, the figures
    mark = log.tell()
    zero()
    exp = timed("demo", lambda: demo.run(os.path.join(root, "demo"), epochs=1, n_records=2,
                                         duration_s=60.0))
    launches = {k: fn.launches for k, fn in fns.items()}
    report["demo_launches"] = launches
    smoke.check(all(v > 0 for v in launches.values()), f"demo: launches {launches}")
    demo_out = log.getvalue()[mark:]
    best_txt = os.path.join(exp, "checkpoint_best.txt")
    smoke.check(os.path.exists(best_txt), "demo: no checkpoint_best.txt")
    best = open(best_txt).read().split()[1] if os.path.exists(best_txt) else "?"
    for split in ("valid", "test"):
        smoke.check(os.path.exists(os.path.join(exp, "comparisons", split,
                                                best.split(".")[0] + ".csv")),
                    f"demo: no {split} comparison CSV for {best}")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    skipped = "figures skipped" in demo_out
    smoke.check(skipped == (not have_mpl),
                f"demo: figures skipped {skipped} with matplotlib installed {have_mpl}")
    print(f"cli demo: launches {launches}; best {best}; matplotlib installed {have_mpl}, "
          f"figures skipped {skipped}", flush=True)

    # export the best checkpoint; read it back as torch.save and through load
    params = Params(os.path.join(exp, "params.json"))
    src = os.path.join(params.checkpoint_dir_path, best)
    out_path = os.path.join(exp, best + ".torch")
    timed("export", lambda: cli(["export", exp, "best"]))
    ck, exported = ckpt_io.load(src), torch.load(out_path, weights_only=False)
    for k in ("g_state_dict", "d_state_dict"):
        smoke.check(all(isinstance(v, torch.Tensor) and tuple(v.shape) == ck[k][p].shape
                        for p, v in exported[k].items()) and exported[k].keys() == ck[k].keys(),
                    f"export: {k} entries are not tensors of the checkpoint's shapes")
    back = ckpt_io.load(out_path)
    same = all(np.array_equal(back[k][p], v) for k in ("g_state_dict", "d_state_dict")
               for p, v in ck[k].items()) and all(
        np.array_equal(np.asarray(back[k]["state"][i][m]), s[m])
        for k in ("g_optimizer_state_dict", "d_optimizer_state_dict")
        for i, s in ck[k]["state"].items() for m in ("exp_avg", "exp_avg_sq"))
    smoke.check(same and "format" not in exported, "export: read back differs")

    # report over the demo's root
    timed("report", lambda: cli(["report", os.path.join(root, "demo")]))
    rows = _read_csv(os.path.join(root, "demo", "sweep_report.csv"))
    smoke.check(len(rows) == 1 and rows[0]["checkpoint"] == best,
                f"report: {[(r['experiment'], r['checkpoint']) for r in rows]}, best {best}")

    # channel_bucket: waveform_07 (2 channels) 1 epoch in f32, key off and on
    db = make_synthetic_database(os.path.join(root, "bucket_db"), n_records=BUCKET_RECORDS,
                                 duration_s=BUCKET_SECONDS, seed=1)
    paths.set_data_path(os.path.dirname(db))
    runs = {}
    for name, extra in (("off", {}), ("on", {"channel_bucket": True})):
        d = os.path.join(root, f"bucket_{name}")
        os.makedirs(d)
        cfg = make_params_dict(7, "PA", ["patch_ACC_lat", "patch_ACC_hf"], total_epochs=1,
                               seed=0, **extra)
        cfg["dir_path"] = d
        with open(os.path.join(d, "params.json"), "w") as f:
            json.dump(cfg, f)
        runs[name] = Params(os.path.join(d, "params.json"))
    with contextlib.redirect_stdout(log):
        data_run.run(runs["off"])
    for f in ("loader_train.pickle", "loader_valid.pickle", "loader_test.pickle"):
        shutil.copy(os.path.join(runs["off"].dir_path, f), os.path.join(runs["on"].dir_path, f))
    for name in ("off", "on"):
        zero()
        timed(f"channel_bucket {name}", lambda: train_run.run(runs[name], plot=False))
        report[f"bucket_{name}_launches"] = {k: fn.launches for k, fn in fns.items()}
    off, on = (_ckpt(runs[n], 0) for n in ("off", "on"))
    smoke.check(on["g_state_dict"]["enc1.0.weight"].shape == (64, 2, 3)
                and on["d_state_dict"]["model.0.weight"].shape == (64, 3, 3),
                "channel_bucket: the checkpoint is not at the true channel count")
    max_diff = _max_state_diff(off, on)
    losses_equal = off["g_losses"] == on["g_losses"] and off["d_losses"] == on["d_losses"]
    print(f"channel_bucket on vs off, waveform_07 1 epoch f32 ({len(off['g_losses'])} steps): "
          f"losses equal {losses_equal}, max weight/moment diff {max_diff:.3g} on {card}",
          flush=True)
    report["channel_bucket"] = {"losses_equal": losses_equal, "max_diff": max_diff}
    smoke.check(losses_equal and max_diff == 0.0,
                f"channel_bucket on vs off differ: {report['channel_bucket']}")

    # sweep --fast: waveform_23 (1 channel) and waveform_07 (2), in process
    dirs = [d for d in write_experiments(os.path.join(root, "sweep"), total_epochs=1,
                                         train_profile="fast")
            if d.endswith(("waveform_07", "waveform_23"))]
    per_config = {}
    real_inproc = sweep.run_experiment_inproc

    def timed_inproc(d, device=None):
        t0 = time.perf_counter()
        code = real_inproc(d, device)
        torch.cuda.synchronize()
        per_config[os.path.basename(d)] = time.perf_counter() - t0
        return code

    sweep.run_experiment_inproc = timed_inproc
    zero()
    try:
        codes = timed("sweep --fast", lambda: sweep.run_sweep(dirs, inproc=True))
    finally:
        sweep.run_experiment_inproc = real_inproc
    launches = {k: fn.launches for k, fn in fns.items()}
    # bf16 ("fast") takes the plain vjp for the GP's second order, not the
    # f32 closed form: every training kernel but that one launches
    smoke.check(all((v == 0) == (k == "critic_layer_bwd_dx_vjp") for k, v in launches.items()),
                f"sweep --fast: launches {launches}")
    smoke.check(list(codes.values()) == [0, 0], f"sweep --fast: exit codes {codes}")
    for d in dirs:
        p = Params(os.path.join(d, "params.json"))
        names = ckpt_io.list_checkpoints(p.checkpoint_dir_path)
        c = len(p.in_channels)
        shapes = (ckpt_io.load(os.path.join(p.checkpoint_dir_path, names[0]))["g_state_dict"]
                  ["enc1.0.weight"].shape if names else None)
        smoke.check(names == ["000.checkpoint"] and shapes == (64, c, 3),
                    f"sweep --fast {os.path.basename(d)}: checkpoints {names}, enc1 {shapes}")
    print("cli sweep --fast per config: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                                      per_config.items())
          + f"; launches {launches} on {card}", flush=True)
    report.update(sweep_codes=codes, sweep_config_s=per_config, sweep_launches=launches)

    # summary on the demo's database, without pandas
    paths.set_data_path(os.path.join(root, "demo", "db"))
    mark = log.tell()
    timed("summary", summary.main)
    text = log.getvalue()[mark:]
    smoke.check(all(f"----- {s} -----" in text for s in ("All", "Male", "Female"))
                and "pandas" not in sys.modules, "summary: sections missing or pandas imported")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_cli.log"), "w") as f:
        f.write(log.getvalue())
    return report


# ---- the data axis: two ranks on one card ---------------------------------------

# One rank of a world of two on this card (launched by torchrun, or by
# _ranks with the environment torchrun gives): each argv of <runs> through
# ``python -m scgrhc_torch`` (with several runs, in one process group made
# first; with one, the CLI joins the group itself, from the environment),
# the kernel launch counts set to 0 just before each run and read just
# after, each run's seconds, and the files the rank wrote under <exp> (an
# audit hook), as JSON to <out>.<rank>.
_DIST_PROC = r"""
import importlib, json, os, sys, time
out, exp, kernels, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4])
writes = []
def audit(event, args):
    if event in ("open", "os.rename", "os.replace", "os.remove"):
        path = str(args[0])
        if path.startswith(exp + os.sep) and (event != "open" or args[1] is None
                                              or any(c in args[1] for c in "wax+")):
            writes.append(os.path.relpath(path, exp))
sys.addaudithook(audit)
import torch
from scgrhc_torch.__main__ import main
from scgrhc_torch.parallel import comm
fns = {k: getattr(importlib.import_module("scgrhc_torch.ops.kernels." + m), k)
       for k, m in kernels.items()}
if len(runs) > 1:
    comm.init_distributed(device=runs[0][runs[0].index("--device") + 1])
secs, launches, rcs = [], [], []
for argv in runs:
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rcs.append(main(argv))
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    launches.append({k: fn.launches for k, fn in fns.items()})
rank = int(os.environ["RANK"])
comm.destroy()
with open(f"{out}.{rank}", "w") as f:
    json.dump({"rank": rank, "rcs": rcs, "secs": secs, "launches": launches, "writes": writes}, f)
"""
# ``predict --mesh`` at world size 2 against world size 1 on the same card:
# each rank runs blocks of 256 windows where one process runs 512, and the
# plain ops on the path (cuDNN's attention and upsampling convs) may take
# other algorithms at other batch sizes; outputs are O(1).
TOL_MESH = 1e-4
# The pipeline's first critic loss at world size 2 against world size 1:
# one forward, its batch mean summed in two halves and all-reduced.
TOL_DIST_LOSS0 = 1e-5  # relative
# The pipeline's weights after 2 epochs (68 steps) at world size 2 against
# world size 1: the cross-process gradient sum adds the two halves in
# another order, the trajectories part at f32 rounding from the first
# update and the WGAN dynamics amplify it.  Reading 6.7e-3 on an H100 (the
# first critic loss equal); the bound is 3x.
TOL_DIST_WEIGHTS = 2e-2


def _torchrun(root: str, name: str, exp: str, argv: list[str], env: dict,
              reps: int = 1, timeout: float = 600) -> tuple[list[dict], float, str]:
    """``torchrun --standalone --nproc-per-node=2`` of _DIST_PROC: each rank's
    record, the wall time (process start included) and the log; every
    process of the launch is killed if it runs over ``timeout``."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(root, "dist_proc.py")
    with open(script, "w") as f:
        f.write(_DIST_PROC)
    out = os.path.join(root, f"dist_{name}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           script, out, exp, json.dumps(ALL_KERNELS), json.dumps([argv] * reps)]
    env = dict(os.environ, PYTHONPATH=here, **env)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        log = proc.communicate()[0] + f"\nkilled after {timeout} s"
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke_dist_{name}.log"), "w") as f:
        f.write(log)
    ranks = []
    if proc.returncode == 0:
        for r in range(2):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
    return ranks, wall, log


def dist_pipeline(torch, smoke: Smoke, root: str, card: str, world_one: dict) -> dict:
    """``torchrun --nproc-per-node=2 -m scgrhc_torch <dir> --device cuda:0``:
    the pipeline experiment's configuration (4 records x 1800 s, 2 epochs)
    at world size 2, both ranks on this card over gloo, against the
    pipeline phase's world-size-1 run of the same experiment."""
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.train import checkpoint as ckpt_io
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    one = Params(os.path.join(root, "pipeline", "params.json"))
    d = os.path.join(root, "dist")
    os.makedirs(d)
    two = Params(_write_params(d, total_epochs=2, eval_stack=8, eval_batch=N_EVAL, seed=0,
                               data_backend="device"))
    ranks, wall, log = _torchrun(root, "pipeline", d, [d, "--device", "cuda:0"],
                                 {"SCGRHC_DATA": os.path.join(root, "db")})
    if not smoke.check(len(ranks) == 2 and all(rc == 0 for r in ranks for rc in r["rcs"]),
                       f"torchrun -m scgrhc_torch <dir> at world size 2:\n{log[-3000:]}"):
        return {"wall_s": wall}
    smoke.check("2 rank(s) over gloo" in log, "the world of two ranks on one card is not gloo's")
    # the loader files and record log (rank 0 built them), and who wrote
    for name in ("loader_train.pickle", "loader_valid.pickle", "loader_test.pickle"):
        with open(os.path.join(one.dir_path, name), "rb") as f1, \
                open(os.path.join(d, name), "rb") as f2:
            smoke.check(f1.read() == f2.read(), f"dist pipeline: {name} differs from world 1's")
    logs = [open(os.path.join(p, "record_log.txt")).read().splitlines()[1:]
            for p in (one.dir_path, d)]
    smoke.check(logs[0] == logs[1], f"dist pipeline: record_log.txt {logs}")
    smoke.check(ranks[1]["writes"] == [], f"rank 1 wrote {ranks[1]['writes'][:5]}")
    smoke.check("checkpoint_best.txt" in ranks[0]["writes"], "rank 0 wrote no checkpoint_best.txt")
    # the launches of each rank: every training step on both ranks (each its
    # block), one generator forward per eval chunk on both, K3 on rank 0
    counts = {k: len(v) for k, v in _loader_counts(two).items()}
    steps = 2 * math.ceil(counts["train"] / N_TRAIN)
    per_step = launches_per_step(TrainConfig.from_params(two))
    chunks = 2 * math.ceil(counts["valid"] / N_EVAL) + math.ceil(counts["test"] / N_EVAL)
    for r, rec in enumerate(ranks):
        want = {k: per_step.get(k, 0) * steps for k in ALL_KERNELS}
        want["conv_in_relu"] += 14 * chunks
        want["gate_and_normalize"] = PIPELINE_RECORDS if r == 0 else 0
        smoke.check(rec["launches"][0] == want,
                    f"dist pipeline rank {r}: launches {rec['launches'][0]}, expected {want}")
    # the trained weights and losses against world size 1
    a, b = (ckpt_io.load(os.path.join(p.checkpoint_dir_path, "001.checkpoint"))
            for p in (one, two))
    weights = max(float(np.abs(a[k][p] - b[k][p]).max())
                  for k in ("g_state_dict", "d_state_dict") for p in a[k])
    loss0 = abs(b["d_losses"][0] - a["d_losses"][0]) / abs(a["d_losses"][0])
    smoke.check(np.isfinite(b["g_losses"] + b["d_losses"]).all(), "dist pipeline: non-finite loss")
    smoke.check(loss0 <= TOL_DIST_LOSS0, f"dist pipeline: first critic loss rel {loss0}")
    smoke.check(weights <= TOL_DIST_WEIGHTS, f"dist pipeline: weights max-abs {weights}")
    print(f"dist pipeline: torchrun --nproc-per-node=2 -m scgrhc_torch <dir> --device cuda:0 "
          f"(2 ranks on one card over gloo) in {wall:.1f} s, world size 1 in "
          f"{world_one.get('wall_s', math.nan):.1f} s (process start included; two ranks "
          f"sharing one card is a rehearsal of the data axis, not a scaling figure); "
          f"launches rank 0 {ranks[0]['launches'][0]}, rank 1 {ranks[1]['launches'][0]}; "
          f"rank 1 wrote {len(ranks[1]['writes'])} files, rank 0 {len(ranks[0]['writes'])}; "
          f"loader files equal; first critic loss rel {loss0:.3g}; weights after 2 epochs "
          f"max-abs {weights:.3g} from world size 1; on {card}", flush=True)
    return {"wall_s": wall, "world_one_wall_s": world_one.get("wall_s"), "steps": steps,
            "launches": [r["launches"][0] for r in ranks],
            "writes": [len(r["writes"]) for r in ranks], "loss0_rel": loss0,
            "weights_max_abs": weights}


def _loader_counts(params) -> dict:
    from scgrhc_torch.data.loaders import load_dataloader

    return {k: load_dataloader(getattr(params, f"{k}_path")).dataset.record_names
            for k in ("train", "valid", "test")}


DIST_PREDICT_RUNS = 4  # the first cold, the others warm: their spread


def dist_predict(torch, smoke: Smoke, root: str, card: str, serve_exp: str) -> dict:
    """``predict <dir> LONG030 last --mesh`` (1800 s, 1200 windows in chunks
    of 512, 512 and 176) at world size 2 (torchrun, both ranks on this card
    over gloo, DIST_PREDICT_RUNS runs in one group: the warm runs' spread)
    against world size 1 in this process (``--mesh`` a mesh of one), both
    timed warm."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.pipeline import predict

    data_root = os.path.join(os.path.dirname(serve_exp), "db")
    paths.set_data_path(data_root)
    params = Params(os.path.join(serve_exp, "params.json"))
    fns = _kernel_counters()
    one_ms = []
    for _ in range(2):
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        path = predict.run(params, "LONG030", "last", mesh=True, device="cuda",
                           out_dir=os.path.join(root, "dist_one"))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    one_launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
    want = np.load(path)
    _REFS["windowed"] = ("LONG030", want, one_ms[-1])
    argv = ["predict", serve_exp, "LONG030", "last", "--mesh", "--device", "cuda:0"]
    ranks, wall, log = _torchrun(root, "predict", serve_exp, argv, {"SCGRHC_DATA": data_root},
                                 reps=DIST_PREDICT_RUNS)
    if not smoke.check(len(ranks) == 2 and all(rc == 0 for r in ranks for rc in r["rcs"]),
                       f"torchrun -m scgrhc_torch predict --mesh:\n{log[-3000:]}"):
        return {"wall_s": wall}
    got = np.load(os.path.join(serve_exp, "predictions", "LONG030.npy"))
    err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
    smoke.check(got.shape == want.shape == (1200 * T,), f"predict --mesh: shape {got.shape}")
    smoke.check(err <= TOL_MESH, f"predict --mesh at world size 2 against 1: {err}")
    smoke.check(ranks[1]["writes"] == [], f"predict --mesh: rank 1 wrote {ranks[1]['writes']}")
    smoke.check("predictions/LONG030.npy" in ranks[0]["writes"], "predict --mesh: no .npy")
    for r, rec in enumerate(ranks):
        got_l = {k: v for k, v in rec["launches"][-1].items() if v}
        smoke.check(got_l == {"conv_in_relu": 42, "normalize_windows": 3},
                    f"predict --mesh rank {r}: launches {got_l}")
    two_ms = [s * 1e3 for s in ranks[0]["secs"]]
    warm = two_ms[1:]
    print(f"dist predict --mesh: LONG030 (1800 s, 1200 windows), world size 2 (2 ranks on one "
          f"card over gloo) {len(warm)} warm runs {', '.join(f'{v:.1f}' for v in warm)} ms "
          f"(min {min(warm):.1f}, max {max(warm):.1f}, mean {sum(warm) / len(warm):.1f}; "
          f"{two_ms[0]:.1f} cold, the launch {wall:.1f} s with process start), world size 1 "
          f"{one_ms[-1]:.1f} ms warm; max-abs {err:.3g} (tol {TOL_MESH:g}); launches a rank "
          f"{ranks[0]['launches'][-1]}, world 1 {one_launches}; rank 1 wrote nothing; on {card}",
          flush=True)
    return {"world_two_ms": two_ms, "world_one_ms": one_ms, "launch_wall_s": wall,
            "warm_spread_ms": [min(warm), max(warm)], "max_abs_err": err,
            "launches": [r["launches"][-1] for r in ranks]}


# ---- the time, stage and model axes: two ranks on one card ------------------

K_BLOCK = int(RECORDS[0][1] * 500) // 2  # a rank's block of the 600-s record at world size 2
K_SHORT = 5_000  # a block below K1f's 8,192-step row piece
# A continuous prediction at world size 2 against world size 1 on the card:
# the convs give the same bits (a block's edge columns are its neighbour's,
# and the conv core's sums do not depend on a column's tile), but every
# instance norm adds its row sums per block and then across the ranks, in
# another order than one rank's pieces.  The forward amplifies f32 rounding
# on this record and seed: each f32 path, world size 1's, world size 2's and
# the CPU's, sits 1.4e-3 to 2.4e-3 from float64 (outputs within about
# [-4.5, 3.0]), so two of them differ by up to about their sum: held to
# TOL_SERVE's envelope, and each to float64 within ENVELOPE_FACTOR times
# the CPU's own distance.
TOL_CP = TOL_SERVE
# The 1x2 tensor-parallel forward against the replicated one: K1f's rows
# are the same at O/2 channels, but the up-convs' and the attention psi's
# sums are split over the two ranks and all-reduced.
TOL_TP = 1e-4
N_PP, MB_PP = 17, 4  # pipeline_infer's windows and microbatch
N_TP = 64  # the tensor-parallel forward's windows


def check_time_sharded_k1f(torch, smoke: Smoke) -> dict:
    """K1f's two time-sharded phases (conv_in_relu_part, conv_in_relu_apply)
    against their plain versions at the 14 layer shapes of a 600-s record's
    block at world size 2 (N = 1, 150,000 steps and the two halo columns,
    all of it uniform in [0, 1): non-zero halos), with the row sums doubled
    as a second block of the same statistics would make them; then below
    8,192 steps, a record of 2 x 5,000 steps cut in two blocks (each with
    the other's edge column) against the whole-record layer.  Times of the
    two phases and of their plain versions at each shape (the sums held
    against the sum of their terms' magnitudes); bounds: the
    convs' operations at the f32 FMA peak and at 3xTF32, and the bytes of
    the halo'd block in and y out."""
    from scgrhc_torch.ops.kernels import conv_block as k1f

    k = K_BLOCK
    shapes = [(cin, o) for cin, o, _ in _layer_shapes(len(CHANNELS))]
    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(cin, o, steps):
        bound = 1.0 / math.sqrt(cin * 3)
        return (torch.rand(1, cin, steps, device="cuda", generator=gen),
                (torch.rand(o, cin, 3, device="cuda", generator=gen) * 2 - 1) * bound,
                (torch.rand(o, device="cuda", generator=gen) * 2 - 1) * bound)

    def layer(part, apply, xh, w, b):
        c, sums = part(xh, w, b)
        return c, sums, apply(c, sums * 2, 2 * k, xh.dtype)

    def kernel(xh, w, b):
        return layer(k1f.conv_in_relu_part, k1f.conv_in_relu_apply, xh, w, b)

    def plain(xh, w, b):
        return layer(k1f.conv_in_relu_part_plain, k1f.conv_in_relu_apply_plain, xh, w, b)

    per_shape, err, sums_err = {}, 0.0, 0.0
    for cin, o in dict.fromkeys(shapes):
        xh, w, b = inputs(cin, o, k + 2)
        (_, sums, y), (pc, psums, py) = kernel(xh, w, b), plain(xh, w, b)
        e = float((y - py).abs().max())
        # each sum against the sum of its terms' magnitudes
        scale = torch.stack((pc[..., 1:-1].abs().sum(-1).reshape(-1), psums[:, 1]), -1)
        se = float(((sums - psums).abs() / scale).max())
        del pc
        err, sums_err = max(err, e), max(sums_err, se)
        del y, py
        flops, nbytes = 6.0 * cin * o * k, 4.0 * (cin * (k + 2) + o * k)
        per_shape[f"{cin}x{o}"] = rec = {
            "layers": shapes.count((cin, o)), "max_abs_err": e, "sums_rel_err": se,
            "ms": _time_ms(torch, lambda: kernel(xh, w, b), reps=3, warmup=1),
            "plain_ms": _time_ms(torch, lambda: plain(xh, w, b), reps=3, warmup=1),
            "flop_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
            "rate_bound_ms": flops / PEAK_TF32X3_FLOPS * 1e3,
            "byte_bound_ms": nbytes / PEAK_BYTES * 1e3}
        print(f"conv_in_relu time-sharded N=1 C_in={cin} O={o} block {k} (+2 halo): max abs "
              f"err kernel vs plain {e:.3g}, sums rel {se:.3g}; both phases {rec['ms']:.3f} ms, "
              f"plain {rec['plain_ms']:.3f} ms", flush=True)
        del xh, w, b
    # below one row piece: two real blocks against the whole-record layer
    x, w, b = inputs(64, 128, 2 * K_SHORT)
    z = torch.zeros_like(x[..., :1])
    blocks = (torch.cat((z, x[..., :K_SHORT], x[..., K_SHORT:K_SHORT + 1]), -1),
              torch.cat((x[..., K_SHORT - 1:K_SHORT], x[..., K_SHORT:], z), -1))
    parts = [k1f.conv_in_relu_part(xh, w, b) for xh in blocks]
    total = parts[0][1] + parts[1][1]
    y = torch.cat([k1f.conv_in_relu_apply(c, total, 2 * K_SHORT, x.dtype) for c, _ in parts], -1)
    short = float((y - k1f.conv_in_relu_plain(x, w, b)).abs().max())
    err = max(err, short)
    smoke.check(err <= TOL_F32, f"conv_in_relu time-sharded phases: max abs err {err}")
    smoke.check(sums_err <= TOL_F32, f"conv_in_relu_part sums: rel err {sums_err}")
    total = {key: sum(r[key] * r["layers"] for r in per_shape.values())
             for key in ("ms", "plain_ms", "flop_bound_ms", "rate_bound_ms", "byte_bound_ms")}
    bound = max(total["flop_bound_ms"], total["byte_bound_ms"])
    print(f"conv_in_relu time-sharded, the 14 layers of a rank's block ({k} steps) of a 600-s "
          f"record at world size 2: both phases {total['ms']:.2f} ms, plain "
          f"{total['plain_ms']:.2f} ms, bound {bound:.2f} ms (f32 FMA), "
          f"{total['rate_bound_ms']:.2f} ms at 3xTF32; two "
          f"blocks of {K_SHORT} against the whole-record layer: max abs err {short:.3g}",
          flush=True)
    return {**total, "bound_ms": bound, "max_abs_err": err, "sums_rel_err": sums_err,
            "short_blocks_max_abs_err": short, "per_shape": per_shape,
            "bound_by": "operations" if total["flop_bound_ms"] >= total["byte_bound_ms"]
            else "bytes"}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ranks(root: str, name: str, script: str, args: list[str], env: dict, stdin: str = "",
           timeout: float = 600) -> tuple[list[dict], list[str], float]:
    """``script`` as two ranks of a world on this card, launched here with the
    environment torchrun would give them (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), ``stdin`` to rank 0: each rank's JSON
    record (``<out>.<rank>``; none for a rank that failed), each rank's
    output, and the wall time (process start included).  Every process is
    killed if the world runs over ``timeout``."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, f"{name}_proc.py")
    with open(path, "w") as f:
        f.write(script)
    out = os.path.join(root, f"dist_{name}")
    base = dict(os.environ, PYTHONPATH=here, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), **env)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, path, out, *args], cwd=here,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for r in range(2)]
    logs = []
    try:
        for r, proc in enumerate(procs):
            logs.append(proc.communicate(stdin if r == 0 else "", timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            os.killpg(proc.pid, 9)
        logs = [proc.communicate()[0] + f"\nkilled after {timeout} s" for proc in procs]
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"chip_smoke_dist_{name}.log"), "w") as f:
        f.write("\n".join(f"== rank {r}\n{log}" for r, log in enumerate(logs)))
    recs = []
    for r, proc in enumerate(procs):
        if proc.returncode == 0 and os.path.exists(f"{out}.{r}"):
            with open(f"{out}.{r}") as f:
                recs.append(json.load(f))
    return recs, logs, wall


CP_RUNS = 3  # predict --continuous on the 600-s record: the first cold


def _odd_record(torch, exp: str) -> str:
    """A 600.002-s record (300,001 samples: an odd length) beside the
    serving phase's records."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.io.wfdb import rdrecord, wrrecord
    from scgrhc_torch.utils.synth import make_synthetic_database

    root = os.path.dirname(exp)
    other = make_synthetic_database(os.path.join(root, "ODD0600"), n_records=1,
                                    duration_s=600.002, seed=7, flatline_in_first=False)
    rec = rdrecord(os.path.join(other, "SYN000"))
    wrrecord(os.path.join(paths.PROCESSED_DATA_PATH, "ODD0600"), rec.fs, rec.sig_name,
             rec.p_signal)
    return "ODD0600"


def dist_cp_serve(torch, smoke: Smoke, root: str, card: str, serve_exp: str) -> dict:
    """The time axis and serving over two ranks on this card (gloo), in one
    launch: ``predict <dir> SYN000 last --continuous`` CP_RUNS times (the
    600-s record: time-sharded, 14 launches of each K1f phase a rank), then
    on an odd-length record (``apply_continuous`` on each rank, 14 K1f
    launches), then a ``serve --mesh`` daemon answering, in order, a
    windowed request past one chunk (LONG030: its windows split over the
    ranks), a continuous request (SYN000, time-sharded), ``ping``, a bad
    record name (one error line; the daemon carries on) and ``quit``.
    Against world size 1 in this process: the continuous waveforms within
    TOL_CP (the odd record's equal bit for bit), and each held to float64
    within ENVELOPE_FACTOR times the CPU f32 path's distance (the continuous
    phase's reference); the windowed answer within TOL_MESH of ``predict
    --mesh`` at world size 1.  Rank 1 writes nothing and prints no answer."""
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.pipeline import predict

    params = Params(os.path.join(serve_exp, "params.json"))
    paths.set_data_path(os.path.join(os.path.dirname(serve_exp), "db"))
    odd = _odd_record(torch, serve_exp)
    rec600 = RECORDS[0][0]
    one, one_ms = {}, []
    for name in (rec600, rec600, odd):
        t0 = time.perf_counter()
        path = predict.run(params, name, "last", continuous=True, device="cuda",
                           out_dir=os.path.join(root, "cp_one"))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one[name] = np.load(path)
    base = ["--device", "cuda:0"]
    runs = ([["predict", serve_exp, rec600, "last", "--continuous", *base]] * CP_RUNS
            + [["predict", serve_exp, odd, "last", "--continuous", *base],
               ["serve", serve_exp, "last", "--mesh", *base]])
    requests = [{"record": "LONG030"}, {"record": rec600, "continuous": True, "save": False},
                {"cmd": "ping"}, {"record": "../etc/passwd"}, {"cmd": "quit"}]
    recs, logs, wall = _ranks(root, "cp_serve", _DIST_PROC,
                              [serve_exp, json.dumps(ALL_KERNELS), json.dumps(runs)],
                              {"SCGRHC_DATA": paths.DATA_PATH},
                              stdin="".join(json.dumps(r) + "\n" for r in requests))
    if not smoke.check(len(recs) == 2 and all(rc == 0 for r in recs for rc in r["rcs"]),
                       "dist cp/serve: " + "\n".join(log[-3000:] for log in logs)):
        return {"wall_s": wall}
    report = {"wall_s": wall, "world_one_ms": one_ms}
    pred = os.path.join(serve_exp, "predictions")
    for rec in recs:
        rec["launches"] = [{k: v for k, v in run.items() if v} for run in rec["launches"]]
    for r, rec in enumerate(recs):
        for i in range(CP_RUNS):
            smoke.check(rec["launches"][i] == {"conv_in_relu_part": 14, "conv_in_relu_apply": 14},
                        f"predict --continuous at world size 2, rank {r}: launches "
                        f"{rec['launches'][i]}")
        smoke.check(rec["launches"][CP_RUNS] == {"conv_in_relu": 14},
                    f"predict --continuous on {odd} at world size 2, rank {r}: launches "
                    f"{rec['launches'][CP_RUNS]}")
        smoke.check(rec["launches"][-1] == {"conv_in_relu": 42, "normalize_windows": 3,
                                            "conv_in_relu_part": 14, "conv_in_relu_apply": 14},
                    f"serve --mesh at world size 2, rank {r}: launches {rec['launches'][-1]}")
    smoke.check(recs[1]["writes"] == [], f"dist cp/serve: rank 1 wrote {recs[1]['writes'][:5]}")
    smoke.check({f"predictions/{n}.npy" for n in (rec600, odd, "LONG030")}
                <= set(recs[0]["writes"]),
                f"dist cp/serve: rank 0 wrote {recs[0]['writes']}")
    errs = {}
    two600 = np.load(os.path.join(pred, f"{rec600}.npy"))
    errs["predict_continuous"] = float(np.abs(two600 - one[rec600]).max())
    smoke.check(two600.shape == one[rec600].shape and errs["predict_continuous"] <= TOL_CP,
                f"predict --continuous {rec600} at world size 2 against 1: "
                f"{errs['predict_continuous']}")
    refs = _REFS.get("continuous")
    if smoke.check(refs is not None and refs[0] == rec600,
                   "dist cp: no float64 reference from the continuous phase"):
        _, ref, cpu_err = refs
        for key, wave in (("world_two_vs_f64", two600), ("world_one_vs_f64", one[rec600])):
            errs[key] = float(np.abs(wave - ref).max())
            smoke.check(errs[key] <= ENVELOPE_FACTOR * cpu_err,
                        f"continuous {rec600} {key} {errs[key]}, over {ENVELOPE_FACTOR} x the "
                        f"cpu's f32 {cpu_err}")
        errs["cpu_vs_f64"] = cpu_err
    two_odd = np.load(os.path.join(pred, f"{odd}.npy"))
    errs["odd_equal"] = bool(np.array_equal(two_odd, one[odd]))
    smoke.check(errs["odd_equal"], f"predict --continuous on {odd}: world size 2 differs from 1")
    answers = [json.loads(line) for line in logs[0].splitlines() if line.startswith("{")]
    smoke.check(not any(line.startswith("{") for line in logs[1].splitlines()),
                "serve at world size 2: rank 1 printed an answer")
    if smoke.check(len(answers) == 4 and "error" in answers[3]
                   and answers[2] == {"ok": True, "checkpoint": "001.checkpoint"},
                   f"serve at world size 2: answers {[str(a)[:200] for a in answers]}"):
        windowed = np.load(answers[0]["path"])
        _, want_w, one_w_ms = _REFS["windowed"]
        errs["serve_windowed"] = float(np.abs(windowed - want_w).max())
        smoke.check(windowed.shape == want_w.shape and errs["serve_windowed"] <= TOL_MESH,
                    f"serve LONG030 at world size 2 against predict --mesh at 1: "
                    f"{errs['serve_windowed']}")
        cont = np.asarray(answers[1]["waveform"], dtype=np.float32)
        errs["serve_continuous"] = float(np.abs(cont - one[rec600]).max())
        smoke.check(errs["serve_continuous"] <= TOL_CP,
                    f"serve {rec600} continuous at world size 2 against 1: "
                    f"{errs['serve_continuous']}")
        report["serve_ms"] = {"windowed": answers[0]["ms"], "continuous": answers[1]["ms"],
                              "world_one_windowed": one_w_ms,
                              "world_one_continuous": one_ms[1]}
    two_ms = [v * 1e3 for v in recs[0]["secs"][:CP_RUNS]]
    report.update(world_two_ms=two_ms, max_abs_err=errs,
                  launches=[r["launches"] for r in recs])
    print(f"dist predict --continuous: {rec600} (600 s) at world size 2 (2 ranks on one card "
          f"over gloo, apply_cp: 20 halo exchanges, 23 norm all-reduces and 1 gather a forward) "
          f"{', '.join(f'{v:.1f}' for v in two_ms[1:])} ms warm ({two_ms[0]:.1f} cold), world "
          f"size 1 {one_ms[1]:.1f} ms warm, max-abs {errs['predict_continuous']:.3g} (tol "
          f"{TOL_CP:g}); {odd} (odd length, apply_continuous on each rank) "
          f"{recs[0]['secs'][CP_RUNS] * 1e3:.1f} ms, equal to world size 1 {errs['odd_equal']}; "
          f"launches a rank {recs[0]['launches'][CP_RUNS - 1]}; rank 1 wrote nothing; on {card}",
          flush=True)
    if "serve_ms" in report:
        sm = report["serve_ms"]
        print(f"dist serve --mesh: 2 ranks, LONG030 windowed {sm['windowed']} ms (world size 1 "
              f"predict --mesh {sm['world_one_windowed']:.1f} ms), {rec600} continuous "
              f"{sm['continuous']} ms (world size 1 {sm['world_one_continuous']:.1f} ms), ping, "
              f"a bad name answered with an error, quit; max abs err " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items() if isinstance(v, float))
              + f" (tol {TOL_CP:g} continuous, {TOL_MESH:g} windowed, f64 within "
              f"{ENVELOPE_FACTOR:g} x cpu); launch {wall:.1f} s with process start; on {card}",
              flush=True)
    return report


# One rank: pipeline_infer over the stage axis (N_PP windows, microbatch
# MB_PP) and the 1x2 tensor-parallel forward (N_TP windows), each against
# the world-size-1 forward of the same weights in this rank, with the
# launches of each path and warm times, as JSON to <out>.<rank>.
_PP_TP_PROC = r"""
import importlib, json, sys, time
out, kernels, n_pp, mb, n_tp = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:6])
import torch
from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.models.generator import Generator
from scgrhc_torch.parallel import comm, pp, tp
comm.init_distributed(device="cuda:0")
dev = resolve_device("cuda:0")
fns = {k: getattr(importlib.import_module("scgrhc_torch.ops.kernels." + m), k)
       for k, m in kernels.items()}
gen = Generator(4, torch.Generator().manual_seed(1234)).to(dev).eval()
rng = torch.Generator().manual_seed(7)
def run(fn, reps=3):
    for f in fns.values():
        f.launches = 0
    y = fn()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items() if f.launches}
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return y, launches, ms
rec = {"rank": comm.process_index()}
stage = pp.make_pp_mesh()
model = tp.shard_params(gen, tp.make_dp_tp_mesh(1, 2))
paths = {"pp": (n_pp, lambda x: pp.pipeline_infer(gen, x, stage, microbatch=mb)),
         "tp": (n_tp, model)}
with torch.inference_mode():
    for name, (n, fn) in paths.items():
        x = torch.rand(n, 4, 750, generator=rng).to(dev)
        ref, ref_launches, ref_ms = run(lambda: gen(x))
        y, launches, ms = run(lambda: fn(x))
        rec[name] = {"max_abs_err": float((y - ref).abs().max()), "shape": list(y.shape),
                     "finite": bool(torch.isfinite(y).all()), "launches": launches, "ms": ms,
                     "world_one_launches": ref_launches, "world_one_ms": ref_ms}
comm.destroy()
with open(f"{out}.{rec['rank']}", "w") as f:
    json.dump(rec, f)
"""


def dist_pp_tp(torch, smoke: Smoke, root: str, card: str) -> dict:
    """``pipeline_infer`` over a 2-rank stage axis (N_PP windows at T = 750
    in microbatches of MB_PP, one padded row) and the 1x2 tensor-parallel
    forward (``tp.shard_params`` on ``make_dp_tp_mesh(1, 2)``, N_TP
    windows), both ranks on this card over gloo, each against the
    world-size-1 eval forward of the same seeded weights; K1f launches a
    rank: 8 a microbatch on stage 0, 6 on stage 1; 14 a forward at O/2 on
    each tensor-parallel rank."""
    recs, logs, wall = _ranks(root, "pp_tp", _PP_TP_PROC,
                              [json.dumps(ALL_KERNELS), str(N_PP), str(MB_PP), str(N_TP)], {})
    if not smoke.check(len(recs) == 2, "dist pp/tp: " + "\n".join(l[-3000:] for l in logs)):
        return {"wall_s": wall}
    n_mb = -(-N_PP // MB_PP)
    for r, rec in enumerate(recs):
        for name, n, want in (("pp", N_PP, {"conv_in_relu": (8 if r == 0 else 6) * n_mb}),
                              ("tp", N_TP, {"conv_in_relu": 14})):
            got = rec[name]
            tol = TOL_MESH if name == "pp" else TOL_TP
            smoke.check(got["shape"] == [n, 1, T] and got["finite"]
                        and got["max_abs_err"] <= tol,
                        f"dist {name} rank {r}: shape {got['shape']}, max-abs "
                        f"{got['max_abs_err']} (tol {tol})")
            smoke.check(got["launches"] == want, f"dist {name} rank {r}: launches "
                                                 f"{got['launches']}, expected {want}")
    for name, what in (("pp", f"pipeline_infer ({N_PP} windows, microbatch {MB_PP})"),
                       ("tp", f"1x2 tensor-parallel forward ({N_TP} windows)")):
        a = recs[0][name]
        print(f"dist {name}: {what} at world size 2 (one card, gloo) "
              f"{', '.join(f'{v:.1f}' for v in a['ms'])} ms, world size 1 "
              f"{', '.join(f'{v:.1f}' for v in a['world_one_ms'])} ms; max-abs "
              f"{max(r[name]['max_abs_err'] for r in recs):.3g}; launches rank 0 "
              f"{a['launches']}, rank 1 {recs[1][name]['launches']}; on {card}", flush=True)
    return {"wall_s": wall, "pp": [r["pp"] for r in recs], "tp": [r["tp"] for r in recs]}


def dist_end_to_end(torch, smoke: Smoke, root: str, card: str, world_one: dict,
                    serve_exp: str) -> dict:
    """The parallel tier on one card (module doc): the pipeline and
    ``predict --mesh`` at world size 2 over gloo; K1f's time-sharded phases
    against their plain versions; continuous prediction and the ``serve
    --mesh`` daemon at world size 2; ``pipeline_infer`` and the
    tensor-parallel forward at world size 2."""
    t0 = time.perf_counter()
    out = {"pipeline": dist_pipeline(torch, smoke, root, card, world_one),
           "predict": dist_predict(torch, smoke, root, card, serve_exp),
           "time_sharded_k1f": check_time_sharded_k1f(torch, smoke),
           "cp_serve": dist_cp_serve(torch, smoke, root, card, serve_exp),
           "pp_tp": dist_pp_tp(torch, smoke, root, card)}
    out["seconds"] = time.perf_counter() - t0
    print(f"dist phase: {out['seconds']:.1f} s", flush=True)
    return out


def _time_sharded_entry(dist: dict) -> dict:
    """K1f's time-sharded phases for the kernels line: the launches of a
    rank in the time-sharded predict run (the main path of the time axis),
    and the phases' error, times and bounds at a 600-s record's block at
    world size 2 (check_time_sharded_k1f)."""
    k = dist.get("time_sharded_k1f", {})
    runs = dist.get("cp_serve", {}).get("launches", [[{}]])[0]
    main_path = runs[CP_RUNS - 1] if len(runs) >= CP_RUNS else {}
    return {"sources": ["scgrhc_torch/csrc/conv_layer.cu:scgrhc_conv_in_relu_part",
                        "scgrhc_torch/csrc/conv_layer.cu:scgrhc_conv_in_relu_apply"],
            "launches_part": main_path.get("conv_in_relu_part", 0),
            "launches_apply": main_path.get("conv_in_relu_apply", 0),
            **{key: k.get(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "rate_bound_ms")},
            "library_ms": None}


# ---- Orbax checkpoints ------------------------------------------------------------

def _ckpt_arrays(ckpt: dict) -> dict:
    """Every array of a checkpoint dict (weights and Adam moments), by name."""
    out = {f"{k}/{p}": v for k in ("g_state_dict", "d_state_dict") for p, v in ckpt[k].items()}
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        for i, s in ckpt[k]["state"].items():
            out.update({f"{k}/{i}/{m}": s[m] for m in ("exp_avg", "exp_avg_sq")})
            out[f"{k}/{i}/step"] = np.asarray(s["step"])
    return out


def _ckpt_diff(a: dict, b: dict) -> float:
    """0.0 when two checkpoints hold the same losses and the same arrays bit
    for bit, else their largest difference (inf for another layout)."""
    x, y = _ckpt_arrays(a), _ckpt_arrays(b)
    if x.keys() != y.keys() or (a["g_losses"], a["d_losses"]) != (b["g_losses"], b["d_losses"]):
        return math.inf
    if all(np.asarray(v).tobytes() == np.asarray(y[k]).tobytes() for k, v in x.items()):
        return 0.0
    return max(float(np.abs(np.asarray(v, np.float64) - np.asarray(y[k], np.float64)).max())
               for k, v in x.items())


SPLIT_REPLICAS = 4  # the devices of the Orbax save the orbax phase's split copy stands for


def _orbax_split_copy(src: str, dst: str, replicas: int) -> int:
    """Copy the Orbax directory ``src`` to ``dst`` with each array split
    into the zarr v2 chunk grid that Orbax's save of a state replicated over
    ``replicas`` devices writes (``zarr2.replica_chunks``); returns how many
    arrays are split."""
    from scgrhc_torch.train import ocdbt, zarr2

    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("d", "manifest.ocdbt"))
    store = ocdbt.read(src)
    items, chunks, n_split = {}, {}, 0
    for key in store:
        if key.endswith(b"/.zarray"):
            name = key[:-len(b"/.zarray")].decode()
            a = zarr2.decode(name, store)
            chunks[name] = zarr2.replica_chunks(a.shape, replicas)
            n_split += chunks[name] != list(a.shape)
            items.update(zarr2.encode(name, a, chunks[name]))
    ocdbt.write(dst, items)
    rel = os.path.join(dst, "array_metadatas", "process_0")
    with open(rel) as f:
        doc = json.load(f)
    for e in doc["array_metadatas"]:
        m = e["array_metadata"]
        m["write_shape"] = m["chunk_shape"] = chunks[m["param_name"]]
    with open(rel, "w") as f:
        json.dump(doc, f)
    return n_split


def _state_equal(torch, a, b) -> bool:
    """Two ``wgan.TrainState``s hold the same weights and Adam state bit for bit."""
    def tensors(st):
        out = [*st.generator.state_dict().values(), *st.critic.state_dict().values()]
        for opt in (st.g_opt, st.d_opt):
            for s in opt.state_dict()["state"].values():
                out += [torch.as_tensor(v) for v in s.values()]
        return out

    x, y = tensors(a), tensors(b)
    return len(x) == len(y) and all(u.dtype == v.dtype and u.shape == v.shape and
                                    torch.equal(u, v) for u, v in zip(x, y))


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _export_dict_equal(torch, a: dict, b: dict) -> bool:
    if list(a) != list(b):
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, dict):
            if not _export_dict_equal(torch, v, w):
                return False
        elif isinstance(v, torch.Tensor):
            if not (isinstance(w, torch.Tensor) and v.dtype == w.dtype and torch.equal(v, w)):
                return False
        elif v != w:
            return False
    return True


def orbax_end_to_end(torch, smoke: Smoke, root: str, card: str, pipeline: dict) -> dict:
    """``checkpoint_backend: "orbax"`` on the pipeline phase's experiment
    (same data, seed and depth): ``python -m scgrhc_torch <dir>`` in a new
    process, held to the pipeline phase's pickle-backend run (each epoch's
    weights and Adam moments bit for bit, the score and comparison CSVs and
    ``checkpoint_best.txt`` byte for byte); one more epoch resumed from the
    last ``.orbax`` dir against the same resume from the pickle and from a
    copy of that dir split as Orbax's save on 4 devices splits it (loaded
    onto the card bit for bit against the one-chunk dir, both loads timed);
    ``predict`` and ``export`` from the best ``.orbax`` against the
    pickle's (the export's dicts equal but for ``start_time``, each run's
    wall-clock start); then one full checkpoint saved and loaded by each backend,
    timed on the host clock, with its bytes on disk."""
    from scgrhc_torch.__main__ import main as cli
    from scgrhc_torch.core.device import resolve_device
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.native import zstd
    from scgrhc_torch.train import checkpoint as ckpt_io
    from scgrhc_torch.train import orbax_io
    from scgrhc_torch.train import run as train_run
    from scgrhc_torch.train.wgan import TrainConfig

    t_phase = time.perf_counter()
    report = {"card": card, "zstd": f"{zstd.LIBRARY} {zstd.version()} (host library, ctypes)"}
    ref_dir = os.path.join(root, "pipeline")
    if not smoke.check("launches" in pipeline, "orbax: the pipeline phase did not run"):
        return report
    ref = Params(os.path.join(ref_dir, "params.json"))
    fns = _kernel_counters()

    def run_pipeline(name, **extra):
        d = os.path.join(root, name)
        os.makedirs(d)
        params = Params(_write_params(d, total_epochs=2, eval_stack=8, eval_batch=N_EVAL,
                                      seed=0, data_backend="device", **extra))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _PIPELINE_PROC, d, json.dumps(ALL_KERNELS)],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=900, env=dict(os.environ, SCGRHC_DATA=pipeline["data_root"]))
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT_DIR, f"chip_smoke_{name}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if not smoke.check(proc.returncode == 0, f"{name}: python -m scgrhc_torch <dir>: rc "
                                                 f"{proc.returncode}\n{proc.stderr[-3000:]}"):
            return params, None, wall
        return params, json.loads(proc.stdout.strip().splitlines()[-1]), wall

    def artifacts(params) -> dict:
        best = open(os.path.join(params.dir_path, "checkpoint_best.txt")).read().split()[1]
        rels = ["checkpoint_scores.csv", "checkpoint_best.txt",
                f"comparisons/test/{best.split('.')[0]}.csv"]
        rels += [f"comparisons/valid/{n}" for n in sorted(os.listdir(os.path.join(
            params.comparison_dir_path, "valid")))]
        out = {}
        for rel in rels:
            with open(os.path.join(params.dir_path, rel), "rb") as f:
                out[rel] = f.read()
        return out

    def epochs(params, suffix="") -> list:
        return [ckpt_io.load(os.path.join(params.checkpoint_dir_path,
                                          f"{e:03d}.checkpoint{suffix}")) for e in (0, 1)]

    # 1. the pipeline with the Orbax backend, in a new process
    orb, launches, wall = run_pipeline("orbax", checkpoint_backend="orbax")
    if launches is None:
        return report
    report.update(wall_s=wall, pipeline_wall_s=pipeline["wall_s"], launches=launches)
    names = ckpt_io.list_checkpoints(orb.checkpoint_dir_path)
    smoke.check(names == ["000.checkpoint.orbax", "001.checkpoint.orbax"],
                f"orbax pipeline: checkpoints {names}")
    smoke.check(launches == pipeline["launches"],
                f"orbax pipeline: launches {launches}, the pickle backend's {pipeline['launches']}")
    # 2. against the pickle backend's run
    diffs = [_ckpt_diff(a, b) for a, b in zip(epochs(orb, ".orbax"), epochs(ref))]
    files = artifacts(orb)
    ref_files = artifacts(ref)
    differ = sorted(k for k in files.keys() | ref_files.keys()
                    if files.get(k) != ref_files.get(k))
    report.update(epoch_diffs=diffs, files_compared=sorted(files), files_differ=differ)
    if max(diffs) != 0.0 or differ:  # hold to the pickle backend's own run-to-run difference
        again, _, _ = run_pipeline("pipeline_again")
        noise = [_ckpt_diff(a, b) for a, b in zip(epochs(again), epochs(ref))]
        noise_files = artifacts(again)
        noise_differ = sorted(k for k in noise_files if noise_files[k] != ref_files.get(k))
        report.update(run_to_run_diffs=noise, run_to_run_files_differ=noise_differ)
        smoke.check(all(d <= n for d, n in zip(diffs, noise)) and set(differ) <= set(noise_differ),
                    f"orbax pipeline: epochs differ by {diffs} and files {differ} from the pickle "
                    f"backend's, whose own runs differ by {noise} and {noise_differ}")
    print(f"orbax: python -m scgrhc_torch <dir> with checkpoint_backend orbax in {wall:.1f} s "
          f"(pickle backend {pipeline['wall_s']:.1f} s, process start included); epochs against "
          f"the pickle backend's {diffs} (0.0: bit for bit); files differing {differ} of "
          f"{len(files)}; launches equal {launches == pipeline['launches']} on {card}", flush=True)

    # 3. the last .orbax dir as Orbax writes it on 4 devices (chunk grids), on a copy:
    # loaded onto the card against the one-chunk dir, both loads timed in turns
    last = orbax_io.ORBAX_SUFFIX
    cfg = TrainConfig.from_params(orb)
    dev = resolve_device("cuda")

    def median_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    split_dir = os.path.join(root, "orbax_split")
    shutil.copytree(orb.dir_path, split_dir, ignore=shutil.ignore_patterns("comparisons", "pred*"))
    one = os.path.join(orb.checkpoint_dir_path, f"001.checkpoint{last}")
    grid = os.path.join(split_dir, "checkpoints", f"001.checkpoint{last}")
    shutil.rmtree(grid)
    t0 = time.perf_counter()
    n_split = _orbax_split_copy(one, grid, SPLIT_REPLICAS)
    copy_s = time.perf_counter() - t0
    smoke.check(n_split >= 150, f"orbax split copy: {n_split} arrays split, at least 150 expected")
    states = {what: orbax_io.load(p, cfg, len(CHANNELS), dev)[1]
              for what, p in (("one_chunk", one), ("split", grid))}
    split_equal = _state_equal(torch, states["one_chunk"], states["split"])
    smoke.check(split_equal, "orbax split copy: its state on the card differs from the one-chunk "
                             "dir's")
    del states
    load_ms = {"one_chunk": [], "split": []}
    for what, p in (("one_chunk", one), ("split", grid), ("split", grid), ("one_chunk", one)):
        load_ms[what].append(median_ms(lambda p=p: orbax_io.load(p, cfg, len(CHANNELS), dev)))
    report["split"] = {"replicas": SPLIT_REPLICAS, "arrays_split": n_split,
                       "copy_s": copy_s, "equal": split_equal, "load_ms": load_ms}

    # 4. one more epoch from the last .orbax dir, from its split copy, and from the pickle
    resumed = os.path.join(root, "pipeline_resumed")
    shutil.copytree(ref_dir, resumed, ignore=shutil.ignore_patterns("comparisons", "pred*"))
    ref_resumed = Params(_write_params(resumed, total_epochs=3, eval_stack=8, eval_batch=N_EVAL,
                                       seed=0, data_backend="device"))
    orb3 = Params(_write_params(orb.dir_path, total_epochs=3, eval_stack=8, eval_batch=N_EVAL,
                                seed=0, data_backend="device", checkpoint_backend="orbax"))
    split3 = Params(_write_params(split_dir, total_epochs=3, eval_stack=8, eval_batch=N_EVAL,
                                  seed=0, data_backend="device", checkpoint_backend="orbax"))
    secs = {}
    for what, params in (("orbax", orb3), ("pickle", ref_resumed), ("orbax_split", split3)):
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = train_run.run(params, plot=False)
        torch.cuda.synchronize()
        secs[what] = time.perf_counter() - t0
        smoke.check([e["epoch"] for e in out["epochs"]] == [2],
                    f"orbax resume ({what}): epochs {out['epochs']}")
        smoke.check(fns["conv_in_relu_bwd"].launches > 0, f"orbax resume ({what}): no K1b launch")
    epoch2 = ckpt_io.load(os.path.join(orb3.checkpoint_dir_path, f"002.checkpoint{last}"))
    resume_diff = _ckpt_diff(epoch2, ckpt_io.load(os.path.join(ref_resumed.checkpoint_dir_path,
                                                               "002.checkpoint")))
    split_diff = _ckpt_diff(ckpt_io.load(os.path.join(split3.checkpoint_dir_path,
                                                      f"002.checkpoint{last}")), epoch2)
    smoke.check(resume_diff == 0.0, f"orbax resume: epoch 2 differs by {resume_diff}")
    smoke.check(split_diff == 0.0, f"orbax resume from the split copy: epoch 2 differs by "
                                   f"{split_diff} from the one-chunk resume's")
    report["resume"] = {"diff": resume_diff, "split_diff": split_diff, "s": secs}
    print(f"orbax: one more epoch resumed from 001.checkpoint.orbax in {secs['orbax']:.2f} s, "
          f"from the pickle in {secs['pickle']:.2f} s, from the {SPLIT_REPLICAS}-way split copy "
          f"in {secs['orbax_split']:.2f} s; epoch 2 differs by {resume_diff} (pickle) and "
          f"{split_diff} (split copy) on {card}", flush=True)
    print(f"orbax: 001.checkpoint.orbax split as on {SPLIT_REPLICAS} devices ({n_split} of its "
          f"arrays in chunk grids, written in {copy_s:.2f} s): on the card equal bit for bit "
          f"{split_equal}; load {load_ms['split']} ms against the one-chunk dir's "
          f"{load_ms['one_chunk']} ms (medians of 3, in turns; host times on {card})", flush=True)

    # 5. predict and export from the best .orbax, against the pickle's
    best = open(os.path.join(orb.dir_path, "checkpoint_best.txt")).read().split()[1]
    record = "SYN000"
    preds, got = {}, {}
    for what, d in (("orbax", orb.dir_path), ("pickle", ref_dir)):
        for fn in fns.values():
            fn.launches = 0
        smoke.check(cli(["predict", d, record, best]) == 0, f"predict from {what}")
        got[what] = {k: fn.launches for k, fn in fns.items()}
        preds[what] = np.load(os.path.join(d, "predictions", f"{record}.npy"))
        smoke.check(cli(["export", d, best]) == 0, f"export from {what}")
    n = math.ceil(preds["pickle"].size / T)  # the windows of the record's chamber interval
    chunks = math.ceil(n / N_CHUNK)
    want = {k: 0 for k in ALL_KERNELS}
    want.update(conv_in_relu=14 * chunks, normalize_windows=chunks)
    smoke.check(got["orbax"] == want, f"predict from .orbax: launches {got['orbax']}, "
                                      f"expected {want}")
    pred_err = (float(np.abs(preds["orbax"].astype(np.float64) - preds["pickle"]).max())
                if preds["orbax"].shape == preds["pickle"].shape else math.inf)
    smoke.check(preds["orbax"].shape == preds["pickle"].shape and pred_err == 0.0,
                f"predict from .orbax: {preds['orbax'].shape}, max-abs {pred_err} from the pickle")
    exported = [torch.load(os.path.join(d, best + ".torch"), weights_only=False)
                for d in (orb.dir_path, ref_dir)]
    for e in exported:  # each run's own wall-clock start, the one key that may differ
        smoke.check(isinstance(e.pop("start_time", None), float), "export: no start_time")
    export_equal = _export_dict_equal(torch, *exported)
    smoke.check(export_equal, "export from .orbax: the dict differs from the pickle's export")
    report["predict"] = {"record": record, "windows": n, "chunks": chunks, "launches": got,
                         "max_abs_err": pred_err, "export_equal": export_equal}
    print(f"orbax: predict {record} from {best}.orbax ({n} windows, {chunks} chunks): max-abs "
          f"{pred_err} from the pickle's prediction, launches {got['orbax']}; export equal "
          f"{export_equal} on {card}", flush=True)

    # 6. one full checkpoint (the resumed state, on the card): save and load, each backend
    _, state = orbax_io.load(os.path.join(orb3.checkpoint_dir_path, f"002.checkpoint{last}"), cfg,
                             len(CHANNELS), dev)
    io_dir = os.path.join(root, "checkpoint_io")
    os.makedirs(io_dir)
    pkl, orx = os.path.join(io_dir, "pickle.checkpoint"), os.path.join(io_dir, "orbax.checkpoint")
    meta = dict(start_time=0.0, epoch=2, g_losses=[1.0] * 204, d_losses=[1.0] * 1020)

    def async_ms(save):
        call, total = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            save()
            call.append((time.perf_counter() - t0) * 1e3)
            ckpt_io.wait()
            total.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(call), statistics.median(total)

    save = {
        "pickle": lambda block=True: ckpt_io.save(pkl, state=state, cfg=cfg, block=block, **meta),
        "orbax": lambda block=True: orbax_io.save(orx, state=state, block=block, **meta),
    }
    io = {}
    for what in ("pickle", "orbax", "orbax", "pickle"):  # in turns
        rec = io.setdefault(what, {"save_ms": [], "async_call_ms": [], "async_total_ms": []})
        rec["save_ms"].append(median_ms(save[what]))
        call, total = async_ms(lambda: save[what](block=False))
        rec["async_call_ms"].append(call)
        rec["async_total_ms"].append(total)
    io["pickle"]["load_ms"] = median_ms(lambda: ckpt_io.restore(ckpt_io.load(pkl), cfg,
                                                                len(CHANNELS), dev))
    io["orbax"]["load_ms"] = median_ms(lambda: orbax_io.load(orx, cfg, len(CHANNELS), dev))
    io["pickle"]["bytes"] = os.path.getsize(pkl)
    io["orbax"]["bytes"] = _dir_bytes(orx + last)
    raw = sum(v.numel() * v.element_size() for m in (state.generator, state.critic)
              for v in m.state_dict().values()) * 3
    loaded = orbax_io.read(orx + last)
    smoke.check(_ckpt_diff(loaded, ckpt_io.load(pkl)) == 0.0,
                "checkpoint I/O: the two backends' files hold different arrays")
    report["checkpoint_io"] = {"raw_bytes": raw, **io}
    report["seconds"] = time.perf_counter() - t_phase
    print(f"orbax: one full checkpoint ({raw / 1e6:.1f} MB of weights and moments): save "
          f"{io['orbax']['save_ms']} ms (block=False: {io['orbax']['async_call_ms']} ms blocking, "
          f"{io['orbax']['async_total_ms']} ms to durable), load {io['orbax']['load_ms']:.1f} ms, "
          f"{io['orbax']['bytes']} bytes; pickle save {io['pickle']['save_ms']} ms (block=False: "
          f"{io['pickle']['async_call_ms']} ms blocking, {io['pickle']['async_total_ms']} ms), "
          f"load {io['pickle']['load_ms']:.1f} ms, {io['pickle']['bytes']} bytes; "
          f"{report['zstd']}; host times on {card}; the phase {report['seconds']:.1f} s",
          flush=True)
    return report


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
    from scgrhc_torch import native
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

    core = ptxas_lines(build.log)
    for kernel in ("conv_mma_kernel", "conv_stream_kernel", "dx_stream_kernel", "row_kernel",
                   "dw_mma_kernel"):
        recs = {k: v for k, v in core.items()
                if k.startswith(kernel) and k.endswith(f"({LAYER_SOURCE})")}
        regs = [v["registers"] for v in recs.values()]
        spills = {k[len(kernel):]: v["spill_bytes"] for k, v in recs.items() if v["spill_bytes"]}
        print(f"ptxas: {kernel} ({LAYER_SOURCE}.cu): {len(recs)} instances, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
              f"{spills or 'none'}", flush=True)
    # the ptxas lines come with a fresh build only (build.log is empty on reuse)
    smoke.check(not build.log or any(k.startswith("conv_mma_kernel") and
                                     k.endswith(f"({LAYER_SOURCE})") for k in core),
                f"ptxas: no conv_mma_kernel instance from {LAYER_SOURCE}.cu")
    t0 = time.perf_counter()
    wfdb_build = native.build()
    print(f"build: {wfdb_build.path.name} (the C WFDB decoder, host compiler) in "
          f"{wfdb_build.seconds:.2f} s ({time.perf_counter() - t0:.2f} s with load)", flush=True)
    sass = sass_hmma(smoke, build.path)
    k1f = check_conv_in_relu(torch, smoke)
    k4 = check_normalize_windows(torch, smoke)
    k3 = check_gate_normalize(torch, smoke, card)
    k1b = check_conv_in_relu_bwd(torch, smoke)
    k2 = check_critic_layers(torch, smoke)
    gp_vjp = check_gp_vjp(torch, smoke)

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        serve = serve_end_to_end(torch, smoke, os.path.join(root, "serve"), card)
        whole = {"kernel": check_whole_record_k1f(torch, smoke),
                 "serve": continuous_end_to_end(torch, smoke, serve["exp"], card)}
        read = {"build_s": wfdb_build.seconds,
                **record_read(smoke, os.path.join(root, "read"), card, serve["exp"],
                              whole["serve"])}
        train = train_end_to_end(torch, smoke, os.path.join(root, "train"), card)
        pipeline = pipeline_end_to_end(torch, smoke, os.path.join(root, "pipeline"), card)
        artifacts = loader_artifacts(torch, smoke, os.path.join(root, "pipeline"), card)
        calibrated = calibrate_end_to_end(torch, smoke, os.path.join(root, "pipeline"), card)
        int8 = {"products": check_int8_products(torch, smoke, card),
                **int8_end_to_end(torch, smoke, os.path.join(root, "pipeline"), card)}
        traced = trace_training(torch, smoke, os.path.join(root, "trace"), card,
                                write_train_data(os.path.join(root, "trace"))[0],
                                train["ms_per_step"])
        long = {"kernels": check_long_kernels(torch, smoke),
                "serve": serve_long(torch, smoke, os.path.join(root, "long_serve"), card),
                "train": train_long(torch, smoke, os.path.join(root, "long_train"), card)}
        cli_phase = cli_end_to_end(torch, smoke, os.path.join(root, "cli"), card)
        dist = dist_end_to_end(torch, smoke, os.path.join(root, "pipeline"), card, pipeline,
                               serve["exp"])
        orbax = orbax_end_to_end(torch, smoke, os.path.join(root, "pipeline"), card, pipeline)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = [
        {"name": "conv_in_relu", "route": "cuda",
         "source": "scgrhc_torch/csrc/conv_layer.cu",
         "replaces": "scgrhc/ops/pallas/conv_block.py:75",
         "launches": serve["launches"]["conv_in_relu"],
         "max_abs_err": k1f["max_abs_err"], "ms": k1f["ms"],
         "plain_ms": k1f["plain_ms"], "bound_ms": k1f["bound_ms"],
         "bound_by": k1f["bound_by"], "library_ms": None,
         "rate_bound_ms": k1f["rate_bound_ms"],
         "continuous_launches": sum(r["k1f"] for r in whole["serve"]["requests"]),
         "time_sharded": _time_sharded_entry(dist),
         "whole_record": {k: whole["kernel"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "rate_bound_ms", "max_kernel_vs_f64")}},
        {"name": "normalize_windows", "route": "cuda",
         "source": "scgrhc_torch/csrc/normalize_windows.cu",
         "replaces": "scgrhc/ops/pallas/dsp.py:157",
         "launches": serve["launches"]["normalize_windows"],
         "max_abs_err": k4["max_abs_err"], "ms": k4["ms"], "graph_ms": k4["graph_ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
        {"name": "conv_in_relu_bwd", "route": "cuda",
         "source": "scgrhc_torch/csrc/conv_layer.cu",
         "replaces": "scgrhc/ops/pallas/conv_block.py:82", "launches":
         train["launches"]["conv_in_relu_bwd"], "max_abs_err": k1b["max_abs_err"],
         "ms": k1b["ms"], "plain_ms": k1b["plain_ms"], "bound_ms": k1b["bound_ms"],
         "bound_by": k1b["bound_by"], "library_ms": None,
         "rate_bound_ms": k1b["rate_bound_ms"], "dw_rel_err": k1b["dw_rel_err"]},
    ]
    # K2: one critic pass (the 5 layers).  One PyTorch call computes only
    # the linear layer (conv4, 512 -> 1): library_ms is that call's time,
    # beside the kernel's on the same layer (library_layer_ms).
    for name, line in (("critic_layer", 196), ("critic_layer_bwd_dx", 205),
                       ("critic_layer_bwd_dwdb", 222)):
        rec = k2[name]
        lin = next(r for r in rec["per_shape"].values() if r["mode"] == "linear")
        kernels.append({
            "name": name, "route": "cuda", "source": "scgrhc_torch/csrc/conv_layer.cu",
            "replaces": f"scgrhc/ops/pallas/critic_fused.py:{line}",
            "launches": train["launches"][name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": lin["library_ms"],
            "rate_bound_ms": rec["rate_bound_ms"],
            "library_covers": "conv4 (512->1, linear) only", "library_layer_ms": lin["ms"],
            **({"graph_ms": rec["graph_ms"]} if "graph_ms" in rec else {}),
        })
    kernels.append({
        "name": "gate_and_normalize", "route": "cuda",
        "source": "scgrhc_torch/csrc/gate_normalize.cu",
        "replaces": "scgrhc/ops/pallas/dsp.py:39",
        "launches": pipeline.get("launches", {}).get("gate_and_normalize", 0),
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "graph_ms": k3["graph_ms"],
        "floor_graph_ms": k3["floor_graph_ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
    })
    for k in kernels:
        k["status"] = "fail" if smoke.errors else "ok"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "count": count,
                   "build_seconds": build.seconds, "build_log": build.log,
                   "conv_in_relu": k1f, "normalize_windows": k4,
                   "conv_in_relu_bwd": k1b, **k2, "critic_layer_bwd_dx_vjp": gp_vjp,
                   "gate_and_normalize": k3, "sass_hmma": sass,
                   "ptxas_conv_core": core,
                   "serve": serve, "continuous": whole, "calibrate": calibrated, "int8": int8,
                   "train": train, "pipeline": pipeline, "long_windows": long,
                   "loader_artifacts": artifacts, "trace": traced,
                   "cli": cli_phase, "dist": dist, "record_read": read, "orbax": orbax,
                   "errors": smoke.errors}, f, indent=1)
    if smoke.errors:
        print(f"chip_smoke: {len(smoke.errors)} check(s) failed", file=sys.stderr)
        for e in smoke.errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print(json.dumps({"orbax": orbax}, allow_nan=False))
    print(json.dumps({"record_read": read}, allow_nan=False))
    print(card)
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
