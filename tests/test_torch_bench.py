"""The port's bench (``python -m scgrhc_torch.bench``) on the CPU at tiny
sizes (windows of 32 samples, a few windows, a short timed window).

  * Each mode prints exactly one JSON line whose keys are those the root
    ``bench.py`` emits for the same mode, read from its ``_emit`` calls
    (with the conditional extras of ``--mode inference`` all switched on),
    plus ``device`` and ``power_limit``; its metric and unit are
    ``bench.py``'s (``kernels`` is ``--mode pallas``'s counterpart:
    ``cuda_gate_normalize``, and ``stream_norm_speedup`` for
    ``stream_norm_pallas_speedup``); its value is finite and positive.
  * Each refused flag raises with its reason.
  * Without a card and without ``--device cpu`` the bench raises, in
    process and as ``python -m scgrhc_torch.bench``.
  * ``step_conv_flops`` against a count of the same passes written out
    from the layer widths.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scgrhc_torch.bench import run as bench
from scgrhc_torch.train.wgan import TrainConfig

ROOT = Path(__file__).resolve().parents[1]
BASE = ["metric", "value", "unit", "vs_baseline"]
# the port's mode → bench.py's function, and the keys renamed on the way
JAX_MODE = {"inference": "run_inference", "train": "run_train",
            "train-torch": "run_train_torch_baseline", "eval": "run_eval",
            "stream": "run_stream", "data": "run_data", "kernels": "run_pallas"}
RENAMED = {"pallas_gate_normalize": "cuda_gate_normalize",
           "stream_norm_pallas_speedup": "stream_norm_speedup"}


def _jax_lines() -> dict:
    """Per bench.py mode function: (metric, unit, keys) of its ``_emit``,
    with the keys of an ``extra`` dict it builds and splats."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in JAX_MODE.values():
            continue
        extra = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "extra" for t in node.targets):
                extra += [k.value for d in ast.walk(node.value) if isinstance(d, ast.Dict)
                          for k in d.keys]
            if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name) and node.value.id == "extra"):
                extra.append(node.slice.value)
        call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name) and n.func.id == "_emit")
        keys = [k.arg for k in call.keywords if k.arg] + (
            extra if any(k.arg is None for k in call.keywords) else [])
        out[fn.name] = (call.args[0].value, call.args[2].value, BASE + keys)
    return out


JAX_LINES = _jax_lines()

# tiny sizes on the CPU; inference with every conditional extra of bench.py
# (dtype, batch, timing) switched on
MODE_ARGS = {
    "inference": ["--infer-batch", "2", "--depth", "0", "--dtype", "bfloat16"],
    "train": ["--batch", "2", "--nb", "2"],
    "train-torch": ["--batch", "2"],
    "eval": ["--ckpts", "2", "--segments", "3", "--eval-batch", "2"],
    "stream": ["--minutes", "0.02"],
    "data": [],
    "kernels": [],
}


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(bench, "T", 32)
    monkeypatch.setattr(bench, "DATA_RECORDS", 1)
    monkeypatch.setattr(bench, "DATA_SECONDS", 30.0)
    monkeypatch.setattr(bench, "BASELINE_WINDOWS", 2)
    monkeypatch.setattr(bench, "TIMED_S", 0.01)
    monkeypatch.setattr(bench, "TIMED_EPOCH_S", 0.01)


def test_bench_py_lines_are_read():
    assert set(JAX_LINES) == set(JAX_MODE.values())
    assert JAX_LINES["run_inference"][2] == BASE + ["dtype", "batch", "timing"]
    assert "ms_per_step" in JAX_LINES["run_train"][2]


@pytest.mark.parametrize("mode", list(MODE_ARGS))
def test_each_mode_prints_bench_py_line(tiny, capsys, mode):
    line = bench.main(["--mode", mode, "--device", "cpu", *MODE_ARGS[mode]])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    metric, unit, keys = JAX_LINES[JAX_MODE[mode]]
    assert (line["metric"], line["unit"]) == (RENAMED.get(metric, metric), unit)
    assert list(line) == [RENAMED.get(k, k) for k in keys] + ["device", "power_limit"]
    assert line["device"] == "cpu" and line["power_limit"] is None
    assert isinstance(line["value"], float) and math.isfinite(line["value"]) and line["value"] > 0


@pytest.mark.parametrize("mode", ["stream", "train"])
@pytest.mark.parametrize("variant", [0, 1])
def test_mode_variants(tiny, capsys, mode, variant):
    """The stream mode's ``--adc`` and ``--device-resident`` paths, and the
    train mode's step loop with the fused critic and the shared prediction."""
    extra = {("stream", 0): ["--minutes", "0.02", "--adc"],
             ("stream", 1): ["--minutes", "0.02", "--device-resident"],
             ("train", 0): ["--batch", "2", "--loop", "step", "--fuse", "3b", "--reuse-pred"],
             ("train", 1): ["--batch", "2", "--loop", "step", "--fuse", "2b"]}[mode, variant]
    line = bench.main(["--mode", mode, "--device", "cpu", *extra])
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    assert line["value"] > 0
    if mode == "stream":
        assert line["mode"] == ("windowed-adc", "device-resident")[variant]
    else:
        assert (line["loop"], line["fuse"]) == ("step", extra[5])


@pytest.mark.parametrize("mode,flags", [("inference", ["--infer-batch", "2", "--depth", "1"]),
                                        ("eval", ["--ckpts", "2", "--segments", "3",
                                                  "--eval-batch", "2"]),
                                        ("stream", ["--minutes", "0.02", "--continuous"])])
def test_int8_and_continuous_lines(tiny, capsys, mode, flags):
    """``--dtype int8`` in the inference and eval modes and ``--mode stream
    --continuous`` run, and print bench.py's line for the mode (bench.py
    runs the same flags through scgrhc.models.quant and scgrhc.models.cp)."""
    if mode != "stream":
        flags = [*flags, "--dtype", "int8"]
    line = bench.main(["--mode", mode, "--device", "cpu", *flags])
    assert len(capsys.readouterr().out.strip().splitlines()) == 1
    metric, unit, keys = JAX_LINES[JAX_MODE[mode]]
    assert (line["metric"], line["unit"]) == (metric, unit)
    extra = {"inference": ["dtype", "batch"], "eval": [], "stream": []}[mode]
    base = [k for k in keys if k not in ("dtype", "batch", "timing")] if mode == "inference" \
        else keys
    assert list(line) == base + extra + ["device", "power_limit"]
    assert math.isfinite(line["value"]) and line["value"] > 0
    if mode == "inference":
        assert line["dtype"] == "int8"
    if mode == "stream":
        assert line["mode"] == "continuous"


@pytest.mark.parametrize("argv,why", [
    (["--conv-backend", "pallas"], "K1f/K1b"),
    (["--critic-backend", "fused"], "K2f/K2dx/K2dw"),
    (["--remat"], "rematerialisation"),
    (["--compile-budget", "60"], "nvcc"),
    (["--rng-impl", "rbg"], "threefry"),
    (["--mode", "train", "--dtype", "int8"], "inference-only"),
    (["--mode", "eval", "--continuous"], "whole-record"),
    (["--mode", "eval", "--stack", "8"], "one checkpoint at a time"),
])
def test_refused_flags_say_why(argv, why):
    with pytest.raises(SystemExit, match=why):
        bench.main([*argv, "--device", "cpu"])


def test_no_card_no_cpu_flag_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "kernels"])
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "scgrhc_torch.bench", "--mode", "kernels"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr


@pytest.mark.parametrize("cfg", [TrainConfig(), TrainConfig(n_critic=5, reuse_pred=True),
                                 TrainConfig(fix_g_adversarial=True, critic_fuse="3b")])
def test_step_conv_flops_from_the_layer_widths(cfg):
    t, b, c = 750, 4, bench.IN_CHANNELS

    def conv(cin, cout, k, length):
        return 2 * b * length * cin * cout * k

    gen = sum(conv(ci, co, 3, L) + conv(co, co, 3, L) for ci, co, L in (
        (c, 64, t), (64, 128, t - 2), (128, 256, t - 4), (256, 512, t - 6),
        (512, 256, t - 4), (256, 128, t - 2), (128, 64, t)))
    gen += sum(conv(ci, co, 3, L) for ci, co, L in (
        (512, 256, t - 6), (256, 128, t - 4), (128, 64, t - 2)))  # up3, up2, up1
    gen += sum(conv(f, f // 2, 1, L) * 2 + conv(f // 2, 1, 1, L) for f, L in (
        (256, t - 4), (128, t - 2), (64, t)))  # att3, att2, att1: W_x, W_g, psi
    gen += conv(64, 1, 1, t)  # final
    critic = sum(conv(ci, co, 3, t) for ci, co in (
        (c + 1, 64), (64, 128), (128, 256), (256, 512), (512, 1)))
    g_fwd = 1 if cfg.reuse_pred else cfg.n_critic + 1
    want = (g_fwd + 2) * gen + (12 * cfg.n_critic + 1 + cfg.fix_g_adversarial) * critic
    assert bench.step_conv_flops(cfg, b, t) == pytest.approx(want, rel=1e-12)
