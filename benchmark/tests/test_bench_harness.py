"""The harness: the manifest against the contract, files found by name, the
frozen counts, a CPU dry run of every cell, the refusals, and ``correct``
coming out false with the timed path broken underneath."""

import ast
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.lib import faults, flops, harness
from benchmark.reference import model
from benchmark.tests.conftest import CELLS, SHRINK

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def dry_run(cell, capsys, seed=4_000_000_123, trace=0, seconds=2):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], allow_cpu=True, shrink=SHRINK)
    out, err = capsys.readouterr()
    return rc, out, err


def test_manifest_keeps_to_the_contract():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"] and man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in man[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
        conf = harness.load_json(ROOT / c["file"])
        assert set(c["reduced"]) == set(conf["reduced"])
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in man["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        layer = [m for m in man["per_layer"] if harness.applies(m, w["name"], man)]
        assert layer and all(harness.applies(e2e[m["moves"]], w["name"]) for m in layer)
    assert len(json.dumps(man)) < 64 * 1024


def test_files_are_found_by_name():
    man = harness.manifest()
    for w in man["workloads"]:
        cell, config, traffic, limits = harness.cell_files(man, w["name"])
        assert config["name"] == w["config"]
        assert callable(harness.driver_class(traffic))
        assert limits and all("limit" in v for v in limits.values())
    for m in man["per_layer"]:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py", "m")
        assert (mod.LAYER, mod.SOURCE, mod.MOVES) == (m["layer"], m["source"], m["moves"])
        assert callable(mod.read)


def test_frozen_counts():
    assert flops.generator_pass_flops(3, 750) == pytest.approx(4.378e9, rel=1e-3)
    assert flops.step_conv_flops(3, 64, 750, 2) == pytest.approx(2.645e12, rel=1e-3)
    assert flops.step_conv_flops(3, 16, 750, 2) == pytest.approx(0.661e12, rel=1e-3)
    assert sum(math.prod(s) for _, s, _ in model.generator_shapes(3)) == 2_941_412
    assert sum(math.prod(s) for _, s, _ in model.critic_shapes(3)) == 519_361
    kinds = [x.kind for x in flops.train_step_launches(3, 64, 750, 2)]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "K1f": 42, "K1b": 14, "K2f": 35, "K2dx": 32, "K2dw": 28}
    # the 14 layers of a 512-window chunk at the 3xTF32 rate
    assert sum(x.least_seconds for x in flops.k1f_launches(3, 512, 750)) == pytest.approx(
        10.833e-3, rel=1e-3)


def test_frozen_counts_match_the_programs():
    """The yardstick's counts equal the port's bench and launch counter."""
    from scgrhc_torch.bench.run import step_conv_flops
    from scgrhc_torch.train.wgan import TrainConfig, launches_per_step

    cfg = TrainConfig(n_critic=2)
    assert flops.step_conv_flops(3, 16, 750, 2) == pytest.approx(step_conv_flops(cfg, 16, 750, 3))
    kinds = [x.kind for x in flops.train_step_launches(3, 16, 750, 2)]
    names = {"K1f": "conv_in_relu", "K1b": "conv_in_relu_bwd", "K2f": "critic_layer",
             "K2dx": "critic_layer_bwd_dx", "K2dw": "critic_layer_bwd_dwdb"}
    assert {names[k]: kinds.count(k) for k in names} == launches_per_step(cfg)


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_one_result_line(cell, capsys):
    rc, out, err = dry_run(cell, capsys)
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["device"]["platform"] == "cpu" and result["attempted"] > 0
    assert result["correct"] is True
    man = harness.manifest()
    want = {m["name"] for m in man["end_to_end"] if harness.applies(m, cell)}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and "limit" in line for line in last)


def test_traced_dry_run_leaves_out_device_metrics(capsys):
    """On the CPU no device metric is reported: its readers find nothing."""
    rc, out, _ = dry_run("train.w06", capsys, trace=1)
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["metrics"] == {} and "busy_s" not in result["device"]


def test_no_card_no_result(capsys):
    rc = harness.main(["--workload", "train.w06", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "cuda" in err.lower()


def test_a_folder_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.w06",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU dry run, in a fresh process, loads no module whose
    top-level name is jax, jaxlib, flax or scgrhc."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.lib import harness, gpu\n"
        "from benchmark.tests.conftest import CELLS, SHRINK\n"
        "for cell in CELLS:\n"
        "    assert harness.main(['--workload', cell, '--seed', '7', '--seconds', '1'],\n"
        "                        allow_cpu=True, shrink=SHRINK) == 0\n"
        "print('FORBIDDEN', gpu.forbidden_modules())\n"
    ) % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FORBIDDEN []" in proc.stdout


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark.lib import gpu

    monkeypatch.setitem(sys.modules, "scgrhc_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert gpu.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scgrhc.sub", sys)
    assert gpu.forbidden_modules() == ["scgrhc.sub"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "scgrhc"}, path
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert not _imports(path) & {"scgrhc_torch"}, path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.model, benchmark.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'scgrhc_torch', 'scgrhc', 'jax'}))\n") % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.TRAIN)
def test_a_broken_timed_path_is_not_correct(cell, fault, capsys):
    """The rest of a run, past the look for a card, with the timed path
    broken underneath: ``correct`` comes out false where the sound run's is
    true."""
    rc, out, _ = dry_run(cell, capsys, seed=99)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["correct"] is True
    with faults.train_fault(fault):
        rc, out, _ = dry_run(cell, capsys, seed=99)
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is False
