"""The control of every cell comes out as not correct: the plain reference,
put in the program's place and computed with TF32 products (the nearest
precision below the float32 the configurations state), fails at least one
of the cell's compared numbers at their limits, at the cell's own size, on
three seeds.  Needs the card:

    python -m pytest -m gpu benchmark/tests/test_bench_control.py -p no:cacheprovider
"""

import tempfile

import pytest

from benchmark.lib import harness, readings
from benchmark.tests.conftest import CELLS

SEEDS = (101, 102, 103)


def fails(checks, limits) -> bool:
    return any(c["value"] > limits[c["name"]]["limit"] for c in checks if c["name"] in limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    man = harness.manifest()
    spec, config, traffic, limits = harness.cell_files(man, cell)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{traffic['driver']}.py", "d")
    for seed in SEEDS:
        with tempfile.TemporaryDirectory() as tmp:
            run = harness.Run(spec, config, traffic, limits, seed, 3.0, False,
                              torch.device("cuda:0"), True, tmp)
            control = readings.train_readings(driver, run, ["control"])["control"]
        assert fails(control, limits), (cell, seed, control)
