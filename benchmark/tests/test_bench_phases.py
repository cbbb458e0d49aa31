"""The readers of the training step's phase metrics: None off the card and
for a program without phase counters; on the card, a span's device
milliseconds over the steps traced."""

from types import SimpleNamespace

import pytest

from benchmark.lib import harness

READERS = {"gp_second_order_ms.train": "gp_second_order",
           "critic_grad_ms.train": "critic_grad",
           "adam_ms.train": "adam"}
TOTALS = {"gp_second_order": {"calls": 60, "device_ms": 240.0},
          "critic_grad": {"calls": 12, "device_ms": 450.0},
          "adam": {"calls": 18, "device_ms": 9.0},
          "train_step": {"calls": 6, "device_ms": 960.0}}


def _read(name, run):
    return harness.read_metric(name, run)


@pytest.fixture()
def fed(monkeypatch):
    from scgrhc_torch.core import trace

    monkeypatch.setattr(trace, "phase_totals", lambda: TOTALS)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_off_the_card(name, fed):
    assert _read(name, SimpleNamespace(on_card=False, traced={"steps": 6})) is None
    assert _read(name, SimpleNamespace(on_card=True, traced={})) is None


@pytest.mark.parametrize("name,span", READERS.items())
def test_reader_divides_by_the_steps_traced(name, span, fed):
    run = SimpleNamespace(on_card=True, traced={"steps": 6})
    assert _read(name, run) == pytest.approx(TOTALS[span]["device_ms"] / 6)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_device_time_or_counters(name, monkeypatch):
    from scgrhc_torch.core import trace

    run = SimpleNamespace(on_card=True, traced={"steps": 6})
    monkeypatch.setattr(trace, "phase_totals", lambda: {"adam": {"calls": 18}})
    assert _read(name, run) is None
    monkeypatch.delattr(trace, "phase_totals")  # the program before the counters
    assert _read(name, run) is None
