"""The port's cohort summary (``scgrhc_torch.summary``, no pandas) against
``scgrhc.summary.main()``: its standard output byte for byte on synthetic
databases of 6 records, 3 per gender, with NaN in continuous columns and
a missing-values Series, and with nothing missing; ``int_series_text``
against pandas' Series repr on random input.
"""

import contextlib
import io
import json
import os
import random
import re

import numpy as np
import pandas as pd
import pytest

from scgrhc import summary as jsummary
from scgrhc.core import paths as jpaths
from scgrhc_torch import summary
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.utils.pandas_text import int_series_text
from scgrhc_torch.utils.synth import make_synthetic_database


def _edit(db: str, record: str, **changes) -> None:
    path = os.path.join(db, f"{record}.json")
    with open(path) as f:
        side = json.load(f)
    maclab = changes.pop("maclabMeas", {})
    side.update(changes)
    side["maclabMeas"].update(maclab)
    with open(path, "w") as f:
        json.dump(side, f)


@pytest.fixture(params=["missing_values", "nothing_missing"])
def cohort(request, tmp_path, monkeypatch):
    """6 synthetic 8-s records, both packages pointed at them.  The first
    record already has ``sbp: -1`` and a string maclab value; the
    "missing_values" case adds another of each (and drops a key from one
    sidecar), the other fills them in."""
    db = make_synthetic_database(str(tmp_path / "db"), n_records=6, duration_s=8.0)
    if request.param == "missing_values":
        _edit(db, "SYN003", sbp=-1, maclabMeas={"PAM": "pending"})
        path = os.path.join(db, "SYN004.json")
        side = json.load(open(path))
        del side["NYHAC"]
        json.dump(side, open(path, "w"))
    else:
        _edit(db, "SYN000", sbp=120, maclabMeas={"RVS": 31.5})
    for mod in (jpaths, tpaths):
        monkeypatch.setattr(mod, "DATA_PATH", os.path.dirname(db))
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH", db)
    return request.param


def _stdout(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_summary_is_scgrhcs_stdout(cohort):
    want = _stdout(jsummary.main)
    got = _stdout(summary.main)
    assert got == want
    for section in ("----- All -----", "----- Male -----", "----- Female -----"):
        assert section in got
    assert "  Sig " in got and "bmi\n" in got
    if cohort == "missing_values":
        assert re.search(r"Missing vals:\nsbp +2\n", got) and re.search(r"\nNYHAC +1\n", got)
    else:
        assert got.count("Missing vals:\nSeries([], dtype: int64)") == 3


def test_summary_cli(cohort, capsys):
    assert cli(["summary"]) == 0
    assert "----- Female -----" in capsys.readouterr().out


def test_modified_maclab_meas_matches_jax():
    meas = {" PAS": 33.0, "RVS ": "n/a", "PAM": 21}
    got, want = summary.get_modified_maclab_meas(meas), jsummary.get_modified_maclab_meas(meas)
    assert list(got) == list(want) == ["PAS", "RVS", "PAM"]
    assert got["PAS"] == 33.0 and np.isnan(got["RVS"]) and got["PAM"] == 21


@pytest.mark.parametrize("seed", range(3))
def test_int_series_text_is_pandas_repr(seed):
    r = random.Random(seed)
    for n in [0, 1, 60, 61, 75] + [r.randint(2, 59) for _ in range(30)]:
        items = [(r.choice(["sbp", "PCWA Wave", "x", "TDCIL/min/m^2"]) + str(i),
                  r.randint(1, 10 ** r.randint(0, 7))) for i in range(n)]
        want = repr(pd.Series(dict(items), dtype="int64"))
        assert int_series_text(items) == want
