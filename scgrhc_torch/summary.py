"""Cohort statistics report, the port's copy of ``scgrhc.summary``
(reference parity: summary.py).

Merges each record's sidecar demographics and maclab measurements
(summary.py:11-33), flags channel presence per record (:36-49), sums each
chamber's catheter dwell time (:52-65), and prints min/max/mean±sd/sum with
male-vs-female tests (t-test for continuous variables, rank-sum for NYHA
class), boolean counts, missing values and BMI, for the whole cohort and
per gender (:68-189).  Variables absent from every sidecar are noted
instead of raising, as in ``scgrhc``.

``scgrhc`` holds the records in a pandas DataFrame; the port keeps a list
of row dicts and one NumPy array per column, typed as pandas types it
(int64, float64 with NaN, bool, else object), and reproduces pandas'
NaN-skipping statistics and printed text.  The tests come from a lazy
``scipy.stats`` import, as in ``scgrhc``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from scgrhc_torch.core import paths
from scgrhc_torch.io.catalog import SAMPLE_FREQ, get_record_names, read_record
from scgrhc_torch.io.sidecar import get_chamber_intervals
from scgrhc_torch.utils.pandas_text import int_series_text

CHAMBERS = ("RA", "RV", "PA", "PCW")

CONTINUOUS_VARS = [
    "age", "bmi", "sbp", "dbp", "RA", "RV", "PA", "PCW",
    "RAA Wave", "RAV Wave", "RAM", "RAHR",
    "RVS", "RVD", "RVEDP", "RVHR",
    "PAS", "PAD", "PAM", "PAHR",
    "PCWA Wave", "PCWV Wave", "PCWM", "PCWHR",
    "Fick COL/min", "TDCOL/min", "TDCIL/min/m^2", "Avg. COmL/min",
    "SVmL/beat",
]

BOOLEAN_VARS = [
    "Missing_MaclabRHC", "fine_alignment", "outpatient",
    "patch_ECG", "patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv",
    "patch_Hum", "patch_Pre", "patch_Temp",
    "RHC_pressure", "ART",
    "ECG_lead_I", "ECG_lead_II", "ECG_lead_III", "aVR", "aVL", "aVF",
    "ECG_lead_V1", "ECG_lead_V2", "ECG_lead_V3", "ECG_lead_V4",
    "ECG_lead_V5", "ECG_lead_V6", "PLETH", "RESP",
]


def get_modified_maclab_meas(original: dict) -> dict:
    """Strip key whitespace; string values (unparseable measurements)
    become NaN (reference: summary.py:11-18)."""
    return {key.strip(): np.nan if isinstance(val, str) else val
            for key, val in original.items()}


def get_df() -> dict:
    """record_name → merged sidecar row (reference: summary.py:22-33)."""
    df = {}
    for record_name in get_record_names():
        path = os.path.join(paths.PROCESSED_DATA_PATH, f"{record_name}.json")
        with open(path, "r") as f:
            data = json.load(f)
        data["record_name"] = record_name
        if "sbp" in data:
            data["sbp"] = np.nan if data["sbp"] == -1 else data["sbp"]
        if "dbp" in data:
            data["dbp"] = np.nan if data["dbp"] == -1 else data["dbp"]
        data.update(get_modified_maclab_meas(data.get("maclabMeas", {})))
        df[record_name] = data
    return df


def add_signal_presence(df: dict) -> None:
    """Boolean column per channel name seen anywhere in the cohort
    (reference: summary.py:36-49)."""
    record_names = list(df.keys())
    records = [read_record(name) for name in record_names]
    signal_names = set().union(*(r.sig_name for r in records))
    for record_name, record in zip(record_names, records):
        for signal_name in signal_names:
            df[record_name][signal_name] = signal_name in record.sig_name


def add_chamber_durations(df: dict) -> None:
    """Per-chamber catheter dwell time in seconds
    (reference: summary.py:52-65)."""
    for record_name in df.keys():
        for chamber in CHAMBERS:
            total = 0.0
            for start, end in get_chamber_intervals(record_name, chamber):
                total += (end - start) / SAMPLE_FREQ
            df[record_name][chamber] = total


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _column(values: list) -> np.ndarray:
    """A column typed as pandas types one built from these values."""
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.array(values, dtype=bool)
    real = [v for v in values if not _is_na(v)]
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in real):
        if len(real) == len(values) and all(isinstance(v, (int, np.integer)) for v in real):
            return np.array(values, dtype=np.int64)
        return np.array([np.nan if _is_na(v) else v for v in values], dtype=np.float64)
    col = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):  # element by element: a list value stays one cell
        col[i] = v
    return col


def _frame(rows: list[dict]) -> dict:
    """The columns of a DataFrame built from a list of dicts: in order of
    first appearance, a missing key NaN, each column one array."""
    names = {}
    for row in rows:
        names.update(dict.fromkeys(row))
    return {c: _column([row.get(c, np.nan) for row in rows]) for c in names}


def _where(df: dict, var: str, value) -> dict:
    """The rows whose ``var`` equals ``value``, every column's type kept."""
    keep = df[var] == value
    return {c: col[keep] for c, col in df.items()}


# NOTE: every printed line below is a byte-level parity contract with the
# reference report (reference: summary.py:68-92).


def _stats(col: np.ndarray) -> tuple:
    """(min, max, mean, std with ddof 1, sum) skipping NaN, as pandas'
    nanops compute them: the sum over the column with NaN as 0, the mean
    that sum over the count, the variance in two passes; min and max NaN
    when no value is left, std NaN below two values, the sum 0 with none."""
    x = col.astype(np.float64)
    mask = np.isnan(x)
    n = int((~mask).sum())
    filled = np.where(mask, 0, col)
    lo, hi = (col[~mask].min(), col[~mask].max()) if n else (np.nan, np.nan)
    mean = filled.sum(dtype=np.float64) / n if n else np.nan
    sqr = np.where(mask, 0.0, (mean - x) ** 2)
    std = np.sqrt(sqr.sum(dtype=np.float64) / (n - 1)) if n > 1 else np.nan
    return lo, hi, mean, std, filled.sum()


def summarize_continuous(df: dict, var: str, gender_stratified: bool) -> None:
    from scipy.stats import ttest_ind

    if var not in df:
        print(f"{var}\n  (absent)")
        return
    lo, hi, mean, std, total = _stats(df[var])
    lines = [
        var,
        f"  Min {lo:.2f}",
        f"  Max {hi:.2f}",
        f"  Avg {mean:.2f} ± {std:.2f}",
        f"  Sum {total:.2f}",
    ]
    if not gender_stratified and "gender" in df:
        stat = ttest_ind(_where(df, "gender", "Male")[var], _where(df, "gender", "Female")[var],
                         nan_policy="omit")
        lines.append(f"  Sig {stat.pvalue:.2f}")
    print("\n".join(lines))


def _count(col: np.ndarray, value):
    """``col.value_counts().get(value)``: None when the value is absent."""
    n = sum(1 for v in col if not _is_na(v) and v == value)
    return n or None


def summarize_boolean(df: dict, var: str) -> None:
    if var not in df:
        print(f"{var}\n  (absent)")
        return
    col = df[var]
    print("\n".join([var, f"  Y {_count(col, True)}", f"  N {_count(col, False)}"]))


def show_missing_vals(df: dict) -> None:
    """``print(na_counts[na_counts > 0])`` of the frame's NaN counts."""
    counts = [(c, sum(_is_na(v) for v in col)) for c, col in df.items()]
    print("Missing vals:")
    print(int_series_text([(c, n) for c, n in counts if n > 0]))


def summarize(df: dict, gender_stratified: bool) -> None:
    from scipy.stats import ranksums

    for var in CONTINUOUS_VARS:
        summarize_continuous(df, var, gender_stratified)
    for var in BOOLEAN_VARS:
        summarize_boolean(df, var)

    if "NYHAC" in df:
        print("NYHAC")
        for c in (1, 2, 3, 4):
            print(f"  {c} {_count(df['NYHAC'], c)}")
        if not gender_stratified and "gender" in df:
            _, p_value = ranksums(_where(df, "gender", "Male")["NYHAC"],
                                  _where(df, "gender", "Female")["NYHAC"], nan_policy="omit")
            print(f"  Sig {p_value}")

    show_missing_vals(df)


def main() -> None:
    df = get_df()
    add_signal_presence(df)
    add_chamber_durations(df)
    df = _frame(list(df.values()))
    if {"weight", "height"} <= set(df):
        df["bmi"] = df["weight"] / ((df["height"] / 100) ** 2)

    print("\n----- All -----")
    summarize(df, gender_stratified=False)

    if "gender" in df:
        print("\n----- Male -----")
        summarize(_where(df, "gender", "Male"), gender_stratified=True)
        print("\n----- Female -----")
        summarize(_where(df, "gender", "Female"), gender_stratified=True)


if __name__ == "__main__":
    main()
