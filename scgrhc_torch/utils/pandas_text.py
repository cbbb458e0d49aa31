"""pandas' text formats, written without pandas (the card's machine has
none), for the host-side stages whose output ``scgrhc`` makes with pandas:

  * :func:`read_float`: a float field as ``pd.read_csv`` parses it (its C
    parser's default converter, which is not Python's ``float``);
  * :func:`frame_text`: ``DataFrame.to_string(index=False)`` of str, float
    and int columns;
  * :func:`int_series_text`: ``repr`` of an int64 ``Series`` with a string
    index.

The comparison CSVs and ``checkpoint_scores.csv`` are written by
``eval.run.write_csv`` and ``Series.to_string()`` by
``select.run.series_text``.  ``tests/test_torch_cli_stages.py`` and
``tests/test_torch_summary.py`` hold each one to pandas.
"""

from __future__ import annotations

import math
import re

_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def read_float(s: str) -> float:
    """``pd.read_csv``'s value of a float field: pandas' ``precise_xstrtod``,
    which folds at most 17 digits into a double, digit by digit, then
    scales by one power of ten; an empty field is NaN.  Python's
    ``float`` rounds correctly, so a ``repr``-written double can parse
    one ulp apart."""
    s = s.strip()
    p, n = 0, len(s)
    neg = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    if p == n or not (s[p].isdigit() or s[p] == "."):
        return float(s) if s else math.nan  # inf, nan
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while p < n and s[p].isdigit():
            if digits < _MAX_DIGITS:
                number = number * 10.0 + (ord(s[p]) - 48)
                digits += 1
                exponent -= 1
            p += 1
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        m = re.match(r"[eE]([+-]?)(\d{1,17})", s[p:])
        if m:
            exponent += -int(m.group(2)) if m.group(1) == "-" else int(m.group(2))
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


_DECIMAL = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _trim_zeros(strs: list[str]) -> list[str]:
    """Cut the trailing zeros every fixed-point string has, keeping one
    digit after the point (pandas' ``_trim_zeros_float``)."""
    def trim(values):
        nums = [x for x in values if _DECIMAL.match(x)]
        return bool(nums) and all(x.endswith("0") for x in nums)

    while trim(strs):
        strs = [x[:-1] if _DECIMAL.match(x) else x for x in strs]
    return [x + "0" if _DECIMAL.match(x) and x.endswith(".") else x for x in strs]


def _float_strs(values: list[float], digits: int = 6) -> list[str]:
    """A float column as pandas formats it: fixed point to ``digits``
    decimals with the column's common trailing zeros cut, or the whole
    column in ``%.{digits}e`` when a value is nonzero below 10**-digits,
    or is above 1e6 while a string runs past digits + 6 characters."""
    def fmt(spec):
        return _trim_zeros(["NaN" if v != v else format(v, spec) for v in values])

    out = fmt(f".{digits}f")
    too_long = max(map(len, out), default=0) > digits + 6
    mags = [abs(v) for v in values if v == v]
    large = any(a > 1e6 for a in mags)
    small = any(0 < a < 10 ** (-digits) for a in mags)
    return fmt(f".{digits}e") if small or (too_long and large) else out


def frame_text(columns: list[str], rows: list[dict]) -> str:
    """``pd.DataFrame(rows, columns=columns).to_string(index=False)`` for
    columns whose values are all str, all float or all int: each column
    right-justified to its widest cell, numeric headers after one space,
    columns one space apart."""
    cols = []
    for c in columns:
        vals = [r[c] for r in rows]
        if all(isinstance(v, float) for v in vals):
            strs, head = _float_strs(vals), " " + c
        elif all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
            strs, head = [f"{v:d}" for v in vals], " " + c
        else:
            strs, head = [str(v) for v in vals], c
        width = max([len(head)] + [len(s) for s in strs])
        cols.append([head.rjust(width)] + [s.rjust(width) for s in strs])
    return "\n".join(" ".join(line) for line in zip(*cols))


def int_series_text(items: list[tuple[str, int]], max_rows: int = 60,
                    min_rows: int = 10) -> str:
    """``repr(pd.Series(dict(items)))`` for int64 values: labels
    left-justified, each value after a space and right-justified, three
    spaces between, ``dtype: int64`` below; past ``max_rows`` the first and
    last ``min_rows // 2`` rows around a ``...`` row, with the length."""
    if not items:
        return "Series([], dtype: int64)"
    shown = items
    if len(items) > max_rows:
        half = min_rows // 2
        shown = items[:half] + items[-half:]
    labels = [str(k) for k, _ in shown]
    vals = [f" {v:d}" for _, v in shown]
    wv = max(map(len, vals))
    vals = [v.rjust(wv) for v in vals]
    if len(shown) < len(items):
        labels.insert(half, "")
        vals.insert(half, ("..." if wv > 3 else "..").center(wv))
    wl = max(map(len, labels))
    lines = [f"{k.ljust(wl)}   {v}" for k, v in zip(labels, vals)]
    foot = f"Length: {len(items)}, dtype: int64" if len(shown) < len(items) else "dtype: int64"
    return "\n".join(lines + [foot])
