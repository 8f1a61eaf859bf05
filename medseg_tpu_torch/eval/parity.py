"""Parity replay: compare produced result CSVs against the reference's
published numbers (reference results/*.csv).

Counterpart of medseg_tpu/eval/parity.py, with the standard library's `csv`
in place of pandas: the same report dict and the same printed lines.  The
JAX package reads the CSVs with pandas, whose default number parser
(`float_precision="high"`, pandas' `precise_xstrtod`) is not correctly
rounded: many 17-digit values land one ulp from Python's `float()`.
`_xstrtod` repeats that parser, so the deltas, `max_abs_delta` and the
tolerance verdict are the JAX package's to the bit.
"""

from __future__ import annotations

import csv
import math
from typing import Callable, Dict, List, Optional, Tuple

_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def _xstrtod(text: str) -> Optional[float]:
    """pandas' precise_xstrtod on one whole field: up to 17 significant
    digits accumulated in a double, then scaled by a power of ten; None
    unless the field is one number (leading and trailing blanks allowed)."""
    s = text.strip()
    n, p = len(s), 0
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
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
        decimals = 0
        while digits < _MAX_DIGITS and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        q = p + 1
        exp_negative = q < n and s[q] == "-"
        if q < n and s[q] in "+-":
            q += 1
        e, e_digits = 0, 0
        while e_digits < _MAX_DIGITS and q < n and s[q].isdigit():
            e = e * 10 + (ord(s[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if exp_negative else e
            p = q
    if p != n:
        return None
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_table(path: str) -> Tuple[List[str], Dict[str, Dict[str, object]]]:
    """(metric columns, {model: {column: value}}) as pandas'
    read_csv(...).set_index("Model") holds them: a column whose every
    filled cell is a number is read by _xstrtod, empty cells are NaN, any
    other column keeps its text."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    key = header.index("Model")
    columns = [c for i, c in enumerate(header) if i != key]
    table: Dict[str, Dict[str, object]] = {r[key]: {} for r in body}
    for i, col in enumerate(header):
        if i == key:
            continue
        cells = [r[i] if i < len(r) else "" for r in body]
        parsed = [_xstrtod(c) if c.strip() else math.nan for c in cells]
        numeric = all(v is not None for v in parsed)
        for r, cell, v in zip(body, cells, parsed):
            table[r[key]][col] = v if numeric else (cell if cell.strip() else math.nan)
    return columns, table


def compare_results_csv(ours_path: str, reference_path: str,
                        tolerance: float = 0.5) -> Dict:
    """Row-by-row metric deltas (percentage points).  Returns a report dict:
    {model: {metric: (ours, ref, delta)}, 'max_abs_delta': float,
     'within_tolerance': bool, 'missing_models': [...]}."""
    ours_cols, ours = _read_table(ours_path)
    ref_cols, ref = _read_table(reference_path)
    report: Dict = {"models": {}, "missing_models": [], "extra_models": []}
    max_delta = 0.0
    for model in ref:
        if model not in ours:
            report["missing_models"].append(model)
            continue
        row: Dict = {}
        for metric in ref_cols:
            if metric not in ours_cols:
                continue
            o = float(ours[model][metric])
            r = float(ref[model][metric])
            d = o - r
            row[metric] = (o, r, d)
            max_delta = max(max_delta, abs(d))
        report["models"][model] = row
    report["extra_models"] = [m for m in ours if m not in ref]
    report["max_abs_delta"] = max_delta
    report["within_tolerance"] = (max_delta <= tolerance
                                  and not report["missing_models"])
    return report


def format_parity_report(report: Dict, log: Callable[[str], None] = print):
    log(f"{'Model':<16} {'Metric':<16} {'Ours':>8} {'Ref':>8} {'Delta':>8}")
    log("-" * 60)
    for model, metrics in report["models"].items():
        for metric, (o, r, d) in metrics.items():
            log(f"{model:<16} {metric:<16} {o:>8.3f} {r:>8.3f} {d:>+8.3f}")
    if report["missing_models"]:
        log(f"MISSING: {report['missing_models']}")
    log(f"max |delta| = {report['max_abs_delta']:.3f} pp; "
        f"within tolerance: {report['within_tolerance']}")
