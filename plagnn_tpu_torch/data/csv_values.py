"""The CSV value semantics of pandas' defaults, on the ``csv`` module.

The JAX package reads the expression CSVs with ``pd.read_csv`` and types
the GEO series matrix with ``pd.to_numeric(errors="coerce")``; the card's
machine has no pandas, so the port reads the same text with these rules:

* a field equal to one of pandas' default NA strings is missing;
* a float is parsed as pandas' C parser parses it by default (its
  ``precise_xstrtod``: at most 17 significant digits accumulated in a
  double, then one multiply or divide by a power of ten), which is not
  always the correctly rounded value that ``float()`` gives;
* a column whose fields are all integers, none missing, is int64;
  otherwise float64;
* a float64 is written as numpy's ``astype(str)`` writes it (the shortest
  repr) and a missing value as an empty field, as ``to_csv`` does.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional

import numpy as np

# pandas._libs.parsers.STR_NA_VALUES
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_POW10 = [float(f"1e{i}") for i in range(309)]
_FLOAT = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?)(\d+))?\s*\Z")
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_INF = {"inf": 1.0, "+inf": 1.0, "-inf": -1.0, "infinity": 1.0, "+infinity": 1.0,
        "-infinity": -1.0}
_MAX_DIGITS = 17


def parse_float(token: str) -> float:
    """pandas' default float parser; ValueError where it fails."""
    m = _FLOAT.match(token)
    if m is None or not (m.group(2) or m.group(3)):
        sign = _INF.get(token.strip().lower())
        if sign is None:
            raise ValueError(f"not a number: {token!r}")
        return sign * float("inf")
    sign, int_part, frac_part, exp_sign, exp_digits = m.groups()
    number, exponent, digits = 0.0, 0, 0
    for ch in int_part:
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac_part or "")[:max(_MAX_DIGITS - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    if exp_digits:
        e = int(exp_digits[:_MAX_DIGITS])
        exponent += -e if exp_sign == "-" else e
    if exponent > 308:
        return number * float("inf") if number else number
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return number * 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _int_or_none(token: str) -> Optional[int]:
    return int(token) if _INT.match(token) else None


def numeric_column(tokens: Iterable[str], coerce: bool) -> np.ndarray:
    """int64 where every field is an integer and none is missing, else
    float64 with NaN for missing fields.  A field that is neither raises,
    unless ``coerce`` (``to_numeric(errors="coerce")``): then it is NaN."""
    tokens = list(tokens)
    ints = [None if t in NA_STRINGS else _int_or_none(t) for t in tokens]
    if all(v is not None for v in ints):
        if any(not -2**63 <= v < 2**63 for v in ints):
            raise ValueError("an integer column outside int64")
        return np.array(ints, np.int64)
    out = np.empty(len(tokens), np.float64)
    for i, t in enumerate(tokens):
        if t in NA_STRINGS:
            out[i] = np.nan
        else:
            try:
                out[i] = parse_float(t)
            except ValueError:
                if not coerce:
                    raise
                out[i] = np.nan
    return out


def format_column(values: np.ndarray) -> List[str]:
    """The fields ``to_csv`` writes for a numeric or string column: ints
    as digits, floats as numpy's shortest repr, missing as ''."""
    if values.dtype.kind in "iu":
        return [str(v) for v in values.tolist()]
    if values.dtype.kind == "f":
        text = values.astype(str)
        text[np.isnan(values)] = ""
        return text.tolist()
    return ["" if v is None else str(v) for v in values.tolist()]
