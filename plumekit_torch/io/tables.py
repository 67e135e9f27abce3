"""Row tables: the port's stand-in for the JAX package's pandas frames.

A :class:`Table` is named columns over rows of plain Python values. It is
written as pandas' ``to_csv(index=False)`` writes a frame (floats at full
precision, NaN and None as empty cells) and read back as ``pd.read_csv``
types the columns of the files this project writes: a column whose cells
all parse as integers is int, one whose cells parse as numbers (empty
cells and pandas' NA strings as NaN) is float, one of ``True``/``False``
cells is bool, and anything else stays str. So a numeric ``datetime``
column reads as a number whose ``str`` is what the JAX package compares.
Numbers are parsed as pandas' default float converter parses them
(:func:`pandas_float`), which is not always the correctly rounded value,
so a table read and written again carries the JAX package's digits.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass, field
from typing import List, Tuple

#: cells ``pd.read_csv`` reads as NaN by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf, "-infinity": -math.inf}
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def pandas_float(cell: str) -> float:
    """``cell`` as ``pd.read_csv``'s default ("high" precision) converter
    reads it: up to 17 significant digits accumulated in a double, then
    one multiplication or division by a power of ten. Past 2**53 the
    accumulation rounds, so this may differ from ``float(cell)`` in the
    last place. Raises ValueError for a cell that is not a number."""
    p = cell.strip()
    if p.lower() in _INF:
        return _INF[p.lower()]
    n, i = len(p), 0

    def digit(j):
        return j < n and "0" <= p[j] <= "9"

    negative = i < n and p[i] == "-"
    if i < n and p[i] in "+-":
        i += 1
    number, exponent, digits = 0.0, 0, 0
    while digit(i):
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(p[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and p[i] == ".":
        i += 1
        decimals = 0
        while digits < _MAX_DIGITS and digit(i):
            number = number * 10.0 + (ord(p[i]) - 48)
            digits += 1
            decimals += 1
            i += 1
        while digit(i):
            i += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {cell!r}")
    if negative:
        number = -number
    if i < n and p[i] in "eE":
        i += 1
        neg_exp = i < n and p[i] == "-"
        if i < n and p[i] in "+-":
            i += 1
        e, e_digits = 0, 0
        while e_digits < _MAX_DIGITS and digit(i):
            e = e * 10 + (ord(p[i]) - 48)
            e_digits += 1
            i += 1
        if e_digits == 0:
            raise ValueError(f"not a number: {cell!r}")
        exponent += -e if neg_exp else e
    if i != n:
        raise ValueError(f"not a number: {cell!r}")
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def is_missing(value) -> bool:
    """None or a float NaN: what pandas writes as an empty cell."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def nan_key(value):
    """A hashable stand-in that makes every missing value one key, as
    pandas' hash tables do."""
    return ("nan",) if is_missing(value) else value


def unique(values) -> list:
    """Distinct values in first-appearance order (``Series.unique``)."""
    seen, out = set(), []
    for v in values:
        k = nan_key(v)
        if k not in seen:
            seen.add(k)
            out.append(v)
    return out


@dataclass
class Table:
    """Rows of plain Python values under named columns."""

    columns: Tuple[str, ...]
    rows: List[tuple] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list:
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    def where(self, keep) -> "Table":
        """The rows for which ``keep(row)`` is true, in order."""
        return Table(self.columns, [r for r in self.rows if keep(r)])

    def with_column(self, name: str, value) -> "Table":
        """A copy with column ``name`` appended, ``value`` in every row."""
        return Table(tuple(self.columns) + (name,),
                     [r + (value,) for r in self.rows])

    def to_csv(self, path: str) -> None:
        """Header and rows; floats at full precision (``repr``), missing
        values as empty cells, as pandas writes them."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            w.writerows(tuple("" if is_missing(v) else v for v in r)
                        for r in self.rows)

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        """A CSV with a header row, each column typed as ``pd.read_csv``
        types it (see the module docstring)."""
        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            cells = [r for r in reader if r]
        cols = [_typed([r[i] if i < len(r) else "" for r in cells])
                for i in range(len(header))]
        return cls(tuple(header), list(zip(*cols)) if cols else [])


def _typed(cells: List[str]) -> list:
    na = [c in NA_STRINGS for c in cells]
    if all(na):
        return [math.nan] * len(cells)
    if not any(na):
        try:
            if not any("_" in c for c in cells):
                return [int(c) for c in cells]
        except ValueError:
            pass
    try:
        return [math.nan if n else pandas_float(c) for c, n in zip(cells, na)]
    except ValueError:
        pass
    if not any(na) and all(c in _TRUE or c in _FALSE for c in cells):
        return [c in _TRUE for c in cells]
    return [math.nan if n else c for c, n in zip(cells, na)]


def truthy(value) -> bool:
    """A decisions CSV's ``keep`` cell: 1/true/yes/y, or any number equal
    to 1 (a manifest ``keep`` column with blanks and 1s reads back as
    floats, so ``str`` gives "1.0")."""
    s = str(value).strip().lower()
    if s in ("1", "true", "yes", "y"):
        return True
    try:
        return float(s) == 1.0
    except ValueError:
        return False


def read_decisions(path: str) -> set:
    """The ``(id, str(datetime))`` keys kept by a decisions CSV
    (``id,datetime,keep``), as ``plumekit select --decisions`` reads it."""
    table = Table.read_csv(path)
    return {(int(i), str(dt))
            for i, dt, keep in zip(table.column("id"),
                                   table.column("datetime"),
                                   table.column("keep")) if truthy(keep)}


__all__ = ["NA_STRINGS", "Table", "is_missing", "nan_key", "pandas_float",
           "read_decisions", "truthy", "unique"]
