"""Tab-separated tables without pandas.

phaser_tpu's downstream tools read their inputs with
`pandas.read_csv(path, sep="\\t", ...)` and write cis_var's and
expr_matrix's outputs with `DataFrame.to_csv(sep="\\t", index=False)`.
The typing pandas applies on the way in is part of those tools' outputs
(a column of digits is read as int, so "01" prints as "1"; an empty cell
is NaN, so `str()` of it is "nan"), and so is its formatting on the way out
(NaN as an empty field, floats by `repr`, an int column that holds a NaN
as floats).  This module reproduces both for the cases those tools meet,
so that the port's tools write the same bytes as phaser_tpu's and need no
pandas.

Reading (`read_tsv`), per column and over the whole file, as pandas' C
parser types it:
  * a cell in `NA_VALUES` (the empty cell among them) is missing;
  * every other cell an integer ("01", "+4", " 7") -> int; the same with a
    missing cell -> float, missing cells NaN;
  * every other cell a float ("1.", ".5", "1e5", "inf", "-Infinity") ->
    float;
  * every other cell "true" / "false" in any case -> bool (with a missing
    cell the column keeps the bools and NaN);
  * otherwise the cells stay strings, missing cells NaN;
  * a column with no cell but missing ones is float NaN;
  * floats are parsed as pandas parses them, which is not always the
    nearest double (see `_to_float`);
  * integers past the int64 range follow pandas' uint64 and object rules
    (a uint64 column with a sign or a missing cell keeps its raw text)
    where pandas does not depend on the order of the cells; past the
    uint64 range the result can differ from pandas'.
Blank lines are skipped; with `comment` a line is cut at its first comment
character.  Header names stay strings: an empty one becomes "Unnamed: i", a
repeated one "name.1".  Missing trailing cells are missing; extra cells are
dropped where pandas is called with `index_col=False` and an error
otherwise.  Quoted cells follow the csv module, as in pandas.

One pandas behaviour is not reproduced: with its default `low_memory`
mode pandas types a large file in chunks of about 256 KB and a column can
then hold ints from one chunk and strings from another.  Here a column is
typed as a whole.

Writing (`write_tsv`), with the column types the DataFrame constructor
would give the values: all bool -> "True"/"False"; all int -> str(int);
ints and floats (or None among ints) -> float, written by `repr`, NaN and
None empty; anything else -> str(value), NaN and None empty.  Cells with a
tab, a quote or a line break are quoted as the csv module quotes them, and
the header line is the labels' `str()`.
"""

from __future__ import annotations

import csv
import io
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence

NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])

_WS = r"[ \t\r\f\v]*"
_INT = _WS + r"[+-]?[0-9]+" + _WS
_FLOAT = (_WS + r"[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
          + _WS)
# one regex over a column's cells joined by newlines: the check runs in C
# (each pattern reads a cell one way only, so a failing column costs one
# pass)
_INT_COLUMN = re.compile(r"(?:%s\n)*%s" % (_INT, _INT))
_FLOAT_COLUMN = re.compile(r"(?:%s\n)*%s" % (_FLOAT, _FLOAT))
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}
_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)
_UINT64_MAX = (1 << 64) - 1

# the one NaN object of string and bool columns (pandas hands out one
# object for every missing cell there, a new float per cell of a float
# column; `dict.fromkeys` over a column sees the difference)
NAN = float("nan")

INT, FLOAT, BOOL, OBJECT = "int", "float", "bool", "object"


def is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


_E10 = [float("1e%d" % i) for i in range(309)]
_SHORT = re.compile(_WS + r"[+-]?(?=[0-9.]{1,15}(?:[eE]|[ \t\r\f\v]*$))"
                    r"[0-9]*\.?[0-9]*(?:[eE]([+-]?[0-9]{1,2}))?" + _WS)


def _to_float(cell: str) -> float:
    """A float cell as pandas' C parser reads it (its `precise_xstrtod`):
    the first 17 digits, leading zeros included, accumulated in a double,
    then one multiplication or division by a power of ten.  That rounds
    twice, so a 17-digit "0.30000000000000004" reads as 0.3.  Up to 15
    digits and a power of ten up to 1e22 both steps are exact or correctly
    rounded, and Python's float() gives the same double."""
    m = _SHORT.fullmatch(cell)
    if m and (m.group(1) is None or abs(int(m.group(1))) <= 7):
        return float(cell)
    t = cell.strip(" \t\r\f\v")
    i, n = 0, len(t)
    neg = t[0] == "-"
    if t[0] in "+-":
        i = 1
    number, exponent, nd = 0.0, 0, 0
    while i < n and "0" <= t[i] <= "9":
        if nd < 17:
            number = number * 10.0 + (ord(t[i]) - 48)
            nd += 1
        else:
            exponent += 1
        i += 1
    if i < n and t[i] == ".":
        i += 1
        while i < n and "0" <= t[i] <= "9":
            if nd < 17:
                number = number * 10.0 + (ord(t[i]) - 48)
                nd += 1
                exponent -= 1
            i += 1
    if neg:
        number = -number
    if i < n and t[i] in "eE":
        exponent += int(t[i + 1:])
    if exponent > 308:
        return math.copysign(math.inf, number) if number else 0.0
    if exponent > 0:
        return number * _E10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _E10[-308 - exponent] / _E10[308]
    return number / _E10[-exponent]


def _infer(cells: List[str]):
    """(kind, values) of one column of raw cells."""
    if not cells:
        return OBJECT, []
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    n_missing = len(cells) - len(present)
    if not present:
        return FLOAT, [float("nan") for _ in cells]
    joined = "\n".join(present)
    if _INT_COLUMN.fullmatch(joined):
        ints = [int(c) for c in present]
        lo, hi = min(ints), max(ints)
        if lo >= _INT64_MIN and hi <= _INT64_MAX:
            if n_missing == 0:
                return INT, ints
            it = iter(ints)
            return FLOAT, [float("nan") if m else float(next(it))
                           for m in missing]
        if lo < _INT64_MIN or hi > _UINT64_MAX:
            it = iter(ints)
            return OBJECT, [NAN if m else next(it) for m in missing]
        if lo >= 0 and n_missing == 0:
            return INT, ints                      # uint64
        return OBJECT, list(cells)   # uint64 with a sign or a gap: raw text
    if not (_FLOAT_COLUMN.fullmatch(joined) or
            all(c.lower() in _INF or _FLOAT_COLUMN.fullmatch(c)
                for c in present)):
        if all(c.lower() in ("true", "false") for c in present):
            bools = iter(c.lower() == "true" for c in present)
            if n_missing == 0:
                return BOOL, list(bools)
            return OBJECT, [NAN if m else next(bools) for m in missing]
        return OBJECT, [NAN if m else c for c, m in zip(cells, missing)]
    if any(_INT_COLUMN.fullmatch(c) and int(c) > _UINT64_MAX
           for c in present):
        return OBJECT, list(cells)
    floats = iter(_INF[c.lower()] if c.lower() in _INF else _to_float(c)
                  for c in present)
    return FLOAT, [float("nan") if m else next(floats) for m in missing]


class Table:
    """Columns of a TSV, typed on first use as pandas types them.

    `columns` are the labels in file order, `index` the row labels (the
    data row numbers of the file; `take` keeps them), `table[label]` a
    column's values as `DataFrame[label].tolist()` gives them."""

    def __init__(self, columns: List, cells: Dict, index: List[int]):
        self.columns = list(columns)
        self.index = list(index)
        self._cells = cells            # label -> raw cells (unread columns)
        self._typed: Dict = {}         # label -> (kind, values)
        self._parent = None            # (Table, positions) for a take

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, label) -> bool:
        return label in self.columns

    def typed(self, label):
        """(kind, values) of a column; KeyError for an unknown label."""
        if label not in self._typed:
            if label not in self.columns:
                raise KeyError(label)
            if self._parent is not None:
                parent, pos = self._parent
                kind, vals = parent.typed(label)
                self._typed[label] = (kind, [vals[i] for i in pos])
            else:
                self._typed[label] = _infer(self._cells.pop(label))
        return self._typed[label]

    def __getitem__(self, label) -> list:
        return self.typed(label)[1]

    def set_column(self, label, values: Sequence):
        """Assign a column of strings, as `df[label] = values` does."""
        if label not in self.columns:
            self.columns.append(label)
        self._typed[label] = (OBJECT, list(values))

    def take(self, positions: Iterable[int]) -> "Table":
        """The rows at these positions, column types kept (a boolean-mask
        selection of the DataFrame)."""
        pos = list(positions)
        sub = Table(self.columns, {}, [self.index[i] for i in pos])
        sub._parent = (self, pos)
        return sub

    def where(self, label, value) -> "Table":
        """The rows whose `label` cell == value (`df[df[label] == value]`;
        a NaN value selects nothing)."""
        vals = self[label]
        return self.take([i for i, v in enumerate(vals) if v == value])

    def row(self, position: int) -> dict:
        """One row as `df.loc[label]` gives it: when every column is numeric
        and one is float, every value is a float."""
        kinds = [self.typed(c)[0] for c in self.columns]
        vals = {c: self[c][position] for c in self.columns}
        if FLOAT in kinds and all(k in (INT, FLOAT) for k in kinds):
            return {c: float(v) for c, v in vals.items()}
        return vals


def _split_lines(text: str, comment: Optional[str]) -> List[str]:
    if text.startswith("\ufeff"):
        text = text[1:]
    if "\r" in text:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
    lines = text.split("\n")
    if comment:
        lines = [l.split(comment, 1)[0] for l in lines]
    return [l for l in lines if l]


def _fields(lines: List[str]) -> List[List[str]]:
    if any('"' in l for l in lines):
        return [r for r in csv.reader(lines, delimiter="\t", quotechar='"')]
    return [l.split("\t") for l in lines]


def _labels(names: List[str]) -> List[str]:
    out: List[str] = []
    seen: Dict[str, int] = {}
    for i, name in enumerate(names):
        if name == "":
            name = "Unnamed: %d" % i
        if name in seen:
            k = seen[name]
            while "%s.%d" % (name, k) in seen:
                k += 1
            seen[name] = k + 1
            name = "%s.%d" % (name, k)
        seen.setdefault(name, 1)
        out.append(name)
    return out


def read_tsv(path: Optional[str] = None, text: Optional[str] = None,
             header: bool = True, comment: Optional[str] = None,
             drop_extra: bool = True) -> Table:
    """A TSV file (or `text`) as `pandas.read_csv(sep="\\t")` reads it:
    with `header=False` the labels are 0..n-1 (`header=None`); `comment`
    as pandas' `comment=`; `drop_extra` as `index_col=False` (cells past
    the last label are dropped; otherwise they are an error, as they are in
    pandas when it cannot take them for an index)."""
    if text is None:
        with open(path, encoding="utf-8", newline="") as fh:
            text = fh.read()
    rows = _fields(_split_lines(text, comment))
    if not rows:
        raise ValueError("No columns to parse from file")
    if header:
        labels = _labels(rows[0])
        rows = rows[1:]
    else:
        labels = list(range(len(rows[0])))
    n = len(labels)
    for i, r in enumerate(rows):
        if len(r) > n:
            if not drop_extra:
                raise ValueError("Expected %d fields in line %d, saw %d"
                                 % (n, i + 1 + int(header), len(r)))
            rows[i] = r[:n]
        elif len(r) < n:
            rows[i] = r + [""] * (n - len(r))
    cols = list(zip(*rows)) if rows else [()] * n
    cells = {lab: list(c) for lab, c in zip(labels, cols)}
    return Table(labels, cells, list(range(len(rows))))


def _column_kind(values: Sequence) -> str:
    kinds = set()
    has_none = False
    for v in values:
        if v is None:
            has_none = True
        elif isinstance(v, bool) or type(v).__name__ in ("bool", "bool_"):
            kinds.add(BOOL)
        elif isinstance(v, int) or type(v).__name__.startswith(("int",
                                                                "uint")):
            kinds.add(INT)
        elif isinstance(v, float) or type(v).__name__.startswith("float"):
            kinds.add(FLOAT)
        else:
            kinds.add(OBJECT)
    if kinds == {BOOL}:
        return OBJECT if has_none else BOOL
    if kinds == {INT}:
        return FLOAT if has_none else INT
    if kinds and kinds <= {INT, FLOAT}:
        return FLOAT
    return OBJECT


def _cell(v, kind: str) -> str:
    if is_missing(v):
        return ""
    if kind == FLOAT:
        return repr(float(v))
    if kind == INT:
        return str(int(v))
    return str(v)


def tsv_text(columns: Dict) -> str:
    """`pandas.DataFrame(columns).to_csv(sep="\\t", index=False)`: `columns`
    maps each label to its values, in order."""
    buf = io.StringIO()
    w = csv.writer(buf, delimiter="\t", lineterminator="\n",
                   quoting=csv.QUOTE_MINIMAL)
    w.writerow([str(c) for c in columns])
    cols = []
    for vals in columns.values():
        kind = _column_kind(vals)
        cols.append([_cell(v, kind) for v in vals])
    w.writerows(zip(*cols))
    return buf.getvalue()


def write_tsv(path: str, labels: Sequence, rows: Sequence[Sequence]) -> None:
    """`pandas.DataFrame(rows, columns=labels).to_csv(path, sep="\\t",
    index=False)`."""
    cols = list(zip(*rows)) if rows else [()] * len(labels)
    with open(path, "w", encoding="utf-8", newline="") as fh:
        fh.write(tsv_text(dict(zip(labels, cols))))
