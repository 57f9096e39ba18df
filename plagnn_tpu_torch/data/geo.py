"""GEO series-matrix ingestion (Python port of code/data_reader.R).

Port of ``plagnn_tpu/data/geo.py`` without pandas.  The reference's R stage
(code/data_reader.R) reads the GEO series-matrix TXT (tab-separated, ``!``
comment lines), maps probe ids to UniProt accessions via Bioconductor
annotation DBs, inner-joins, and writes ``GSE*_exprSet.csv`` with a leading
``uniprot_id`` column.  The probe -> uniprot table is supplied as a
two-column CSV (``probe_id,uniprot_id``, the ``toTable(<db>UNIPROT)``
export of ``scripts/export_probe_map.R``).

Tables are :class:`Table` (a header and one numpy column per name) in
place of DataFrames, with the JAX package's pandas semantics
(``csv_values.py``): ``to_numeric(errors="coerce")`` types each sample
column (int64 where every field is an integer, else float64 with NaN);
the inner join keeps the series matrix's row order, each probe's
accessions in the map's order; the CSV is ``to_csv``'s, byte for byte.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import List

import numpy as np

from .csv_values import NA_STRINGS, format_column, numeric_column


@dataclasses.dataclass
class Table:
    """Named columns of equal length: object arrays of str (None where
    missing) or int64 / float64 arrays."""
    header: List[str]
    columns: List[np.ndarray]

    def __len__(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[self.header.index(name)]


def _strings(values) -> np.ndarray:
    out = np.empty(len(values), object)
    out[:] = list(values)
    return out


def read_series_matrix(path: str) -> Table:
    """Parse the series-matrix table (R: read.table(sep='\\t',
    comment.char='!', header=T)); first column is the probe id."""
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            if line.startswith("!") or not line.strip():
                continue
            parts = [p.strip().strip('"') for p in line.rstrip("\n").split("\t")]
            if header is None:
                header = parts
            else:
                rows.append(parts)
    if any(len(r) != len(header) for r in rows):
        raise ValueError(f"{path}: a row's field count differs from the header's")
    fields = list(zip(*rows)) if rows else [()] * len(header)
    columns = [_strings(fields[0])]
    columns += [numeric_column(col, coerce=True) for col in fields[1:]]
    return Table(["probe_id"] + header[1:], columns)


def load_probe_map(path: str) -> Table:
    """probe_id -> uniprot_id table (export of toTable(<db>UNIPROT))."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    cols = {c.lower(): i for i, c in enumerate(rows[0])}

    def column(name):
        i = cols[name]
        return _strings([None if i >= len(r) or r[i] in NA_STRINGS else r[i]
                         for r in rows[1:]])

    return Table(["probe_id", "uniprot_id"], [column("probe_id"), column("uniprot_id")])


def build_expr_set(series_matrix_path: str, probe_map_path: str) -> Table:
    """Inner-join probes to accessions; uniprot_id leading column
    (data_reader.R:16-19)."""
    expr = read_series_matrix(series_matrix_path)
    ids = load_probe_map(probe_map_path)
    matches = {}
    for j, probe in enumerate(ids["probe_id"]):
        if probe is not None:
            matches.setdefault(probe, []).append(j)
    left, right = [], []
    for i, probe in enumerate(expr["probe_id"]):
        for j in matches.get(probe, ()):
            left.append(i)
            right.append(j)
    left = np.array(left, np.int64)
    keep = [c for c in expr.header if c not in ("uniprot_id", "probe_id")]
    return Table(["uniprot_id"] + keep,
                 [ids["uniprot_id"][np.array(right, np.int64)]]
                 + [expr[c][left] for c in keep])


def write_expr_set(
    series_matrix_path: str, probe_map_path: str, out_csv: str
) -> None:
    """R's write.csv emits a leading unnamed row-index column; keep it so the
    downstream CSV read (data_preprocess.py:139) sees the same layout."""
    table = build_expr_set(series_matrix_path, probe_map_path)
    columns = [[str(i) for i in range(1, len(table) + 1)]]
    columns += [format_column(c) for c in table.columns]
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow([""] + table.header)
        w.writerows(zip(*columns))
