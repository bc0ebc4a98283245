"""ASCII tables in the texttable style of the upstream reports: a copy of
``fvt_tpu/utils/tables.py``, held equal to it by
``tests/test_torch_copies.py``.

The upstream project renders per-class vectors and confusion matrices with the
``texttable`` package (its tools.py:18-70: bordered cells,
``=`` under the header, centered headers, precision-6 floats).  This is
a dependency-free renderer producing the same look for the perf-report
artifact contract.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

Cell = Union[str, float, int]


def _fmt(cell: Cell, dtype: str, precision: int) -> str:
    # Missing values render as '-' regardless of the column dtype; the
    # run-summary aggregator legitimately carries None for perf nodes a
    # partial/foreign run dir lacks.
    if cell is None or (isinstance(cell, str) and cell == '-'):
        return '-'
    if dtype == 'f':
        return f"{float(cell):.{precision}f}"
    return str(cell)


def draw_table(header: Sequence[str], rows: Sequence[Sequence[Cell]],
               dtypes: Sequence[str], precision: int = 6) -> str:
    """Bordered table: ``+--+`` rules, ``+==+`` under the header,
    centered header cells, left-aligned data cells, one space padding —
    texttable's default decoration."""
    ncols = len(header)
    assert all(len(r) == ncols for r in rows), 'ragged rows'
    assert len(dtypes) == ncols, (len(dtypes), ncols)

    cells = [[_fmt(c, 't', precision) for c in header]]
    for r in rows:
        cells.append([_fmt(c, d, precision) for c, d in zip(r, dtypes)])

    widths = [max(len(row[j]) for row in cells) for j in range(ncols)]

    def rule(ch: str) -> str:
        return '+' + '+'.join(ch * (w + 2) for w in widths) + '+'

    def line(row: List[str], center: bool) -> str:
        out = []
        for txt, w in zip(row, widths):
            out.append(txt.center(w) if center else txt.ljust(w))
        return '| ' + ' | '.join(out) + ' |'

    parts = [rule('-'), line(cells[0], center=True), rule('=')]
    for row in cells[1:]:
        parts.append(line(row, center=False))
        parts.append(rule('-'))
    return '\n'.join(parts)


def print_confusion_mtx(cmtx: np.ndarray, int_to_cl: Dict[int, str]) -> str:
    """Row/column class-named confusion matrix (tools.py:18-46)."""
    h, w = cmtx.shape
    header = ['*'] + [str(int_to_cl.get(k, k)) for k in range(w)]
    dtypes = ['t'] + ['f'] * w
    rows = [[str(int_to_cl.get(i, i))] + list(map(float, cmtx[i]))
            for i in range(h)]
    return draw_table(header, rows, dtypes)


def print_vector(vec: np.ndarray, int_to_cl: Dict[int, str]) -> str:
    """One-row class-named vector (tools.py:49-69)."""
    vec = np.asarray(vec)
    assert vec.ndim == 1, vec.ndim
    header = [str(int_to_cl.get(i, i)) for i in range(vec.size)]
    return draw_table(header, [list(map(float, vec))], ['f'] * vec.size)
