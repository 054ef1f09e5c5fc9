"""Peaks of the card and the bytes a kernel's work needs: a frozen copy of
chip_smoke.py's arithmetic (HBM_BYTES_PER_S, TABLE_ROW_BYTES and the
ragged join's count in its bound table)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
TABLE_ROW_BYTES = 16         # vpos, a0, a1, n_ind: 4 x int32 an entry
SECTOR = 32


def ragged_join_bytes(rows: int, ops: int, entries: int, hits: int,
                      emitted: int) -> int:
    """pos and two offsets a row, 4 B an op, 16 B a table entry, a sector
    of seq and one of qual a hit, 8 B an emitted hit."""
    return rows * 12 + ops * 4 + entries * TABLE_ROW_BYTES + \
        2 * SECTOR * hits + 8 * emitted


def bound_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S
