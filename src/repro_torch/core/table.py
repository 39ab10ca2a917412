"""FTable: fixed-width row-format table schema (paper §4.2, §6.1).

Port of `repro/core/table.py`. The paper's evaluation
tables are 8 attributes x 8 bytes, row format; the reproduction keeps the
row format and the attribute count but uses 4-byte words as the attribute
cell (f32 / int32 stored as f32). Integer columns must stay within +-2^24
to survive the f32 word exactly; ingest enforces this. String tables
(`str_width`, `string_table`) keep their bytes outside the pool: a
request carries them as a byte sideband (`strings=` / `lengths=`), and
the pipeline runs RegexMatch over them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WORD_BYTES = 4
INT_EXACT_LIMIT = 1 << 24


@dataclass(frozen=True)
class Column:
    name: str
    dtype: str = "f32"  # "f32" | "i32" | "str"


@dataclass
class FTable:
    """Schema + placement handle for a table living in a FarPool."""
    name: str
    columns: tuple[Column, ...]
    n_rows: int = 0
    str_width: int = 0
    # placement (filled by FarPool.alloc_table)
    table_id: int = -1
    pages: tuple[int, ...] = field(default_factory=tuple)

    @property
    def n_cols(self) -> int:
        return len(self.columns)

    @property
    def row_words(self) -> int:
        if self.str_width:
            return (self.str_width + WORD_BYTES - 1) // WORD_BYTES
        return self.n_cols

    @property
    def n_words(self) -> int:
        return self.n_rows * self.row_words

    @property
    def n_bytes(self) -> int:
        return self.n_words * WORD_BYTES

    def col_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column {name!r} in table {self.name!r}")

    def encode(self, arrays: dict[str, np.ndarray]) -> np.ndarray:
        """dict of column arrays -> (n_rows, n_cols) f32 word matrix."""
        cols = []
        for c in self.columns:
            a = np.asarray(arrays[c.name])
            if c.dtype == "i32" and np.any(np.abs(a) >= INT_EXACT_LIMIT):
                raise ValueError(
                    f"int column {c.name} exceeds f32-exact range 2^24")
            cols.append(a.astype(np.float32))
        mat = np.stack(cols, axis=1)
        if self.n_rows and mat.shape[0] != self.n_rows:
            raise ValueError("row count mismatch")
        return mat

    def decode(self, mat: np.ndarray) -> dict[str, np.ndarray]:
        out = {}
        for i, c in enumerate(self.columns):
            col = np.asarray(mat[:, i])
            out[c.name] = (np.rint(col).astype(np.int32)
                           if c.dtype == "i32" else col)
        return out


def string_table(name: str, strings: list[bytes], width: int) -> tuple:
    """Build an FTable + (n, width) uint8 matrix + lengths for byte strings."""
    ft = FTable(name=name, columns=(Column("bytes", "str"),),
                n_rows=len(strings), str_width=width)
    mat = np.zeros((len(strings), width), np.uint8)
    lens = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        b = s[:width]
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return ft, mat, lens
