"""FarPool: the disaggregated buffer pool (port of `repro/core/pool.py`).

The flat half of the reference pool: a paged, device-resident f32 word
buffer with 2 MiB pages, per-table page lists (`FTable.pages`), striped
allocation across shards and a pinned all-zeros null page. The hot/cold tier fields come
with the tiering slice (ROADMAP.md queue 1, slice 5).

The read path is device-resident: `gather_rows` / `gather_columns` are
pure functions of `(buf, pages)`, which the pipeline calls directly, so
a request's pool read is part of its dispatch.

Every table carries a write generation (`FarPool.generation`), a number
drawn anew from a process-wide counter whenever the table's words may
change: on alloc, write, free and adopt. (table id, generation) therefore
names one content of one table, and keys what is cached about it (the
join's verdict that a build table's keys are unique).
"""
from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.table import FTable, WORD_BYTES
from repro_torch.kernels import _build

PAGE_BYTES = 2 * 1024 * 1024
# write generations: process-wide, so no (table id, generation) pair
# repeats, across pools or after an adopt reuses table ids
_GENERATIONS = itertools.count(1)


# ---------------------------------------------------------------- read path
def gather_rows(buf: torch.Tensor, pages: torch.Tensor, n_rows: int,
                row_words: int) -> torch.Tensor:
    """Device-resident page gather: pages (..., P) int64 page ids ->
    (..., n_rows, row_words) f32, one stack axis per leading pages axis."""
    flat = buf[pages].reshape(*pages.shape[:-1], -1)
    return flat[..., : n_rows * row_words].reshape(
        *pages.shape[:-1], n_rows, row_words)


def gather_columns(buf: torch.Tensor, pages: torch.Tensor, n_rows: int,
                   row_words: int, cols: torch.Tensor) -> torch.Tensor:
    """Smart addressing (paper §5.2): only the projected columns' words
    leave the gather. cols: (k,) int64 column ids on buf's device.
    Returns (..., n_rows, k)."""
    rows = gather_rows(buf, pages, n_rows, row_words)
    return rows[..., cols]


@dataclass
class PoolStats:
    bytes_read: int = 0
    bytes_written: int = 0
    bytes_shipped: int = 0          # over-the-network response bytes
    requests: int = 0


class FarPool:
    """Disaggregated memory node: paged word buffer + page table."""

    def __init__(self, capacity_bytes: int, *, device: torch.device,
                 page_bytes: int = PAGE_BYTES, n_shards: int = 1):
        if capacity_bytes % page_bytes:
            raise ValueError("capacity must be page-aligned")
        self.device = torch.device(device)
        self.page_bytes = page_bytes
        self.page_words = page_bytes // WORD_BYTES
        self.n_pages = capacity_bytes // page_bytes
        if self.n_pages % n_shards:
            raise ValueError("pages must divide shards")
        self.n_shards = n_shards
        self.chunk = self.n_pages // n_shards     # pages per shard
        # pinned all-zeros pages past the allocatable range: the scheduler
        # pads bucketed page lists with `null_page` so different-sized
        # tables can share a stacked dispatch (tail rows read zeros and are
        # masked by n_valid). Never allocated, never written.
        self.null_page = self.n_pages
        self.buf = torch.zeros((self.n_pages + n_shards, self.page_words),
                               dtype=torch.float32, device=self.device)
        self._free: list[deque[int]] = [
            deque(range(s * self.chunk, (s + 1) * self.chunk))
            for s in range(n_shards)]
        self._next_table_id = 0
        self._generation: dict[int, int] = {}    # table_id -> generation
        self.stats = PoolStats()

    # ------------------------------------------------------------------ mgmt
    def generation(self, ft: FTable) -> int:
        """The table's write generation: changes whenever its words may."""
        return self._generation.get(ft.table_id, 0)

    def _touch(self, table_id: int) -> None:
        self._generation[table_id] = next(_GENERATIONS)

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    def alloc_table(self, ft: FTable) -> FTable:
        n_pages = max(1, math.ceil(ft.n_bytes / self.page_bytes))
        if n_pages > self.free_pages:
            raise MemoryError(
                f"pool exhausted: need {n_pages} pages, have {self.free_pages}")
        # round-robin striping across shards, skipping exhausted shards
        pages: list[int] = []
        s = 0
        while len(pages) < n_pages:
            free = self._free[s % self.n_shards]
            if free:
                pages.append(free.popleft())
            s += 1
        ft.table_id = self._next_table_id
        self._next_table_id += 1
        ft.pages = tuple(pages)
        self._touch(ft.table_id)
        return ft

    def free_table(self, ft: FTable) -> None:
        for p in ft.pages:
            self._free[p // self.chunk].append(p)
        self._touch(ft.table_id)
        ft.pages = ()
        ft.table_id = -1

    def adopt(self, buf: np.ndarray, tables: list[FTable]) -> None:
        """Take over a pool image: `buf` becomes the page buffer and the
        given placed tables its only allocations (their pages leave the
        free lists, later allocations get fresh table ids)."""
        if tuple(buf.shape) != tuple(self.buf.shape):
            raise ValueError(f"pool image is {tuple(buf.shape)}, this pool "
                             f"is {tuple(self.buf.shape)}")
        self.buf = torch.from_numpy(np.array(buf, np.float32)).to(
            self.device)                # a private copy: the image may be
        #                                 read-only or shared
        used = {p for ft in tables for p in ft.pages}
        self._free = [deque(p for p in range(s * self.chunk,
                                             (s + 1) * self.chunk)
                            if p not in used)
                      for s in range(self.n_shards)]
        self._next_table_id = max((ft.table_id for ft in tables),
                                  default=-1) + 1
        for ft in tables:
            self._touch(ft.table_id)

    # ------------------------------------------------------------------- I/O
    def pages_of(self, ft: FTable) -> torch.Tensor:
        """The table's page ids on the pool's device, uploaded without a
        host sync."""
        return _build.upload(ft.pages, torch.int64, self.device)

    def write_table(self, ft: FTable, words) -> None:
        """words: (n_rows, row_words) f32 (numpy or tensor)."""
        flat = torch.as_tensor(words, dtype=torch.float32).reshape(-1)
        n_pages = len(ft.pages)
        padded = torch.zeros((n_pages * self.page_words,),
                             dtype=torch.float32, device=self.device)
        padded[: flat.shape[0]] = flat.to(self.device)
        self.buf[self.pages_of(ft)] = padded.reshape(n_pages, self.page_words)
        self._touch(ft.table_id)
        self.stats.bytes_written += int(flat.shape[0]) * WORD_BYTES

    def read_table(self, ft: FTable) -> torch.Tensor:
        """Full-table read -> (n_rows, row_words) f32 on the pool device."""
        rows = gather_rows(self.buf, self.pages_of(ft), ft.n_rows,
                           ft.row_words)
        self.stats.bytes_read += ft.n_bytes
        return rows

    def read_rows(self, ft: FTable, row_idx) -> torch.Tensor:
        """Row-subset read -> (len(row_idx), row_words) f32: gathers only
        the selected LOCAL rows' words through the page table and bills
        exactly the subset."""
        row_idx = np.asarray(row_idx, np.int64)
        if row_idx.size == 0:
            return torch.zeros((0, ft.row_words), dtype=torch.float32,
                               device=self.device)
        pages = np.asarray(ft.pages, np.int64)
        w = (row_idx[:, None] * ft.row_words
             + np.arange(ft.row_words, dtype=np.int64)[None, :])
        vals = self.buf[torch.from_numpy(pages[w // self.page_words]).to(
                            self.device),
                        torch.from_numpy(w % self.page_words).to(self.device)]
        self.stats.bytes_read += int(row_idx.size) * ft.row_words * WORD_BYTES
        return vals
