"""FarPool: the disaggregated buffer pool (port of `repro/core/pool.py`).

A paged, device-resident f32 word buffer with 2 MiB pages, per-table page
lists (`FTable.pages`), striped allocation across shards and a pinned
all-zeros null page; and its memory tiering: tables demote to a COLD
tier (word pages compressed into shared cold frames by
`distributed/compress.py`, string extents through the block codec) and
promote back, with a per-page tier bit, access hysteresis and physical
byte accounting (docs/tiering.md).

The read path is device-resident: `gather_rows` / `gather_columns` are
pure functions of `(buf, pages)`, and their tiered forms
(`kernels/tier.py`) functions of `(buf, descriptors)`, which the pipeline
calls directly, so a request's pool read, cold pages decoded, is part of
its dispatch. Demote and promote are background paths: they copy pages
to the host, run the numpy codec and write frames back.

Every table carries a write generation (`FarPool.generation`), a number
drawn anew from a process-wide counter whenever the table's words may
change: on alloc, write, free and adopt. (table id, generation) therefore
names one content of one table, and keys what is cached about it (the
join's verdict that a build table's keys are unique). Demote and promote
move a table's words without changing them, and keep its generation.
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.table import FTable, WORD_BYTES
from repro_torch.distributed import compress as pagec
from repro_torch.kernels import _build
from repro_torch.kernels import tier as ktier

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
class TableTier:
    """Per-table tiering state: the per-page tier bit plus the decode
    descriptors the tiered gather consumes (kernels/tier.py layout).

    `phys` tracks where each LOGICAL page lives NOW — its original raw
    page while hot, or the shared cold frame holding its compressed
    stream after demotion (`FTable.pages` keeps the logical view; every
    pool read/write path consults this entry first). Word tables demote
    page-granular through the bit-packed plane codec; string tables
    demote extent-granular through the block codec (`blob_*`) because
    their dispatch path reads the byte sideband, not pool words."""
    C: int                        # codec plane count == row_words
    is_str: bool
    n_words: np.ndarray           # (P,)  logical words per page
    cold: np.ndarray              # (P,)  bool — THE per-page tier bit
    phys: np.ndarray              # (P,)  int32 raw page | cold frame
    mode: np.ndarray              # (P,C) int32 plane modes (RAW rows = hot)
    width: np.ndarray             # (P,C) int32 packed bits per value
    base: np.ndarray              # (P,C) uint32 delta bases
    dictoff: np.ndarray           # (P,C) int32 FRAME-relative dict words
    bitoff: np.ndarray            # (P,C) int32 FRAME-relative plane bits
    counts: np.ndarray            # (P,C) int64 values per plane
    dictlen: np.ndarray           # (P,C) int32 dict words per plane
    span: np.ndarray              # (P,2) int32 (word off, words) in frame
    crc: np.ndarray               # (P,)  uint32 page codec CRC
    frames: dict[int, set[int]] = field(default_factory=dict)
    hits: deque = field(default_factory=deque)   # promotion hysteresis
    blob: tuple[int, ...] = ()    # str extent: frames holding block stream
    blob_len: int = 0             # str extent: encoded byte length

    @classmethod
    def fresh(cls, ft: FTable, page_words: int) -> "TableTier":
        P = len(ft.pages)
        C = ft.row_words
        n_words = np.minimum(
            page_words,
            np.maximum(0, ft.n_words - np.arange(P, dtype=np.int64)
                       * page_words)).astype(np.int64)
        k = np.arange(ft.n_words, dtype=np.int64)
        counts = np.zeros((P, C), np.int64)
        np.add.at(counts, (k // page_words, k % C), 1)
        return cls(C=C, is_str=bool(ft.str_width), n_words=n_words,
                   cold=np.zeros((P,), bool),
                   phys=np.asarray(ft.pages, np.int32),
                   mode=np.full((P, C), pagec.MODE_RAW, np.int32),
                   width=np.ones((P, C), np.int32),
                   base=np.zeros((P, C), np.uint32),
                   dictoff=np.zeros((P, C), np.int32),
                   bitoff=np.zeros((P, C), np.int32),
                   counts=counts,
                   dictlen=np.zeros((P, C), np.int32),
                   span=np.zeros((P, 2), np.int32),
                   crc=np.zeros((P,), np.uint32))

    @classmethod
    def from_arrays(cls, arrays: dict) -> "TableTier":
        """A tier entry from plain data (`load_node_state`): the dataclass
        fields as numpy arrays and ints, `frames` a mapping of cold frame
        -> logical pages it holds; `hits` starts empty."""
        def arr(name, dtype):
            return np.array(arrays[name], dtype=dtype)
        return cls(C=int(arrays["C"]), is_str=bool(arrays["is_str"]),
                   n_words=arr("n_words", np.int64),
                   cold=arr("cold", bool), phys=arr("phys", np.int32),
                   mode=arr("mode", np.int32), width=arr("width", np.int32),
                   base=arr("base", np.uint32),
                   dictoff=arr("dictoff", np.int32),
                   bitoff=arr("bitoff", np.int32),
                   counts=arr("counts", np.int64),
                   dictlen=arr("dictlen", np.int32),
                   span=arr("span", np.int32), crc=arr("crc", np.uint32),
                   frames={int(f): {int(p) for p in ps}
                           for f, ps in dict(arrays.get("frames",
                                                        {})).items()},
                   blob=tuple(int(f) for f in arrays.get("blob", ())),
                   blob_len=int(arrays.get("blob_len", 0)))


@dataclass
class PoolStats:
    bytes_read: int = 0
    bytes_written: int = 0
    bytes_shipped: int = 0          # over-the-network response bytes
    requests: int = 0


class FarPool:
    """Disaggregated memory node: paged word buffer + page table, with a
    compressed cold tier.

    `promote_after` / `promote_window`: promotion hysteresis — a cold
    table promotes after `promote_after` accesses inside a
    `promote_window`-second window, so a single cold scan runs
    decode-in-dispatch instead of thrashing the tier bit, while
    genuinely re-hot tables come back raw."""

    def __init__(self, capacity_bytes: int, *, device: torch.device,
                 page_bytes: int = PAGE_BYTES, n_shards: int = 1,
                 promote_after: int = 3, promote_window: float = 60.0):
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
        # ----- memory tiering (docs/tiering.md) -----------------------------
        self.promote_after = promote_after
        self.promote_window = promote_window
        self._tier: dict[int, TableTier] = {}     # table_id -> tier entry
        self._tier_dev: dict[int, tuple] = {}     # device descriptor cache
        self._logical: dict[int, int] = {}        # table_id -> logical bytes
        self.tier_stats = {"demoted_pages": 0, "promoted_pages": 0,
                           "incompressible_pages": 0}

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
        self._logical[ft.table_id] = ft.n_bytes
        self._touch(ft.table_id)
        return ft

    def free_table(self, ft: FTable) -> None:
        te = self._tier.pop(ft.table_id, None)
        self._tier_dev.pop(ft.table_id, None)
        self._logical.pop(ft.table_id, None)
        if te is None:
            pages = ft.pages
        else:
            # cold pages' original raw frames were freed at demotion: give
            # back the shared cold frames + the still-hot pages' raw frames
            pages = list(te.frames) + list(te.blob) + [
                int(te.phys[p]) for p in range(len(te.cold))
                if not te.cold[p]]
        for p in pages:
            self._free[p // self.chunk].append(p)
        self._touch(ft.table_id)
        ft.pages = ()
        ft.table_id = -1

    def adopt(self, buf: np.ndarray, tables: list[FTable],
              tiers: dict[int, TableTier] | None = None) -> None:
        """Take over a pool image: `buf` becomes the page buffer and the
        given placed tables its only allocations (their pages leave the
        free lists, later allocations get fresh table ids). `tiers` maps a
        table id to its tier entry: that table's cold frames, blob frames
        and still-hot pages are its allocation, in place of its pages."""
        if tuple(buf.shape) != tuple(self.buf.shape):
            raise ValueError(f"pool image is {tuple(buf.shape)}, this pool "
                             f"is {tuple(self.buf.shape)}")
        # a private copy, moved bitwise (the image may be read-only or
        # shared, and a float copy need not keep NaN payloads)
        image = np.ascontiguousarray(buf, np.float32).view(np.int32)
        self.buf = torch.from_numpy(image.copy()).to(self.device).view(
            torch.float32)
        tiers = dict(tiers or {})
        used: set[int] = set()
        for ft in tables:
            te = tiers.get(ft.table_id)
            if te is None:
                used.update(ft.pages)
            else:
                used.update(te.frames)
                used.update(te.blob)
                used.update(int(te.phys[p]) for p in range(len(te.cold))
                            if not te.cold[p])
        self._free = [deque(p for p in range(s * self.chunk,
                                             (s + 1) * self.chunk)
                            if p not in used)
                      for s in range(self.n_shards)]
        self._next_table_id = max((ft.table_id for ft in tables),
                                  default=-1) + 1
        self._tier = {t: te for t, te in tiers.items()
                      if te.cold.any()}
        self._tier_dev = {}
        self._logical = {ft.table_id: ft.n_bytes for ft in tables}
        for ft in tables:
            self._touch(ft.table_id)

    # ------------------------------------------------------------------- I/O
    def pages_of(self, ft: FTable) -> torch.Tensor:
        """The table's page ids on the pool's device, uploaded without a
        host sync."""
        return _build.upload(ft.pages, torch.int64, self.device)

    def write_table(self, ft: FTable, words) -> None:
        """words: (n_rows, row_words) f32 (numpy or tensor)."""
        if ft.table_id in self._tier:
            # writes land on raw pages only: promote first (a written table
            # is hot by definition; the heat ledger will re-demote later)
            self.promote_table(ft)
        flat = torch.as_tensor(words, dtype=torch.float32).reshape(-1)
        n_pages = len(ft.pages)
        padded = torch.zeros((n_pages * self.page_words,),
                             dtype=torch.float32, device=self.device)
        padded[: flat.shape[0]] = flat.to(self.device)
        self.buf[self.pages_of(ft)] = padded.reshape(n_pages, self.page_words)
        self._touch(ft.table_id)
        self.stats.bytes_written += int(flat.shape[0]) * WORD_BYTES

    def read_table(self, ft: FTable) -> torch.Tensor:
        """Full-table read -> (n_rows, row_words) f32 on the pool device.

        A tiered table decodes in the same dispatch (word pages, through
        the tiered gather) or via the host block codec (string extents) —
        byte-identical to the raw read — and bills the PHYSICAL bytes
        actually pulled from memory (compressed for cold pages)."""
        te = self._tier.get(ft.table_id)
        if te is None:
            rows = gather_rows(self.buf, self.pages_of(ft), ft.n_rows,
                               ft.row_words)
            self.stats.bytes_read += ft.n_bytes
            return rows
        self.stats.bytes_read += self.tier_read_bytes(ft)
        if te.is_str:
            words = self._str_extent_words(ft, te).view(np.int32)
            return torch.from_numpy(words.reshape(
                ft.n_rows, ft.row_words)).to(self.device).view(torch.float32)
        return ktier.gather_rows_tiered(self.buf, self.tier_desc(ft),
                                        ft.n_rows, ft.row_words,
                                        self.page_words)

    def read_rows(self, ft: FTable, row_idx) -> torch.Tensor:
        """Row-subset read -> (len(row_idx), row_words) f32: gathers only
        the selected LOCAL rows' words through the page table and bills
        exactly the subset. A tiered table promotes first (migration copies
        read row subsets then usually free the source)."""
        if ft.table_id in self._tier:
            self.promote_table(ft)
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

    def read_columns(self, ft: FTable, col_idx: list[int]) -> torch.Tensor:
        """Smart addressing (paper §5.2): only the projected columns' words
        leave the pool. Returns (n_rows, k). On a tiered table only the
        projected columns' PLANES are unpacked (cold) or strided (hot);
        billing follows the physical bytes."""
        te = self._tier.get(ft.table_id)
        if te is not None and not te.is_str:
            out = ktier.gather_columns_tiered(
                self.buf, self.tier_desc(ft), ft.n_rows, ft.row_words,
                list(col_idx), self.page_words)
            self.stats.bytes_read += self.tier_read_bytes(ft, col_idx)
            return out
        out = gather_columns(self.buf, self.pages_of(ft), ft.n_rows,
                             ft.row_words,
                             _build.upload(list(col_idx), torch.int64,
                                           self.device))
        self.stats.bytes_read += ft.n_rows * len(col_idx) * WORD_BYTES
        return out

    # -------------------------------------------------- tiering (hot / cold)
    def is_tiered(self, ft: FTable) -> bool:
        """True while any of the table's pages are cold (an entry exists).
        A fully re-promoted table drops its entry and is indistinguishable
        from one that was never demoted."""
        return ft.table_id in self._tier

    def tier_bits(self, ft: FTable) -> np.ndarray:
        """The per-page tier bit: (P,) bool, True = cold (compressed)."""
        te = self._tier.get(ft.table_id)
        if te is None:
            return np.zeros((len(ft.pages),), bool)
        return te.cold.copy()

    def _alloc_frame(self) -> int:
        for free in self._free:
            if free:
                return free.popleft()
        raise MemoryError("pool exhausted: no free frame for tiering")

    def _page_words_u32(self, page: int, n: int) -> np.ndarray:
        # a host copy of the page's words (a sync: demote and promote are
        # background paths, never the dispatch path)
        return self.buf[page, :n].view(torch.int32).cpu().numpy().view(
            np.uint32).copy()

    def _write_frame_words(self, frame: int, off: int,
                           words_u32: np.ndarray) -> None:
        # moved as int32 words: bitwise, with no float conversion
        src = torch.from_numpy(np.ascontiguousarray(words_u32, np.uint32)
                               .view(np.int32))
        self.buf.view(torch.int32)[frame, off:off + src.shape[0]] = src.to(
            self.device)

    def demote_table(self, ft: FTable, page_idx=None) -> int:
        """Compress pages of `ft` in place (cold tier). Returns the number
        of pages demoted; each one's raw frame goes back to the free list
        (net capacity gain = raw pages freed - cold frames allocated).
        Incompressible pages keep their raw frame and a raw tier bit.
        String tables demote extent-granular through the block codec."""
        if ft.table_id < 0:
            raise ValueError(f"table {ft.name!r} is not allocated")
        if ft.str_width:
            return self._demote_str(ft)
        te = self._tier.get(ft.table_id)
        if te is None:
            te = TableTier.fresh(ft, self.page_words)
        targets = (range(len(te.cold)) if page_idx is None else page_idx)
        plans: list[tuple[int, pagec.PagePlan]] = []
        for p in targets:
            if te.cold[p]:
                continue
            words = self._page_words_u32(int(te.phys[p]), int(te.n_words[p]))
            plan = pagec.encode_word_page(
                words, te.C, phase=(p * self.page_words) % te.C,
                page_words=self.page_words)
            if plan is None:
                self.tier_stats["incompressible_pages"] += 1
                continue                    # tier bit stays raw, loudly so
            plans.append((p, plan))

        frame, off = -1, self.page_words    # force a fresh frame first
        demoted = 0
        for p, plan in plans:
            m = plan.stream_words
            if off + m > self.page_words:
                if self.free_pages == 0:
                    break                   # partial demotion: no room left
                frame, off = self._alloc_frame(), 0
                te.frames[frame] = set()
            self._write_frame_words(frame, off, plan.stream)
            te.phys[p] = frame
            te.mode[p] = plan.modes
            te.width[p] = plan.widths
            te.base[p] = plan.base
            te.dictoff[p] = np.where(plan.dictoff >= 0,
                                     plan.dictoff + off, 0)
            te.bitoff[p] = plan.bitoff + off * 32
            te.dictlen[p] = plan.dictlen
            te.span[p] = (off, m)
            te.crc[p] = np.uint32(plan.crc)
            te.cold[p] = True
            te.frames[frame].add(p)
            off += m
            # the page's raw frame is free the moment its stream is placed
            raw = int(ft.pages[p])
            self._free[raw // self.chunk].append(raw)
            demoted += 1
        if te.cold.any():
            self._tier[ft.table_id] = te
            self._tier_dev.pop(ft.table_id, None)
        self.tier_stats["demoted_pages"] += demoted
        return demoted

    def promote_table(self, ft: FTable, page_idx=None) -> int:
        """Decompress cold pages back to raw frames (CRC-verified host
        decode; raises `PageCodecError` on corruption instead of restoring
        wrong bytes). A fully-hot table drops its tier entry and
        `ft.pages` reflects the new raw placement."""
        te = self._tier.get(ft.table_id)
        if te is None:
            return 0
        if te.is_str:
            return self._promote_str(ft)
        targets = (range(len(te.cold)) if page_idx is None else page_idx)
        promoted = 0
        for p in targets:
            if not te.cold[p]:
                continue
            off, m = int(te.span[p, 0]), int(te.span[p, 1])
            frame = int(te.phys[p])
            stream = self._page_words_u32(frame, off + m)[off:].copy()
            plan = pagec.PagePlan(
                n_words=int(te.n_words[p]),
                phase=(p * self.page_words) % te.C,
                modes=te.mode[p].copy(), widths=te.width[p].copy(),
                base=te.base[p].copy(),
                dictoff=np.where(te.dictlen[p] > 0,
                                 te.dictoff[p] - off, -1).astype(np.int32),
                bitoff=(te.bitoff[p] - off * 32).astype(np.int32),
                dictlen=te.dictlen[p].copy(), stream=stream,
                crc=int(te.crc[p]))
            words = pagec.decode_word_page(plan, te.C)
            raw = self._alloc_frame()
            padded = np.zeros((self.page_words,), np.uint32)
            padded[:words.size] = words
            self._write_frame_words(raw, 0, padded)
            te.frames[frame].discard(p)
            if not te.frames[frame]:        # last resident left: frame free
                del te.frames[frame]
                self._free[frame // self.chunk].append(frame)
            te.phys[p] = raw
            te.cold[p] = False
            te.mode[p] = pagec.MODE_RAW
            te.width[p] = 1
            te.base[p] = 0
            te.dictoff[p] = 0
            te.bitoff[p] = 0
            te.dictlen[p] = 0
            promoted += 1
        ft.pages = tuple(int(x) for x in te.phys)
        if not te.cold.any():
            del self._tier[ft.table_id]     # fully hot: transparent again
        self._tier_dev.pop(ft.table_id, None)
        self.tier_stats["promoted_pages"] += promoted
        return promoted

    def _demote_str(self, ft: FTable) -> int:
        te = self._tier.get(ft.table_id)
        if te is not None:
            return 0                        # already cold (all-or-nothing)
        te = TableTier.fresh(ft, self.page_words)
        raw = b"".join(
            self._page_words_u32(int(p), int(te.n_words[i])).tobytes()
            for i, p in enumerate(ft.pages))
        enc = pagec.encode_blocks(raw)
        enc_words = (len(enc) + WORD_BYTES - 1) // WORD_BYTES
        k = max(1, math.ceil(enc_words / self.page_words))
        if k >= len(ft.pages):
            self.tier_stats["incompressible_pages"] += len(ft.pages)
            return 0                        # no capacity win: stay raw
        frames = [self._alloc_frame() for _ in range(k)]
        padded = np.zeros((k * self.page_words,), np.uint32)
        padded[:enc_words] = np.frombuffer(
            enc.ljust(enc_words * WORD_BYTES, b"\0"), np.uint32)
        for i, f in enumerate(frames):
            self._write_frame_words(
                f, 0, padded[i * self.page_words:(i + 1) * self.page_words])
        for p in ft.pages:
            self._free[int(p) // self.chunk].append(int(p))
        te.cold[:] = True
        te.phys[:] = -1
        te.blob = tuple(frames)
        te.blob_len = len(enc)
        self._tier[ft.table_id] = te
        self.tier_stats["demoted_pages"] += len(ft.pages)
        return len(ft.pages)

    def _promote_str(self, ft: FTable) -> int:
        te = self._tier.pop(ft.table_id)
        self._tier_dev.pop(ft.table_id, None)
        words = self._str_extent_words(ft, te)
        pages = [self._alloc_frame() for _ in range(len(te.cold))]
        for i, p in enumerate(pages):
            chunk = words[i * self.page_words:(i + 1) * self.page_words]
            padded = np.zeros((self.page_words,), np.uint32)
            padded[:chunk.size] = chunk
            self._write_frame_words(p, 0, padded)
        for f in te.blob:
            self._free[f // self.chunk].append(f)
        ft.pages = tuple(pages)
        self.tier_stats["promoted_pages"] += len(pages)
        return len(pages)

    def _str_extent_words(self, ft: FTable, te: TableTier) -> np.ndarray:
        """Decode a cold string extent's block stream -> logical u32 words
        (CRC-verified; typed `PageCodecError` on corruption)."""
        enc = b"".join(self._page_words_u32(f, self.page_words).tobytes()
                       for f in te.blob)[:te.blob_len]
        raw = pagec.decode_blocks(enc)
        out = np.zeros((ft.n_words,), np.uint32)
        got = np.frombuffer(raw, np.uint32)
        out[:got.size] = got
        return out

    def note_access(self, ft: FTable) -> bool:
        """Record a request touching `ft`; promote when the hysteresis
        threshold trips (`promote_after` hits within `promote_window`
        seconds). String extents promote on FIRST access — their dispatch
        path needs raw pages, so staying cold has no fused-decode discount.
        Returns True when the access triggered a promotion."""
        te = self._tier.get(ft.table_id)
        if te is None:
            return False
        if te.is_str:
            self._promote_str(ft)
            return True
        now = time.monotonic()
        te.hits.append(now)
        while te.hits and te.hits[0] < now - self.promote_window:
            te.hits.popleft()
        if len(te.hits) >= self.promote_after:
            self.promote_table(ft)
            return True
        return False

    def tier_desc(self, ft: FTable) -> tuple:
        """The table's decode descriptors as int32 tensors on the pool's
        device (the tuple kernels/tier.py consumes, `base` as bit
        patterns), uploaded without a host sync and cached per table until
        the next demote/promote flips them."""
        cached = self._tier_dev.get(ft.table_id)
        if cached is not None:
            return cached
        te = self._tier.get(ft.table_id)
        if te is None or te.is_str:
            raise ValueError(f"table {ft.name!r} has no word-tier entry")
        desc = ktier.tier_tensors((te.phys, te.mode, te.width, te.base,
                                   te.dictoff, te.bitoff), self.device)
        self._tier_dev[ft.table_id] = desc
        return desc

    def tier_desc_stacked(self, fts: list[FTable], n_pages: int) -> tuple:
        """Each table's descriptors padded to `n_pages` rows with the null
        descriptor (mode RAW + the pinned null page) and stacked
        (B, n_pages[, C]) on the pool's device, `base` as bit patterns:
        what a batched round passes so different-sized tiered tables share
        one dispatch — padding pages read zeros, exactly like the flat
        path's null-page padding. Built there from each table's cached
        descriptors, so a warm round uploads nothing and never syncs (the
        reference's `tier_desc_padded`, one row a table)."""
        descs = [self.tier_desc(ft) for ft in fts]
        b, c = len(fts), int(descs[0][1].shape[1])

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32,
                              device=self.device)
        out = (full((b, n_pages), self.null_page),
               full((b, n_pages, c), pagec.MODE_RAW),
               full((b, n_pages, c), 1), full((b, n_pages, c), 0),
               full((b, n_pages, c), 0), full((b, n_pages, c), 0))
        for i, d in enumerate(descs):
            for dst, src in zip(out, d):
                dst[i, : src.shape[0]] = src
        return out

    def tier_read_bytes(self, ft: FTable, col_idx=None) -> int:
        """PHYSICAL bytes a full read of `ft` (optionally only `col_idx`
        columns) pulls from memory: raw pages bill their logical words,
        cold pages their packed plane words + dictionaries — the 'compressed
        bytes on the wire' half of the tiering accounting contract. The
        reference's per-page loop, summed over all pages at once."""
        te = self._tier.get(ft.table_id)
        if te is None:
            if col_idx is None:
                return ft.n_bytes
            return ft.n_rows * len(col_idx) * WORD_BYTES
        if te.is_str:
            blob_words = (te.blob_len + WORD_BYTES - 1) // WORD_BYTES
            return blob_words * WORD_BYTES
        hot = int(np.sum(te.counts[~te.cold]
                         if col_idx is None
                         else te.counts[~te.cold][:, list(col_idx)]))
        if col_idx is None:
            cold = int(np.sum(te.span[te.cold, 1].astype(np.int64)))
        else:
            cols = np.asarray(col_idx, np.int64)
            cnt = te.counts[te.cold][:, cols]
            bits = cnt * te.width[te.cold][:, cols].astype(np.int64)
            cold = int(np.sum((bits + 31) // 32
                              + te.dictlen[te.cold][:, cols]))
        return (hot + cold) * WORD_BYTES

    def tier_summary(self) -> dict:
        """Capacity accounting for the hierarchy: resident logical bytes
        vs the physical frames holding them, plus the effective-capacity
        multiplier (logical bytes the pool serves per byte of memory it
        actually occupies)."""
        logical = sum(self._logical.values())
        used_pages = self.n_pages - self.free_pages
        physical = used_pages * self.page_bytes
        cold_pages = sum(int(te.cold.sum()) for te in self._tier.values())
        return dict(self.tier_stats, cold_pages=cold_pages,
                    logical_bytes=logical, physical_bytes=physical,
                    effective_capacity=(logical / physical
                                        if physical else 0.0))
