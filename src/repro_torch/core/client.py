"""Farview programmatic interface + multi-client scheduler (port of
`repro/core/client.py`: rows-kind verbs, the small-table join and
groups-kind verbs over word tables; RegexMatch over string tables).

Mirrors the paper's API surface:

    open_connection(node)          -> QPair   (assigns a dynamic region)
    alloc_table_mem / free_table_mem
    table_read / table_write / table_read_rows     (plain one-sided reads)
    farview_request(qp, ft, pipeline) -> result    (the Farview verb)
    submit_request(qp, ft, pipeline)  -> pending   (async verb; node.flush()
                                                    runs the scheduler)
    merge_group_partials(ft, pipeline, partials)   (client-side group merge)

A `FViewNode` owns a FarPool on one device and a fixed set of dynamic
regions. Submitted requests queue on the node; each scheduling round serves
at most one request per QPair in round-robin order (the paper's fair-share
arbiter, §4.3), and picked requests with the same pipeline signature, table
layout and power-of-two row bucket are coalesced into ONE stacked dispatch
(`CompiledPipeline.run_pages_batched`): page lists are padded with the
pool's pinned null page and each request's tail is masked by its n_valid.
A string table's request carries its bytes (`strings=` / `lengths=`, and
`row_ids=` for a partition of a larger table); string requests coalesce
on (signature, row bucket, width bucket) into one stacked
`CompiledPipeline.run_strings_batched` round, the width exact under a
pre-Crypt.

Memory tiering: a word table demoted to the pool's cold tier
(`node.pool.demote_table`) dispatches with its decode descriptors, and the
plan's gather decodes its cold pages on the device in the same dispatch; tiered
tables ride their own stacks (the tier bit is part of the dispatch key),
each request billed the physical bytes its gather reads. Every submitted
verb and plain read counts toward promotion (`FarPool.note_access`).

Dispatch is asynchronous: results are lazy `PipelineResult`s whose
`finalize()` is the only synchronization point. Read bytes settle at
dispatch; shipped bytes (data-dependent) settle at finalize; reading a
QPair's counters settles its node first.

The node runs on the CUDA card unless it is built with `device="cpu"`:
`FViewNode(device=None)` means "cuda" and raises where there is none.
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import operators as op_ir
from repro_torch.core.errors import DeadlineExceededError, FarviewError, NodeDeadError, PageCodecError  # noqa: F401,E501
from repro_torch.core.offload import _merge
from repro_torch.core.pipeline import (PipelineResult, compile_pipeline,
                                      resolve_device)
from repro_torch.core.pool import PAGE_BYTES, FarPool, TableTier
from repro_torch.core.table import Column, FTable, WORD_BYTES
from repro_torch.kernels import ref as kref


class QPair:
    """Connection state: ids, region binding, transfer accounting.

    Byte counters settle lazily: reading `bytes_shipped` / `bytes_read_pool`
    first finalizes any in-flight responses on the owning node."""

    def __init__(self, qp_id: int, node: "FViewNode", region: int):
        self.qp_id = qp_id
        self.node = node
        self.region = region
        self.requests = 0
        self._bytes_shipped = 0
        self._bytes_read_pool = 0

    @property
    def bytes_shipped(self) -> int:
        self.node.settle()
        return self._bytes_shipped

    @property
    def bytes_read_pool(self) -> int:
        self.node.settle()
        return self._bytes_read_pool


class PageCache:
    """Bounded client-side partition cache with versioned invalidation.

    Entries are keyed `(table_name, partition_index)` and stamped with the
    partition's epoch at fill time. Every lookup presents the CURRENT epoch;
    a mismatch drops the stale copy on sight and misses. LRU over bytes:
    `capacity_bytes` bounds the sum of cached row matrices. Cached arrays
    are private read-only copies. Thread-safe."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(
                f"PageCache needs a positive byte budget, got "
                f"{capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        # (name, part) -> (epoch, rows); insertion order = LRU order
        self._entries: OrderedDict = OrderedDict()   # guarded-by: self._lock
        self._bytes = 0                              # guarded-by: self._lock
        self.hits = 0                                # guarded-by: self._lock
        self.misses = 0                              # guarded-by: self._lock
        self.evictions = 0                           # guarded-by: self._lock
        self.invalidations = 0                       # guarded-by: self._lock

    def get(self, name: str, part: int, epoch: int):
        key = (name, part)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            cached_epoch, rows = ent
            if cached_epoch != epoch:
                del self._entries[key]
                self._bytes -= rows.nbytes
                self.invalidations += 1
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return rows

    def put(self, name: str, part: int, epoch: int,
            rows: np.ndarray) -> None:
        rows = np.array(rows, copy=True)
        rows.setflags(write=False)
        if rows.nbytes > self.capacity_bytes:
            return          # would evict everything else for one entry
        key = (name, part)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1].nbytes
            self._entries[key] = (epoch, rows)
            self._bytes += rows.nbytes
            while self._bytes > self.capacity_bytes:
                _, (_, dropped) = self._entries.popitem(last=False)
                self._bytes -= dropped.nbytes
                self.evictions += 1

    def drop_table(self, name: str) -> int:
        """Forget every partition of `name`."""
        with self._lock:
            stale = [k for k in self._entries if k[0] == name]
            for key in stale:
                _, rows = self._entries.pop(key)
                self._bytes -= rows.nbytes
            return len(stale)

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations}


@dataclass
class DynamicRegion:
    region_id: int
    loaded_signature: tuple | None = None   # which pipeline is "configured"
    reconfigurations: int = 0
    busy_qp: int | None = None


@dataclass
class PendingRequest:
    """A submitted Farview verb awaiting a scheduling round."""
    qp: QPair
    ft: FTable
    pipeline: tuple
    row_ids: np.ndarray | None = None   # original-table row indices
    lengths: np.ndarray | None = None   # string table: (n,) int32 lengths
    strings: np.ndarray | None = None   # string table: (n, w) uint8 bytes
    result: PipelineResult | None = None
    error: Exception | None = None      # dispatch-time failure (this request)
    deadline_at: float | None = None    # time.monotonic() budget expiry

    def wait(self) -> PipelineResult:
        """Dispatch (if still queued) and materialize the response. A
        failure of another group's dispatch in the same flush does not fail
        this request when its own group dispatched."""
        if self.result is None and self.error is None:
            try:
                self.qp.node.flush()
            except Exception:
                if self.result is None and self.error is None:
                    raise
        if self.error is not None:
            raise self.error
        return self.result.finalize()


class FViewNode:
    """One smart disaggregated memory node: a paged `FarPool` on `device`,
    a fixed set of dynamic regions, and the bucket-batched scheduler.

    `capacity_bytes` sizes the pool in `page_bytes` pages (2 MiB);
    `n_regions` bounds concurrent connections; `n_shards` stripes pool
    pages across shards; `promote_after` / `promote_window` set the cold
    tier's promotion hysteresis (`FarPool`); `device=None` means the CUDA
    card."""

    def __init__(self, capacity_bytes: int = 64 * 2**20, *, n_regions: int = 6,
                 n_shards: int = 1, node_id: int = 0,
                 page_bytes: int = PAGE_BYTES, promote_after: int = 3,
                 promote_window: float = 60.0, device=None):
        self.device = resolve_device(device, "FViewNode")
        self.pool = FarPool(capacity_bytes, device=self.device,
                            page_bytes=page_bytes, n_shards=n_shards,
                            promote_after=promote_after,
                            promote_window=promote_window)
        self.node_id = node_id
        self.regions = [DynamicRegion(i) for i in range(n_regions)]
        self._qp_counter = itertools.count()
        self._qpairs: dict[int, QPair] = {}
        self._rr = 0
        self.tables: dict[str, FTable] = {}     # name -> handle (catalog)
        self._queue: deque[PendingRequest] = deque()
        self._inflight: list[PipelineResult] = []
        self.dispatches = 0     # stacked dispatches: one per (signature,
        #                         layout, bucket) group per round

    # ----------------------------------------------------------- connections
    def open_connection(self) -> QPair:
        free = [r for r in self.regions if r.busy_qp is None]
        if not free:
            raise FarviewError("no free dynamic region (all regions bound)")
        region = free[0]
        qp = QPair(qp_id=next(self._qp_counter), node=self,
                   region=region.region_id)
        region.busy_qp = qp.qp_id
        self._qpairs[qp.qp_id] = qp
        return qp

    def close_connection(self, qp: QPair) -> None:
        """Unbind the region and fail the QPair's still-queued requests (a
        later flush must not dispatch them against a region that may then
        be bound to another connection)."""
        still: deque[PendingRequest] = deque()
        for req in self._queue:
            if req.qp is qp:
                req.error = FarviewError(
                    f"connection qp{qp.qp_id} closed with request pending")
            else:
                still.append(req)
        self._queue = still
        self.regions[qp.region].busy_qp = None
        self._qpairs.pop(qp.qp_id, None)

    # -------------------------------------------------------------- scheduler
    def submit(self, qp: QPair, ft: FTable, pipeline: tuple, *,
               lengths: np.ndarray | None = None,
               strings: np.ndarray | None = None,
               row_ids: np.ndarray | None = None,
               deadline_s: float | None = None) -> PendingRequest:
        """Queue a Farview verb; dispatched at the next scheduling round.
        A string table's request carries its bytes: `strings` (n, w) uint8
        and `lengths` (n,) int32; its `row_ids` (n,), one a row, key a
        pre-Crypt's keystream. `deadline_s` is the remaining budget:
        past it the request is shed (typed `DeadlineExceededError`)
        instead of dispatched."""
        if qp.qp_id not in self._qpairs:
            raise FarviewError(f"connection qp{qp.qp_id} is closed")
        pipeline = op_ir.validate_pipeline(tuple(pipeline))
        if strings is not None or ft.str_width:
            strings, lengths, row_ids = _string_sideband(ft, strings,
                                                         lengths, row_ids)
        # tiering hysteresis: every submitted verb is an access. Word tables
        # promote only after `promote_after` hits in the window (a lone cold
        # scan runs decoded in the dispatch); string tables promote at once
        # (their dispatch reads the byte sideband: no decode path to stay on)
        self.pool.note_access(ft)
        req = PendingRequest(qp, ft, pipeline, row_ids=row_ids,
                             lengths=lengths, strings=strings)
        if deadline_s is not None:
            if deadline_s <= 0:     # dead on arrival: shed, never queued
                req.error = DeadlineExceededError(self.node_id, op="submit")
                return req
            req.deadline_at = time.monotonic() + float(deadline_s)
        self._queue.append(req)
        return req

    def flush(self) -> None:
        """Drain the queue in scheduling rounds: each round serves at most
        one request per QPair (rotating the service order), coalesces the
        picks by dispatch key and dispatches every group as ONE stacked
        pass. A failed group's error is attached to its requests and the
        first one re-raised after the queue drains."""
        first_err: Exception | None = None
        while self._queue:
            picks: list[PendingRequest] = []
            seen: set[int] = set()
            rest: deque[PendingRequest] = deque()
            now = time.monotonic()
            for req in self._queue:
                if req.deadline_at is not None and now >= req.deadline_at:
                    # budget spent while queued: shed BEFORE dispatch
                    req.error = DeadlineExceededError(
                        self.node_id, op="dispatch")
                    if first_err is None:
                        first_err = req.error
                elif req.qp.qp_id in seen:
                    rest.append(req)
                else:
                    seen.add(req.qp.qp_id)
                    picks.append(req)
            self._queue = rest
            if not picks:
                continue
            k = self._rr % len(picks)
            picks = picks[k:] + picks[:k]       # rotate the arbiter
            self._rr += 1
            groups: dict[tuple, list[PendingRequest]] = {}
            for req in picks:
                groups.setdefault(self._dispatch_key(req), []).append(req)
            for reqs in groups.values():
                try:
                    self._dispatch(reqs)
                except Exception as e:
                    for req in reqs:
                        req.error = e
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err

    def settle(self) -> None:
        """Dispatch everything queued and materialize in-flight responses.
        Dispatch errors stay attached to their own PendingRequest."""
        try:
            self.flush()
        except Exception:
            pass
        inflight, self._inflight = self._inflight, []
        for res in inflight:
            res.finalize()

    def _dispatch_key(self, req: PendingRequest) -> tuple:
        """The coalescing key: requests with equal keys ride one stacked
        dispatch this round. Layout is column names and dtypes (what the
        plan cache keys on); sizes enter only as power-of-two buckets;
        partitioned requests (row_ids) ride their own stacks. String
        requests bucket on (rows, width); a pre-crypt pins the width
        exactly because the CTR keystream is positional over the
        row-major byte flattening (row padding appends whole rows and
        never shifts it). Tiered word tables ride their own stacks: their
        plan takes the decode descriptors."""
        sig = op_ir.signature(req.pipeline)
        ids = req.row_ids is not None
        layout = (tuple((c.name, c.dtype) for c in req.ft.columns),
                  bool(req.ft.str_width))
        if req.strings is not None:
            n, w = req.strings.shape
            wkey = (int(w) if op_ir.has_crypt_pre(req.pipeline)
                    else op_ir.pow2_bucket(w))
            return ("str", sig, layout, op_ir.pow2_bucket(n), wkey, ids)
        return ("word", sig, layout, req.ft.row_words,
                op_ir.pow2_bucket(req.ft.n_rows), ids,
                self.pool.is_tiered(req.ft))

    def _resolve_build(self, pipeline: tuple):
        """The node reads the join build table into "on-chip memory"
        (paper §Conclusions future work) and matches the stream against it.
        The read runs on the node's device at every dispatch and is billed
        to the pool, as the reference node bills it; the build is named by
        its table id and write generation, under which the pipeline caches
        its verdict that the keys are unique."""
        join = op_ir.join_small_of(pipeline)
        if join is None:
            return None
        bft = self.tables[join.build_table]
        brows = self.pool.read_table(bft)
        bkeys = kref.rint_to_int32(brows[:, bft.col_index(join.build_key)])
        # column by column: an index list would upload with a host sync
        cols = [brows[:, bft.col_index(c)] for c in join.build_cols]
        bvals = torch.stack(cols, 1) if cols else brows[:, :0]
        name = ("build", bft.table_id, self.pool.generation(bft))
        return bkeys, bvals, name

    def _dispatch(self, reqs: list[PendingRequest]) -> None:
        ft0 = reqs[0].ft
        sig = op_ir.signature(reqs[0].pipeline)
        # homogeneous by dispatch key: a group is all-tiered or all-flat
        tiered = reqs[0].strings is None and self.pool.is_tiered(ft0)
        pipe = compile_pipeline(ft0, reqs[0].pipeline)
        for req in reqs:
            region = self.regions[req.qp.region]
            if region.loaded_signature != sig:
                region.loaded_signature = sig   # "partial reconfiguration"
                region.reconfigurations += 1
        if len(reqs) == 1 and reqs[0].strings is not None:
            req = reqs[0]
            results = [pipe(req.strings, req.row_ids, lengths=req.lengths,
                            device=self.device)]
        elif len(reqs) == 1:
            req = reqs[0]
            tier = pw = phys = None
            if tiered:
                tier = self.pool.tier_desc(req.ft)
                pw = self.pool.page_words
                phys = self.pool.tier_read_bytes(req.ft, pipe.read_cols)
            results = [pipe.run_pages(self.pool.buf, req.ft.pages,
                                      req.ft.n_rows,
                                      self._resolve_build(req.pipeline),
                                      n_rows=req.ft.n_rows,
                                      row_words=req.ft.row_words,
                                      row_ids=req.row_ids, tier=tier,
                                      page_words=pw, read_bytes=phys)]
        elif reqs[0].strings is not None:
            results = self._dispatch_strings_batched(pipe, reqs)
        else:
            results = self._dispatch_pages_batched(pipe, reqs, tiered)
        self.dispatches += 1        # counted only once the launch succeeded
        for req, res in zip(reqs, results):
            req.result = res
            self._account(req, res)

    def _dispatch_pages_batched(self, pipe, reqs,
                                tiered: bool) -> list[PipelineResult]:
        """Stacked word-table round: pad every page list to the shape
        bucket with the pool's pinned null page; the stacked pass reads
        zeros past each table's extent and n_valid masks them."""
        row_words = reqs[0].ft.row_words
        bucket = op_ir.shape_bucket(max(r.ft.n_rows for r in reqs))
        n_pages = max(1, math.ceil(bucket * row_words * WORD_BYTES
                                   / self.pool.page_bytes))
        pages = np.full((len(reqs), n_pages), self.pool.null_page, np.int64)
        for b, r in enumerate(reqs):
            pages[b, : len(r.ft.pages)] = r.ft.pages
        n_valid = np.asarray([r.ft.n_rows for r in reqs], np.int64)
        row_ids = None
        if reqs[0].row_ids is not None:     # homogeneous by dispatch key
            row_ids = np.zeros((len(reqs), bucket), np.int64)
            for b, r in enumerate(reqs):
                row_ids[b, : r.ft.n_rows] = r.row_ids    # tails masked
        tier = pw = phys = None
        if tiered:
            # each request's decode descriptors, padded to the bucket's
            # page count with null-descriptor rows (mode RAW over the
            # pinned null page: reads zeros, masked by n_valid), stacked on
            # the device from the pool's per-table cache
            tier = self.pool.tier_desc_stacked([r.ft for r in reqs], n_pages)
            pw = self.pool.page_words
            phys = [self.pool.tier_read_bytes(r.ft, pipe.read_cols)
                    for r in reqs]
        return pipe.run_pages_batched(self.pool.buf, pages, n_valid,
                                      self._resolve_build(reqs[0].pipeline),
                                      n_rows=bucket, row_words=row_words,
                                      row_ids=row_ids, tier=tier,
                                      page_words=pw, read_bytes=phys)

    def _dispatch_strings_batched(self, pipe, reqs) -> list[PipelineResult]:
        """Stacked string round: each request's bytes zero-padded to the
        round's quarter-octave (rows, width) bucket and stacked, on the
        card straight into pinned host memory, so the stack crosses in one
        non-blocking upload with no staging copy. Padded rows carry length
        0 and are masked by n_valid. A row's length is cut to its own
        request's width, so no request consumes the padding bytes of a
        wider neighbour (the JAX node does: ROADMAP.md queue 3). Widths
        stay exact when the key pinned them (pre-crypt keystream).
        Partitioned requests' row ids stack as (B, bucket rows), the padded
        rows' ids 0 (their rows are masked), in int64 as the word path
        stacks them: the pipeline wraps them to int32."""
        mats = [r.strings for r in reqs]
        bucket_n = op_ir.shape_bucket(max(m.shape[0] for m in mats))
        bucket_w = (mats[0].shape[1] if op_ir.has_crypt_pre(reqs[0].pipeline)
                    else max(op_ir.shape_bucket(m.shape[1]) for m in mats))
        pin = self.device.type == "cuda"
        stacked = torch.empty((len(reqs), bucket_n, bucket_w),
                              dtype=torch.uint8, pin_memory=pin)
        lengths = torch.empty((len(reqs), bucket_n), dtype=torch.int32,
                              pin_memory=pin)
        s, ln = stacked.numpy(), lengths.numpy()
        for b, (m, r) in enumerate(zip(mats, reqs)):
            n, w = m.shape
            s[b, :n, :w] = m
            s[b, :n, w:] = 0
            s[b, n:] = 0
            np.minimum(r.lengths, w, out=ln[b, :n])
            ln[b, n:] = 0
        n_valid = [m.shape[0] for m in mats]
        widths = [m.shape[1] for m in mats]
        row_ids = None
        if reqs[0].row_ids is not None:     # homogeneous by dispatch key
            row_ids = np.zeros((len(reqs), bucket_n), np.int64)
            for b, (m, r) in enumerate(zip(mats, reqs)):
                row_ids[b, : m.shape[0]] = r.row_ids     # tails masked
        return pipe.run_strings_batched(stacked, lengths, n_valid,
                                        widths=widths, row_ids=row_ids,
                                        device=self.device)

    def _account(self, req: PendingRequest, res: PipelineResult) -> None:
        qp = req.qp
        qp.requests += 1
        qp._bytes_read_pool += res.read_bytes           # static: settle now
        self.pool.stats.bytes_read += res.read_bytes
        self.pool.stats.requests += 1

        def _credit(r, qp=qp):                          # data-dependent:
            qp._bytes_shipped += r._shipped              # settle at finalize
            self.pool.stats.bytes_shipped += r._shipped
            try:                        # settled results stop pinning memory
                self._inflight.remove(r)
            except ValueError:
                pass                    # already drained by settle()

        self._inflight.append(res)
        res.on_finalize(_credit)


def _string_sideband(ft: FTable, strings, lengths, row_ids) -> tuple:
    """A string table's request bytes, checked: (strings (n, w) uint8,
    lengths (n,) int32, row_ids None or (n,) int64, one a row) as numpy
    arrays."""
    if not ft.str_width:
        raise ValueError(f"strings= carries a string table's bytes; "
                         f"{ft.name!r} is a word table")
    if strings is None or lengths is None:
        raise ValueError(f"a request over string table {ft.name!r} carries "
                         "its bytes: strings= and lengths=")
    strings = np.asarray(strings, np.uint8)
    lengths = np.asarray(lengths, np.int32)
    if strings.ndim != 2 or lengths.shape != strings.shape[:1]:
        raise ValueError(f"strings (n, w) and lengths (n,), got "
                         f"{strings.shape} and {lengths.shape}")
    if row_ids is not None:
        row_ids = np.asarray(row_ids, np.int64)
        if row_ids.shape != lengths.shape:
            raise ValueError(f"row_ids hold one id a row: ({len(lengths)},) "
                             f"ids, got {row_ids.shape}")
    return strings, lengths, row_ids


def load_node_state(node: FViewNode, buf: np.ndarray,
                    catalog: list[dict]) -> dict[str, FTable]:
    """Rebuild `node`'s pool from a pool image and a plain catalog.

    `buf` is a pool buffer (`np.asarray(jax_node.pool.buf)` of a reference
    node of the same capacity and page size); each catalog entry is a dict
    with `name`, `columns` (column names), optional `dtypes`, `n_rows`,
    optional `str_width`, `pages` and `table_id`, and, for a table with
    cold pages, `tier`: its tier entry as plain data (`TableTier`'s fields
    as numpy arrays and ints, `frames` a mapping of cold frame -> the
    logical pages it holds, `blob` and `blob_len` of a string extent). The
    tables land in the node's catalog with the same placement and tiers.
    Returns them by name."""
    tables, tiers = [], {}
    for ent in catalog:
        dtypes = ent.get("dtypes") or ["f32"] * len(ent["columns"])
        ft = FTable(
            name=ent["name"],
            columns=tuple(Column(c, d) for c, d in zip(ent["columns"],
                                                       dtypes)),
            n_rows=int(ent["n_rows"]),
            str_width=int(ent.get("str_width", 0)),
            table_id=int(ent["table_id"]),
            pages=tuple(int(p) for p in ent["pages"]))
        tables.append(ft)
        if ent.get("tier") is not None:
            tiers[ft.table_id] = TableTier.from_arrays(ent["tier"])
    node.pool.adopt(buf, tables, tiers)
    node.tables = {ft.name: ft for ft in tables}
    return dict(node.tables)


def open_connection(node: FViewNode) -> QPair:
    return node.open_connection()


def close_connection(qp: QPair) -> None:
    qp.node.close_connection(qp)


# --------------------------------------------------------------------- memory
def alloc_table_mem(qp: QPair, ft: FTable) -> FTable:
    """Allocate pool pages for `ft` on the connection's node (paper §4.2):
    fills its placement (`table_id`, `pages`) and registers it in the
    node's catalog. Raises `MemoryError` when the pool lacks free pages."""
    ft = qp.node.pool.alloc_table(ft)
    qp.node.tables[ft.name] = ft
    return ft


def free_table_mem(qp: QPair, ft: FTable) -> None:
    qp.node.pool.free_table(ft)


def table_write(qp: QPair, ft: FTable, words) -> None:
    qp.node.pool.write_table(ft, words)


def table_read(qp: QPair, ft: FTable) -> torch.Tensor:
    """Plain one-sided read: ships the whole table (no push-down).

    A tiered extent bills its PHYSICAL bytes — the compressed stream is
    what crosses the wire; the decode (on the device for word pages, the
    block codec for string extents) rebuilds the logical rows
    byte-identically. `tier_read_bytes` is `ft.n_bytes` for flat tables.
    The read counts toward promotion."""
    pool = qp.node.pool
    pool.note_access(ft)
    phys = pool.tier_read_bytes(ft)
    rows = pool.read_table(ft)
    qp._bytes_shipped += phys
    qp._bytes_read_pool += phys
    qp.requests += 1
    return rows


def table_read_rows(qp: QPair, ft: FTable, row_idx) -> torch.Tensor:
    """Row-subset one-sided read: ships only the selected LOCAL rows."""
    rows = qp.node.pool.read_rows(ft, row_idx)
    n_bytes = int(np.asarray(row_idx).size) * ft.row_words * WORD_BYTES
    qp._bytes_shipped += n_bytes
    qp._bytes_read_pool += n_bytes
    qp.requests += 1
    return rows


# ------------------------------------------------------------- Farview verb
def submit_request(qp: QPair, ft: FTable, pipeline: tuple, *,
                   lengths: np.ndarray | None = None,
                   strings: np.ndarray | None = None,
                   row_ids: np.ndarray | None = None) -> PendingRequest:
    """Async Farview verb: queue on the node. `node.flush()` dispatches;
    requests from different QPairs sharing a signature coalesce into one
    stacked dispatch per scheduling round."""
    return qp.node.submit(qp, ft, pipeline, lengths=lengths, strings=strings,
                          row_ids=row_ids)


def farview_request(qp: QPair, ft: FTable, pipeline: tuple, *,
                    lengths: np.ndarray | None = None,
                    strings: np.ndarray | None = None,
                    row_ids: np.ndarray | None = None) -> PipelineResult:
    """The paper's extra one-sided verb: read + operator pipeline push-down.
    Returns a lazy `PipelineResult`; touch `.count` / `.shipped_bytes` or
    call `.finalize()` to sync. String tables (regex) pass their byte
    matrix via `strings=` + `lengths=`: their bytes are a sideband of the
    request, not pool pages."""
    req = submit_request(qp, ft, pipeline, lengths=lengths, strings=strings,
                         row_ids=row_ids)
    try:
        qp.node.flush()
    except Exception:
        # a different queued request's dispatch failed; ours may be fine
        if req.result is None and req.error is None:
            raise
    if req.error is not None:
        raise req.error
    return req.result


def merge_group_partials(ft: FTable, pipeline: tuple,
                         partials: list[PipelineResult]) -> PipelineResult:
    """Client-side software merge (overflow buffers, multi-node partials).

    Groups-kind partials — each a compact bucket table plus packed
    collision rows — concatenate and fold in ONE device-side segment
    reduce (offload.merge_groups_device); only the per-key totals cross
    back to the host dict {key: [count, sum, min, max]}. The cluster's
    rows-kind and mask-kind merges (and their `n_rows` / `part_rows`
    extras) come with ROADMAP.md queue 1, slice 6."""
    return _merge(ft, pipeline, partials)
