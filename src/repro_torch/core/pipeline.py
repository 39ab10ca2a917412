"""Pipeline compiler (port of `repro/core/pipeline.py`): the rows kind
(with the small-table join) and the groups kind over word tables, and
the mask kind (RegexMatch) over string tables.

`compile_pipeline(schema, pipeline)` returns a `CompiledPipeline` whose
request path — pool-page gather, pre-decrypt, smart addressing, join
probe, fused select/project/pack or group-aggregate, post-encrypt and
response byte accounting — runs as one sequence of device operations
with no host round trip. On the card the cipher passes, the join probe,
the select/project/pack pass and the grouping passes are the
hand-written CUDA kernels of `repro_torch.kernels`; on the CPU their
plain torch versions run (`kernels/ops.py` dispatches on the tensor's
device).

A string table's bytes do not live in the pool: each request carries them
as a sideband, (n, w) uint8 strings and (n,) int32 lengths. Its pipeline
holds a RegexMatch, whose DFA is compiled once when the plan is built and
uploaded once per device; a pre-Crypt deciphers the bytes first (the
byte-stream cipher `ops.crypt_bytes`, keyed by each byte's position in
its request, or by row_id * w + col given row ids), then the `dfa_match`
kernel returns a match mask, one byte a row shipped, and every later
stage is skipped (a post-Crypt too), as in the reference.

Entry points (each takes an optional `row_ids` for partition dispatch,
and a JoinSmall pipeline its build as `build=(keys, vals)`):

  pipe(rows, device=...)                       rows already materialized
  pipe.run_pages(buf, pages, n_valid, ...)     gather + pipeline, one request
  pipe.run_pages_batched(buf, pages, n_valid, ...)   stacked round: pages
      (B, P), n_valid (B,). The stack axis B is explicit all the way down:
      every kernel takes it in its grid, with a per-request n_valid; one
      join build serves the whole stack.
  Over a tiered table, both page entry points take the pool's decode
      descriptors as `tier=` (one request's, or a (B, ...) stack) and
      `page_words=` in place of the page list, and the physical bytes the
      gather reads as `read_bytes=`; the gather then decodes cold pages
      (`kernels/tier.py`) and the body is the same. One plan serves both
      tiers: the operand alone picks the gather.
  pipe(strings, lengths=..., device=...)       one string request
  pipe.run_strings_batched(strings, lengths, n_valid, widths=...)
      stacked string round: strings (B, n, w), lengths (B, n), and
      row_ids (B, n) for partitioned requests.

Every entry point returns lazy `PipelineResult`s: device tensors plus
device count/byte scalars. `PipelineResult.finalize()` is the ONLY sync
point: for groups it also copies the packed collision rows to the host.

Under SmartAddress the body sees only the addressed columns, and the
grouping, distinct and probe-key columns are resolved among them (a
column the SmartAddress does not read raises KeyError at construction).
The JAX pipeline indexes that narrowed work with full-schema indices,
which clamp to other columns; the port gives the result of the JAX
`Project` form instead (ROADMAP.md queue 3).

A string table's pipeline without RegexMatch is refused at construction
(the JAX pipeline runs it over the raw bytes as the rows kind; ROADMAP.md
queue 3).
"""
from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.core import operators as op_ir
from repro_torch.core import pool as fpool
from repro_torch.core.errors import FarviewError
from repro_torch.core.regex import compile_regex
from repro_torch.core.table import FTable, WORD_BYTES
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import tier as ktier
from repro_torch.kernels._build import upload as _upload
from repro_torch.kernels.dfa_match import prepare_dfa

_DROP_KEY = kref.KEY_SENTINEL + 1     # masked-row group key (never in data)

# join builds whose keys were found unique, by the name their caller
# gives them (the node's: build table id and write generation)
_UNIQUE_BUILDS: set = set()      # guarded-by: _UNIQUE_LOCK
_UNIQUE_LOCK = threading.Lock()
_UNIQUE_MAX = 4096               # names kept before the set starts over


def resolve_device(device, caller: str) -> torch.device:
    """An entry point's device: None means the CUDA card, and raises where
    there is none rather than run the plain versions on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise FarviewError(
                f"{caller}(device=None) runs on the CUDA card and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor's values as a numpy array, copied from the card
    through pinned memory (a pageable copy runs at a fraction of the
    link's rate)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


class PipelineResult:
    """Lazy response handle: device tensors + device count/byte scalars.

    `finalize()` is the only synchronization point — it converts the count
    and shipped-byte scalars to Python ints, copies the survivor ids and
    the group-overflow collision rows to the host, and fires accounting
    callbacks. Scalar properties (`count`, `groups`, `shipped_bytes`,
    `sel_ids`) finalize on first access; `rows` and `mask` hand back the
    raw device tensors without forcing a sync.
    """

    def __init__(self, kind: str, *, groups: dict | None = None,
                 shipped_bytes: int = 0, read_bytes: int = 0,
                 _raw: dict | None = None, _meta: dict | None = None):
        self.kind = kind                # "rows" | "groups" | "mask"
        self.read_bytes = read_bytes    # static: bytes pulled from pool memory
        self._rows = None
        self._count = None
        self._groups = groups
        self._mask = None
        self._shipped = shipped_bytes
        self._ids = None                # survivors' original row ids, or None
        self._raw = _raw                # unfinalized payload
        self._meta = _meta or {}
        self._callbacks: list[Callable] = []

    @property
    def rows(self):
        if self._raw is not None and "rows" in self._raw:
            return self._raw["rows"]
        return self._rows

    @property
    def mask(self):
        """Mask kind: the (n,) bool match mask, a device tensor."""
        if self._raw is not None and "mask" in self._raw:
            return self._raw["mask"]
        return self._mask

    @property
    def groups(self):
        """Groups kind: bucket_keys / count (n_buckets,) and sum, min,
        max (n_buckets, V) device tensors, `drop_key`, and the collision
        rows `ovf_keys` (n,) / `ovf_vals` (n, V) as host numpy arrays."""
        self.finalize()
        return self._groups

    @property
    def count(self):
        self.finalize()
        return self._count

    @property
    def shipped_bytes(self):
        self.finalize()
        return self._shipped

    @property
    def sel_ids(self):
        """Survivors' original row ids (np.int64, len == count) when the
        request was dispatched with explicit `row_ids`; None otherwise."""
        self.finalize()
        return self._ids

    def on_finalize(self, cb: Callable) -> None:
        """Run `cb(self)` once the response is materialized (accounting)."""
        if self._raw is None:
            cb(self)
        else:
            self._callbacks.append(cb)

    def finalize(self) -> "PipelineResult":
        """Materialize the response — the request path's only sync point.
        Idempotent and cheap after the first call."""
        if self._raw is not None:
            raw, self._raw = self._raw, None
            if self.kind == "groups":
                self._finalize_groups(raw)
            elif self.kind == "mask":
                self._mask = raw["mask"]
                self._shipped = int(raw["shipped"])
            else:
                self._rows = raw["rows"]
                self._count = int(raw["count"])
                self._shipped = int(raw["shipped"])
                if "ids" in raw:
                    ids = raw["ids"][: self._count].cpu().numpy()
                    self._ids = np.rint(ids).astype(np.int64)
        if self._callbacks:
            cbs, self._callbacks = self._callbacks, []
            for cb in cbs:
                cb(self)
        return self

    def _finalize_groups(self, raw: dict) -> None:
        # the paper's collision buffer: overflow rows ship to the client
        # for software post-aggregation. They are already packed to the
        # front of ovf_keys/ovf_vals on the device, so only the
        # `ovf_count` collision rows cross to the host.
        n_ovf = int(raw["ovf_count"])
        self._groups = dict(
            bucket_keys=raw["bucket_keys"], count=raw["count"],
            sum=raw["sum"], min=raw["min"], max=raw["max"],
            drop_key=self._meta.get("drop_key"),
            ovf_keys=_to_host(raw["ovf_keys"][:n_ovf]),
            ovf_vals=_to_host(raw["ovf_vals"][:n_ovf]))
        self._shipped = int(raw["shipped"])


class CompiledPipeline:
    """The resolved plan of one (schema layout, pipeline signature)."""

    def __init__(self, schema: FTable, pipeline: tuple):
        pipeline = op_ir.validate_pipeline(tuple(pipeline))
        if (any(isinstance(op, op_ir.JoinSmall) for op in pipeline)
                and any(isinstance(op, (op_ir.GroupBy, op_ir.Distinct))
                        for op in pipeline)):
            raise ValueError("JoinSmall composes with select/project only")
        self.signature = op_ir.signature(pipeline)
        self._cols = tuple(c.name for c in schema.columns)
        self._n_cols = len(self._cols)

        a = self._n_cols or 1
        self.sel_ops = np.zeros((a,), np.int32)
        self.sel_vals = np.zeros((a,), np.float32)
        self.proj_mask = np.ones((a,), np.float32)
        self.proj_cols: list[int] | None = None
        self.smart = False
        self.crypt_pre: op_ir.Crypt | None = None
        self.crypt_post: op_ir.Crypt | None = None
        self.group: op_ir.GroupBy | None = None
        self.distinct: op_ir.Distinct | None = None
        self.join: op_ir.JoinSmall | None = None
        self.regex: tuple | None = None    # host DFA: (table, accept)
        self._dfa: dict = {}               # guarded-by: self._dfa_lock
        self._dfa_lock = threading.Lock()
        for op in pipeline:
            if isinstance(op, op_ir.Project):
                self.proj_cols = [self._col(c) for c in op.cols]
                self.proj_mask = np.zeros((self._n_cols,), np.float32)
                self.proj_mask[self.proj_cols] = 1.0
            elif isinstance(op, op_ir.SmartAddress):
                self.proj_cols = [self._col(c) for c in op.cols]
                self.smart = True
            elif isinstance(op, op_ir.Select):
                for p in op.predicates:
                    i = self._col(p.col)
                    self.sel_ops[i] = op_ir.OPS[p.op]
                    self.sel_vals[i] = p.value
            elif isinstance(op, op_ir.GroupBy):
                self.group = op
            elif isinstance(op, op_ir.Distinct):
                self.distinct = op
            elif isinstance(op, op_ir.JoinSmall):
                self.join = op
            elif isinstance(op, op_ir.RegexMatch):
                self.regex = compile_regex(op.pattern)
            elif isinstance(op, op_ir.Crypt):
                if op.when == "pre":
                    self.crypt_pre = op
                else:
                    self.crypt_post = op
        if schema.str_width:
            if self.regex is None:
                raise NotImplementedError(
                    "string tables run RegexMatch only in the port: the JAX "
                    "pipeline runs other verbs over their raw bytes as the "
                    "rows kind, which the port refuses (ROADMAP.md queue 3)")
        elif self.regex is not None:
            raise ValueError("RegexMatch runs over a string table "
                             "(str_width > 0)")
        self.kind = ("mask" if self.regex is not None else
                     "groups" if (self.group is not None
                                  or self.distinct is not None) else "rows")
        # the columns the body reads, as indices into the work it sees
        grouping = self.group or self.distinct
        if grouping is not None:
            nb = grouping.n_buckets
            if nb < 1 or nb & (nb - 1):
                raise ValueError(f"n_buckets must be a power of 2, got {nb}")
        if self.group is not None:
            self.key_col = self._work_col(self.group.key)
            self.val_cols = [self._work_col(c) for c in self.group.values]
        elif self.distinct is not None:
            self.key_col = self._work_col(self.distinct.cols[0])
            self.val_cols = [self.key_col]
        if self.join is not None:
            self.probe_col = self._work_col(self.join.probe_key)

    def _col(self, name: str) -> int:
        try:
            return self._cols.index(name)
        except ValueError:
            raise KeyError(f"no column {name!r}") from None

    def _work_col(self, name: str) -> int:
        """Column `name`'s index in the work the body sees: among
        SmartAddress's columns when the plan narrows (a column it does not
        read raises KeyError), else among the table's."""
        i = self._col(name)
        if not self.smart:
            return i
        try:
            return self.proj_cols.index(i)
        except ValueError:
            read = tuple(self._cols[c] for c in self.proj_cols)
            raise KeyError(f"column {name!r} is not among the columns "
                           f"SmartAddress reads {read}") from None

    @property
    def response_width(self) -> int:
        """Column count of the packed response buffer: narrowed to the
        projection under smart addressing, otherwise the full table width;
        a join adds its build columns and the (zeroed) hit column."""
        if self.smart and self.proj_cols is not None:
            width = len(self.proj_cols)
        else:
            width = self._n_cols
        if self.join is not None:
            width += len(self.join.build_cols) + 1
        return width

    # ------------------------------------------------------------ public API
    def __call__(self, rows, row_ids=None, *, lengths=None, build=None,
                 device=None) -> PipelineResult:
        """Rows already materialized: (n, w) f32, numpy or a tensor, moved
        to `device` (None means the CUDA card; pass "cpu" for the plain
        versions). `row_ids` (optional, (n,)) are the rows' indices in the
        original un-partitioned table: they key the positional CTR
        keystream and ride the packing as survivor ids. `build` is a
        JoinSmall pipeline's build table (see `_as_build`). A string
        table's rows are (n, w) uint8 bytes with (n,) int32 `lengths`,
        uploaded through pinned memory (its row ids key only a
        pre-decrypt); its mask ships n bytes and reads n * w."""
        device = resolve_device(device, "CompiledPipeline.__call__")
        if self.kind == "mask":
            if lengths is None:
                raise ValueError("a string table's rows need their lengths")
            strings = _upload(rows, torch.uint8, device)
            lens = _upload(lengths, torch.int32, device)
            if strings.dim() != 2 or tuple(lens.shape) != strings.shape[:1]:
                raise ValueError(f"strings (n, w) and lengths (n,), got "
                                 f"{tuple(strings.shape)} and "
                                 f"{tuple(lens.shape)}")
            n, w = strings.shape
            nv = torch.full((1,), n, dtype=torch.int32, device=device)
            payload = self._strings_body(
                strings[None], lens[None], nv, np.asarray([n]),
                self._as_ids(row_ids, device, 1, n))
            return self._wrap(self._split(payload, 0, n), n * w)
        rows = torch.as_tensor(rows, dtype=torch.float32).to(device)
        n = int(rows.shape[0])
        n_valid = torch.full((1,), n, dtype=torch.int32, device=rows.device)
        payload = self._body(rows[None], n_valid,
                             self._as_ids(row_ids, rows.device, 1, n),
                             self._as_build(build, rows.device),
                             narrowed=False)
        if self._columnar_read():
            read_bytes = n * len(self.proj_cols) * WORD_BYTES
        else:
            read_bytes = int(np.prod(rows.shape)) * WORD_BYTES
        return self._wrap(self._split(payload, 0, n), read_bytes)

    def run_pages(self, buf: torch.Tensor, pages, n_valid: int, build=None,
                  *, n_rows: int, row_words: int, row_ids=None, tier=None,
                  page_words: int | None = None,
                  read_bytes: int | None = None) -> PipelineResult:
        """The fused request verb for one request: page gather + pipeline.

        buf: pool buffer (n_pages, page_words); pages: (P,) page ids;
        n_valid: rows >= n_valid are masked; build: a JoinSmall
        pipeline's build table; row_ids: optional (n_rows,) original-table
        row indices. Over a tiered table, `tier` is the pool's descriptor
        tuple (`FarPool.tier_desc`), in place of `pages`, and `page_words`
        the frame width; `read_bytes` overrides the logical read
        accounting with the physical (compressed) bytes the tiered gather
        pulls."""
        if tier is None:
            pages = _upload(pages, torch.int64, buf.device)[None]
        else:
            pages, tier = None, tuple(t[None] for t in tier)
        nv = torch.full((1,), int(n_valid), dtype=torch.int32,
                        device=buf.device)
        payload = self._gather_run(
            buf, pages, nv, self._as_ids(row_ids, buf.device, 1, n_rows),
            self._as_build(build, buf.device), n_rows, row_words, tier,
            page_words)
        return self._wrap(self._split(payload, 0, n_rows),
                          self._pages_read_bytes(n_rows, row_words)
                          if read_bytes is None else read_bytes)

    def run_pages_batched(self, buf: torch.Tensor, pages, n_valid,
                          build=None, *, n_rows: int, row_words: int,
                          row_ids=None, tier=None,
                          page_words: int | None = None,
                          read_bytes: list[int] | None = None
                          ) -> list[PipelineResult]:
        """Stacked multi-client dispatch: pages (B, P), n_valid (B,) host ints.

        One pass over the whole stack serves the scheduling round; the
        payload is split back into per-client lazy results. A JoinSmall
        `build` is one table shared by the whole stack. `n_rows` is the
        round's shape bucket: per-request tables may be smaller, their page
        lists padded with the pool null page and their tails masked by
        `n_valid`. Read bytes bill each request's own rows; shipped bytes
        come from device counts that already exclude masked rows; each
        request's rows are sliced back to its own length. Over tiered
        tables it takes, in place of `pages`, the stacked descriptors
        `tier` (each field (B, P[, C])), `page_words` and per-request
        physical `read_bytes`."""
        pages = (_upload(pages, torch.int64, buf.device)
                 if tier is None else None)
        nv = np.asarray(n_valid, np.int64)
        b = int(nv.shape[0])
        payload = self._gather_run(
            buf, pages, _upload(nv, torch.int32, buf.device),
            self._as_ids(row_ids, buf.device, b, n_rows),
            self._as_build(build, buf.device), n_rows, row_words, tier,
            page_words)
        return [self._wrap(self._split(payload, i, int(nv[i])),
                           self._pages_read_bytes(int(nv[i]), row_words)
                           if read_bytes is None else int(read_bytes[i]))
                for i in range(b)]

    def run_strings_batched(self, strings, lengths, n_valid, *,
                            widths=None, row_ids=None,
                            device=None) -> list[PipelineResult]:
        """Stacked string round: strings (B, n, w) uint8 bytes, lengths
        (B, n) int32 (numpy, host tensors — a pinned one is uploaded
        without a copy — or tensors on `device`), n_valid (B,) host ints,
        row_ids None or (B, n) original-table row ids (partitioned
        requests; they key a pre-decrypt's keystream).

        One byte-cipher launch (under a pre-Crypt) and one dfa_match
        launch serve the whole stack. Rows past a request's n_valid
        (bucket padding) are deciphered at wrong positions, then masked
        out of its match mask and excluded from shipped/read accounting;
        `widths` (each request's byte width before padding) keeps the read
        accounting exact under width bucketing. Under a pre-Crypt every
        width must be the stack's: padded columns would shift the
        keystream. Each request's mask is cut back to its own length."""
        device = resolve_device(device,
                                "CompiledPipeline.run_strings_batched")
        if self.kind != "mask":
            raise ValueError("run_strings_batched runs a RegexMatch pipeline "
                             "over a string table")
        strings = _upload(strings, torch.uint8, device)
        lengths = _upload(lengths, torch.int32, device)
        nv = np.asarray(n_valid, np.int64)
        b, n, w = strings.shape
        ws = (np.full((b,), w, np.int64) if widths is None
              else np.asarray(widths, np.int64))
        if self.crypt_pre is not None and np.any(ws != w):
            raise ValueError(f"a pre-decrypt keys the keystream by the exact "
                             f"row width: widths {ws.tolist()} in a stack of "
                             f"width {w}")
        payload = self._strings_body(strings, lengths,
                                     _upload(nv, torch.int32, device),
                                     np.clip(nv, 0, n),
                                     self._as_ids(row_ids, device, b, n))
        return [self._wrap(self._split(payload, i, int(nv[i])),
                           int(nv[i]) * int(ws[i]))
                for i in range(b)]

    @staticmethod
    def _split(payload: dict, b: int, nv: int) -> dict:
        """Request b's slice of a stacked payload, row-shaped tensors cut
        back to the request's own length (packed survivors and collision
        rows always fit: count <= nv)."""
        out = {}
        for k, v in payload.items():
            v = v[b]
            if k in ("rows", "mask", "ids", "ovf_keys", "ovf_vals"):
                v = v[:nv]
            out[k] = v
        return out

    # -------------------------------------------------------------- internals
    @staticmethod
    def _as_ids(row_ids, device, b: int, n: int):
        """(b, n) int32 ids on `device`, one a row, wrapped mod 2^32 as the
        reference's int32 cast wraps them."""
        if row_ids is None:
            return None
        ids = np.asarray(row_ids, np.int64)
        if ids.ndim < 1 or ids.shape[-1] != n or ids.size != b * n:
            raise ValueError(f"row_ids must hold one id a row: ({b}, {n}) "
                             f"ids, got shape {ids.shape}")
        return _upload(ids.reshape(b, n).astype(np.int32), torch.int32,
                       device)

    def _as_build(self, build, device):
        """A JoinSmall pipeline's build operand on `device`: (keys (K,)
        int32, vals (K, V) f32) from `build` = (keys, vals) or (keys, vals,
        name). Its keys are checked unique on the host before launch, as
        the reference checks them eagerly. `name`, a hashable name of the
        build's content (the node gives its build table's id and write
        generation), caches the verdict: a build already found unique is
        not read back again, so a warm round does not wait for the card.
        Other pipelines take no build (and ignore one, as the reference
        does)."""
        if self.join is None:
            return None
        if build is None:
            raise ValueError("JoinSmall needs build=(keys, vals)")
        keys, vals, *name = build
        keys = torch.as_tensor(keys).to(device=device, dtype=torch.int32)
        vals = torch.as_tensor(vals).to(device=device, dtype=torch.float32)
        v = len(self.join.build_cols)
        if vals.dim() != 2 or tuple(vals.shape) != (keys.shape[0], v):
            raise ValueError(f"the build's values are {tuple(vals.shape)}, "
                             f"the join needs ({keys.shape[0]}, {v}) value "
                             "columns")
        key = name[0] if name else None
        with _UNIQUE_LOCK:
            known = key is not None and key in _UNIQUE_BUILDS
        if not known:
            kops.check_build_unique(keys)
            if key is not None:
                with _UNIQUE_LOCK:
                    if len(_UNIQUE_BUILDS) >= _UNIQUE_MAX:
                        _UNIQUE_BUILDS.clear()
                    _UNIQUE_BUILDS.add(key)
        return keys, vals

    @property
    def read_cols(self) -> tuple[int, ...] | None:
        """Column indices a column-granular gather touches, or None when
        the plan reads full rows — what the tiered dispatch passes to
        `FarPool.tier_read_bytes` so physical billing matches the gather."""
        return tuple(self.proj_cols) if self._columnar_read() else None

    def _columnar_read(self) -> bool:
        """True when the plan gathers column-granular (a pre-decrypt forces
        full-row reads: the CTR keystream is positional over the row)."""
        return (self.smart and self.proj_cols is not None
                and self.crypt_pre is None)

    def _pages_read_bytes(self, n_rows: int, row_words: int) -> int:
        if self._columnar_read():
            # column-granular pool reads (paper §5.2, Fig. 7)
            return n_rows * len(self.proj_cols) * WORD_BYTES
        return n_rows * row_words * WORD_BYTES

    def _wrap(self, payload: dict, read_bytes: int) -> PipelineResult:
        # drop_key is always published for groups: select masking and
        # n_valid tail masking both remap dropped rows to _DROP_KEY, and
        # real keys never collide with it (ingest enforces |key| < 2^24)
        meta = {"drop_key": _DROP_KEY} if self.kind == "groups" else None
        return PipelineResult(self.kind, read_bytes=read_bytes, _raw=payload,
                              _meta=meta)

    def _gather_run(self, buf, pages, n_valid, row_ids, build, n_rows,
                    row_words, tier=None, page_words=None):
        """The pool read of a (B, ...) stack, then the body: the page
        gather, or given a tier operand the descriptors' decode (cold pages
        unpacked, raw pages read as they are)."""
        if self.kind == "mask":
            raise ValueError("a string table's bytes ride its request, not "
                             "the pool: call the pipeline with lengths= or "
                             "run_strings_batched")
        if self._columnar_read():
            if tier is not None:
                work = ktier.gather_columns_tiered(
                    buf, tier, n_rows, row_words, self.proj_cols, page_words)
            else:
                work = fpool.gather_columns(
                    buf, pages, n_rows, row_words,
                    _upload(self.proj_cols, torch.int64, buf.device))
            return self._body(work, n_valid, row_ids, build, narrowed=True)
        if tier is not None:
            rows = ktier.gather_rows_tiered(buf, tier, n_rows, row_words,
                                            page_words)
        else:
            rows = fpool.gather_rows(buf, pages, n_rows, row_words)
        return self._body(rows, n_valid, row_ids, build, narrowed=False)

    def _body(self, work: torch.Tensor, n_valid: torch.Tensor,
              row_ids: torch.Tensor | None, build, *,
              narrowed: bool) -> dict:
        """The whole request pipeline over a (B, n, w) stack of requests."""
        b, n, w = work.shape

        # -- pre-decrypt (data at rest is encrypted; cipher on read stream) --
        if self.crypt_pre is not None:
            idx = None
            if row_ids is not None:
                # partitioned dispatch: each row's keystream position is its
                # offset in the ORIGINAL row-major flattening (mod 2^32)
                pos = (row_ids.to(torch.int64)[:, :, None] * w
                       + torch.arange(w, device=work.device)) & 0xFFFFFFFF
                idx = torch.where(pos >= 2**31, pos - 2**32,
                                  pos).to(torch.int32).reshape(b, n * w)
            words = work.contiguous().view(torch.int32).reshape(b, n * w)
            dec = kops.crypt(words, self.crypt_pre.key, self.crypt_pre.nonce,
                             idx=idx)
            work = dec.view(torch.float32).reshape(b, n, w)

        # -- smart addressing narrows columns (unless gathered narrowed) -----
        if self.smart and self.proj_cols is not None:
            if not narrowed:
                work = work[..., _upload(self.proj_cols, torch.int64,
                                         work.device)]
            eff_sel_ops = self.sel_ops[self.proj_cols]
            eff_sel_vals = self.sel_vals[self.proj_cols]
            eff_proj = np.ones((len(self.proj_cols),), np.float32)
        else:
            eff_sel_ops = self.sel_ops
            eff_sel_vals = self.sel_vals
            eff_proj = self.proj_mask

        # -- grouping ---------------------------------------------------------
        if self.kind == "groups":
            return self._group_body(work, eff_sel_ops, eff_sel_vals, n_valid)

        # -- the widened select/project input: the join's matched build
        # values and an ==1 hit column (kept for the predicate, zeroed in
        # the projection), then the survivor-id column of partitioned
        # dispatch (predicate-skipped, projection-kept; split off before the
        # response encrypt). The probe writes the rows and its columns
        # straight into it.
        w = work.shape[2]
        v = 0 if self.join is None else build[1].shape[1]
        n_extra = (0 if self.join is None else v + 1) + (row_ids is not None)
        if n_extra:
            wide = torch.empty((b, n, w + n_extra), dtype=torch.float32,
                               device=work.device)
            if self.join is None:
                wide[..., :w] = work
            else:
                kops.hash_join(work, self.probe_col, build[0], build[1],
                               n_valid, out=wide)
            work = wide
        if self.join is not None:
            eff_sel_ops = np.concatenate(
                [eff_sel_ops, np.zeros(v, np.int32),
                 np.asarray([op_ir.OPS["=="]], np.int32)])
            eff_sel_vals = np.concatenate(
                [eff_sel_vals, np.zeros(v, np.float32),
                 np.asarray([1.0], np.float32)])
            eff_proj = np.concatenate(
                [eff_proj, np.ones(v, np.float32), np.zeros(1, np.float32)])
        # response width BEFORE the id column: the projected columns
        ncols_out = int(np.sum(eff_proj))
        if row_ids is not None:
            work[..., -1] = row_ids.to(torch.float32)
            eff_sel_ops = np.append(eff_sel_ops, np.int32(0))
            eff_sel_vals = np.append(eff_sel_vals, np.float32(0))
            eff_proj = np.append(eff_proj, np.float32(1))

        # -- selection + projection + packing (fused) -------------------------
        packed, count = kops.select_project(work.contiguous(), eff_sel_ops,
                                            eff_sel_vals, eff_proj, n_valid)
        ids_packed = None
        if row_ids is not None:
            ids_packed = packed[:, :, -1]
            packed = packed[:, :, :-1]

        # -- post-encrypt + pack ----------------------------------------------
        if self.crypt_post is not None:
            c = packed.shape[2]
            words = packed.contiguous().view(torch.int32).reshape(b, n * c)
            enc = kops.crypt(words, self.crypt_post.key,
                             self.crypt_post.nonce)
            packed = enc.view(torch.float32).reshape(b, n, c)

        shipped = count * (ncols_out * WORD_BYTES)
        out = {"rows": packed, "count": count, "shipped": shipped}
        if ids_packed is not None:
            out["ids"] = ids_packed
        return out

    def _strings_body(self, strings: torch.Tensor, lengths: torch.Tensor,
                      n_valid: torch.Tensor, shipped: np.ndarray,
                      row_ids: torch.Tensor | None) -> dict:
        """RegexMatch over the (B, n, w) byte stack, deciphered first under
        a pre-Crypt (into a new stack: the caller's bytes stay as they
        are): the match mask of the rows below n_valid, and a 1-byte
        decision per valid row (`shipped`, host ints: the reference's count
        of valid rows). Every other stage is skipped, a post-Crypt too, as
        in the reference."""
        if self.crypt_pre is not None and strings.numel():
            b, n, w = strings.shape
            strings = kops.crypt_bytes(
                strings.reshape(b, n * w), self.crypt_pre.key,
                self.crypt_pre.nonce, row_ids, w).view(b, n, w)
        table, accept = self._dfa_on(strings.device)
        mask = kops.regex_match(strings, lengths, table, accept, n_valid)
        return {"mask": mask, "shipped": shipped}

    def _dfa_on(self, device: torch.device) -> tuple:
        """The DFA's (table, accept) on `device`, uploaded on first use
        there (pinned, non-blocking) and kept for every later dispatch."""
        with self._dfa_lock:
            found = self._dfa.get(device)
            if found is None:
                found = self._dfa[device] = prepare_dfa(*self.regex, device)
        return found

    def _group_body(self, work: torch.Tensor, sel_ops, sel_vals,
                    n_valid: torch.Tensor) -> dict:
        """Grouping over the (B, n, w) stack: selected rows below n_valid
        aggregate into the bucket tables; the others carry _DROP_KEY (and
        still claim buckets, as in the reference)."""
        kcol, vcols = self.key_col, self.val_cols
        nb = (self.group or self.distinct).n_buckets
        b, n, _ = work.shape
        v = len(vcols)
        keys, vals = kops.group_prep(work.contiguous(), kcol, vcols, sel_ops,
                                     sel_vals, n_valid, _DROP_KEY)
        res = kops.group_aggregate(keys, vals, nb)
        keep = res["overflow_mask"] & (keys != _DROP_KEY)
        # the collision partial: overflow rows packed to the front in
        # original order by the select/project pass (keep as an ==1
        # predicate column, keys as int32 words copied bitwise), so the
        # response ships nb buckets + the actual collision rows
        table = torch.empty((b, n, v + 2), dtype=torch.float32,
                            device=work.device)
        table[..., 0] = keys.view(torch.float32)
        table[..., 1:1 + v] = vals
        table[..., v + 1] = keep
        ops = np.zeros(v + 2, np.int32)
        ops[-1] = op_ir.OPS["=="]
        vals_k = np.zeros(v + 2, np.float32)
        vals_k[-1] = 1.0
        proj = np.ones(v + 2, np.float32)
        proj[-1] = 0.0
        every_row = torch.full((b,), n, dtype=torch.int32, device=work.device)
        packed, keep_cnt = kops.select_project(table, ops, vals_k, proj,
                                               every_row)
        shipped = (nb * (2 + 4 * v) * WORD_BYTES
                   + keep_cnt * ((1 + v) * WORD_BYTES))
        return {"bucket_keys": res["bucket_keys"], "count": res["count"],
                "sum": res["sum"], "min": res["min"], "max": res["max"],
                "ovf_keys": packed[..., 0].view(torch.int32),
                "ovf_vals": packed[..., 1:1 + v], "ovf_count": keep_cnt,
                "shipped": shipped}


_CACHE: dict = {}                # guarded-by: _CACHE_LOCK
_CACHE_LOCK = threading.Lock()


def compile_pipeline(schema: FTable, pipeline: tuple) -> CompiledPipeline:
    """Fetch (or build) the plan for (schema layout, signature).

    The key deliberately excludes the table *name*: two clients running the
    same pipeline over same-layout tables share one plan, which is what lets
    the node's scheduler coalesce them into a stacked dispatch. The key
    mirrors the reference's (`repro/core/pipeline.py` compile_pipeline)
    minus its lowering field, which the port does not have, and its tier
    field: a jitted executable is traced per operand set, while one plan
    here serves flat and tiered tables, its gather picked by the `tier`
    operand."""
    pipeline = op_ir.validate_pipeline(tuple(pipeline))
    key = (tuple((c.name, c.dtype) for c in schema.columns),
           bool(schema.str_width), op_ir.signature(pipeline))
    with _CACHE_LOCK:
        pipe = _CACHE.get(key)
        if pipe is None:
            pipe = _CACHE[key] = CompiledPipeline(schema, pipeline)
    return pipe


def cache_builds() -> int:
    """How many plans `compile_pipeline` has built in this process (the
    cache never evicts, so its size is the build count)."""
    with _CACHE_LOCK:
        return len(_CACHE)
