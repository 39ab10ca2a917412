"""Hash grouping (distinct / group-by) over a stack of requests.

Replaces the Pallas kernel `src/repro/kernels/hash_group.py:171`
(`group_aggregate`, with `_block_kernel` and `tree_merge`) and the XLA
glue around it: the bucket hash, the first-claim ownership and the
overflow mask. The CUDA passes are in `csrc/hash_group.cu`, whose header
states the contract and the design.

What bounds it on the card: bytes. The function reads each row's key and
values once and writes a byte of overflow mask per row plus small bucket
tables. Two hand-written paths, chosen from n_buckets alone
(`direct_chunk`):

* the direct path, wherever a block's bucket tables for one value column
  fit in shared memory (up to 4096 buckets): no sort; a claim pass (each
  bucket's first row by integer atomicMin), then blocks over contiguous
  row ranges fixed by the request's row count alone (so a request gives
  the same bits alone or stacked) that read keys and values in order,
  reduce each warp's rows of one bucket by a fixed tree over the lanes
  and fold the blocks in block order, once for each chunk of value
  columns the shared memory holds (1024 buckets: 5 a chunk);
* the sort path, past that (8192 buckets and more): the stable sort of
  bucket ids (`torch.sort`), then pieces of at most 4096 sorted rows a
  block, each row read through the sorted order (scattered), folded per
  bucket in piece order, the value columns in chunks of 16 over the one
  sort.

Neither uses a float atomic, so two launches are bitwise equal, and a hot
bucket (skewed keys, the drop-key bucket of a selective predicate) costs
no more than any other. Any table width and any number of value columns
run: the prologue reads its plan from device memory.

Two wrappers, each with a plain torch version and a launch counter:

  group_prep(table, kcol, vcols, sel_ops, sel_vals, n_valid, drop_key)
      the grouping prologue of `repro/core/pipeline.py::_group_body`:
      predicate and n_valid mask, keys = rint(table[..., kcol]) saturated
      to int32, dropped rows -> drop_key with zero values. Returns keys
      (B, N) int32 and values (B, N, V) f32.
  group_aggregate(keys, values, n_buckets)
      the contract of `repro.kernels.ref.group_aggregate`, field for
      field, for each request of a (B, N) stack.

`group_prep` and `group_aggregate` launch the kernels and take CUDA
tensors only; `*_plain` compute the same in plain torch, which the CPU
path and the on-card comparison use.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import select_project as _sp


_INT32_MAX = 2**31 - 1
# Copies of `hash_group.cu`'s direct_smem, kSmemLimit and kMaxVals, so that
# the path is chosen on the host without the library: per bucket its
# claimed key, count and not-owned flag (12 bytes), and per value column a
# min key, a max key and a sum for each of 8 warps (40 bytes); within a
# block's 227 KB on sm_90, at most 16 columns a chunk. A `cuda` test holds
# direct_chunk to the library's hg_direct_chunk.
_SMEM_BYTES = 232448
_MAX_CHUNK = 16


def direct_chunk(n_buckets: int) -> int:
    """The value columns the direct path aggregates a pass at n_buckets,
    or 0 where the sort path runs (past 4096 buckets): a function of
    n_buckets alone, so the path never depends on the data, the number of
    value columns or the card."""
    return max(0, min(_MAX_CHUNK, (_SMEM_BYTES // n_buckets - 12) // 40))


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel: its inputs must be "
                         "CUDA tensors")


def _plan(table, kcol, vcols, sel_ops, sel_vals):
    c = table.shape[-1]
    ops = np.ascontiguousarray(np.asarray(sel_ops, np.int32).reshape(-1))
    vals = np.ascontiguousarray(np.asarray(sel_vals, np.float32).reshape(-1))
    cols = np.ascontiguousarray(np.asarray(vcols, np.int32).reshape(-1))
    if not ops.shape == vals.shape == (c,):
        raise ValueError(f"plan arrays must have {c} entries, got "
                         f"{ops.shape}, {vals.shape}")
    if not 0 <= kcol < c or cols.size == 0 or cols.min() < 0 \
            or cols.max() >= c:
        raise ValueError(f"key column {kcol} / value columns {cols.tolist()} "
                         f"out of range for {c} columns")
    return ops, vals, cols


def group_prep(table: torch.Tensor, kcol: int, vcols, sel_ops, sel_vals,
               n_valid: torch.Tensor, drop_key: int):
    """Launch the prologue kernel. table (B, N, C) f32 on the card;
    sel_ops (C,) int32 / sel_vals (C,) f32 / vcols (V,) host arrays;
    n_valid (B,) int32 on the card. Returns (keys (B, N) int32, values
    (B, N, V) f32), unsynchronised."""
    _check(table, "group_prep")
    if table.dtype != torch.float32 or table.dim() != 3:
        raise ValueError(f"table must be (B, N, C) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b, n, c = table.shape
    if (n_valid.device != table.device or n_valid.dtype != torch.int32
            or tuple(n_valid.shape) != (b,)):
        raise ValueError("n_valid must be a (B,) int32 tensor on the "
                         "table's device")
    ops, vals, cols = _plan(table, kcol, vcols, sel_ops, sel_vals)
    pred = _sp.predicate_words(ops, vals)
    lib = _build.lib("hash_group.cu")
    if n >= 2**31:
        raise ValueError("group_prep takes fewer than 2^31 rows a request")
    v = int(cols.size)
    keys = torch.empty((b, n), dtype=torch.int32, device=table.device)
    out = torch.empty((b, n, v), dtype=torch.float32, device=table.device)
    if n == 0 or b == 0:
        return keys, out
    table = table.contiguous()
    n_valid = n_valid.contiguous()
    # the plan: the compacted predicate, then the value columns
    plan = _build.upload(np.concatenate([pred, cols]), torch.int32,
                         table.device)
    with torch.cuda.device(table.device):
        _build.check(lib.hg_prep(
            table.data_ptr(), plan.data_ptr(), len(pred) // 3, c, kcol, v,
            n_valid.data_ptr(), int(drop_key), keys.data_ptr(),
            out.data_ptr(), n, b, torch.cuda.current_stream().cuda_stream),
            lib.hg_error_string, "group_prep")
    group_prep.launches += 1
    return keys, out


group_prep.launches = 0


def group_prep_plain(table: torch.Tensor, kcol: int, vcols, sel_ops,
                     sel_vals, n_valid: torch.Tensor, drop_key: int):
    """The prologue in plain torch, on the table's device: same arguments
    and results as `group_prep`."""
    ops, vals, cols = _plan(table, kcol, vcols, sel_ops, sel_vals)
    n = table.shape[1]
    rows = torch.arange(n, dtype=torch.int32, device=table.device)
    m = rows[None, :] < n_valid.to(table.device)[:, None]
    m = m & ref.eval_predicate(table, torch.from_numpy(ops),
                               torch.from_numpy(vals))
    keys = torch.where(m, ref.rint_to_int32(table[..., kcol]),
                       int(drop_key)).to(torch.int32)
    picked = table[..., torch.from_numpy(cols.astype(np.int64)).to(
        table.device)]
    return keys, torch.where(m[..., None], picked, 0.0)


def _check_group_args(keys: torch.Tensor, values: torch.Tensor,
                      n_buckets: int) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"keys must be (B, N) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if (values.dtype != torch.float32 or values.dim() != 3
            or values.shape[:2] != keys.shape
            or values.device != keys.device):
        raise ValueError("values must be (B, N, V) float32 on the keys' "
                         "device")
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of 2, got {n_buckets}")


def group_aggregate(keys: torch.Tensor, values: torch.Tensor,
                    n_buckets: int) -> dict:
    """Launch the grouping kernels. keys (B, N) int32 and values (B, N, V)
    f32 on the card. Returns the dict of `ref.group_aggregate` (bucket_keys
    (B, n_buckets), count, sum/min/max (B, n_buckets, V), overflow_mask
    (B, N) bool), on the card, unsynchronised."""
    _check(keys, "group_aggregate")
    _check_group_args(keys, values, n_buckets)
    b, n = keys.shape
    v = values.shape[2]
    dev = keys.device
    lib = _build.lib("hash_group.cu")
    if v < 1:
        raise ValueError("group_aggregate takes at least one value column")
    if n >= 2**31:
        raise ValueError("group_aggregate takes fewer than 2^31 rows a "
                         "request")
    overflow = torch.empty((b, n), dtype=torch.bool, device=dev)
    if n == 0 or b == 0:        # nothing to aggregate: every bucket empty
        claimed = torch.full((b, n_buckets), ref.KEY_SENTINEL,
                             dtype=torch.int32, device=dev)
        return dict(bucket_keys=claimed, count=torch.zeros_like(claimed),
                    sum=torch.zeros((b, n_buckets, v), device=dev),
                    min=torch.full((b, n_buckets, v), ref.F32_BIG,
                                   device=dev),
                    max=torch.full((b, n_buckets, v), -ref.F32_BIG,
                                   device=dev), overflow_mask=overflow)
    keys = keys.contiguous()
    values = values.contiguous()
    path = _direct if direct_chunk(n_buckets) else _sorted
    out = path(lib, keys, values, n_buckets, overflow)
    group_aggregate.launches += 1
    return out


group_aggregate.launches = 0


def _direct(lib, keys, values, n_buckets, overflow) -> dict:
    """The direct path: the claim, then the aggregation and the merge of
    each chunk of value columns, on the current stream."""
    b, n = keys.shape
    v = values.shape[2]
    dev = keys.device
    chunk = min(v, direct_chunk(n_buckets))
    p = lib.hg_direct_parts(n)
    first = torch.full((b, n_buckets), _INT32_MAX, dtype=torch.int32,
                       device=dev)
    pcount = torch.empty((b, p, n_buckets), dtype=torch.int32, device=dev)
    part = [torch.empty((b, p, n_buckets, chunk), dtype=torch.float32,
                        device=dev) for _ in range(3)]
    claimed = torch.empty((b, n_buckets), dtype=torch.int32, device=dev)
    count = torch.empty_like(claimed)
    out = [torch.empty((b, n_buckets, v), dtype=torch.float32, device=dev)
           for _ in range(3)]
    with torch.cuda.device(dev):
        _build.check(lib.hg_direct(
            keys.data_ptr(), values.data_ptr(), first.data_ptr(),
            overflow.data_ptr(), pcount.data_ptr(),
            *(t.data_ptr() for t in part), claimed.data_ptr(),
            count.data_ptr(), *(t.data_ptr() for t in out), n, v, chunk, b,
            n_buckets, p, torch.cuda.current_stream().cuda_stream),
            lib.hg_error_string, "group_aggregate (direct path)")
    return dict(bucket_keys=claimed, count=count, sum=out[0], min=out[1],
                max=out[2], overflow_mask=overflow)


def _sorted(lib, keys, values, n_buckets, overflow) -> dict:
    """The sort path: bucket ids sorted stably, pieces of the sorted
    stream, value columns in chunks of hg_max_vals."""
    b, n = keys.shape
    v = values.shape[2]
    dev = keys.device
    claimed = torch.full((b, n_buckets), ref.KEY_SENTINEL,
                         dtype=torch.int32, device=dev)
    start = torch.zeros((b, n_buckets), dtype=torch.int32, device=dev)
    end = torch.zeros((b, n_buckets), dtype=torch.int32, device=dev)
    count = torch.empty((b, n_buckets), dtype=torch.int32, device=dev)
    out = [torch.empty((b, n_buckets, v), dtype=torch.float32, device=dev)
           for _ in range(3)]
    bucket = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.hg_bucket(keys.data_ptr(), bucket.data_ptr(), n, b,
                                   n_buckets, stream),
                     lib.hg_error_string, "group_aggregate bucket pass")
        # the stable sort by bucket id, along each request
        sorted_bucket, order = torch.sort(bucket, dim=-1, stable=True)
        del bucket
        _build.check(lib.hg_claim(
            sorted_bucket.data_ptr(), order.data_ptr(), keys.data_ptr(),
            claimed.data_ptr(), start.data_ptr(), end.data_ptr(), n, b,
            n_buckets, stream), lib.hg_error_string,
            "group_aggregate claim pass")
        # each bucket's segment splits into pieces of at most piece_rows
        # sorted positions, one block each; their prefix sum over buckets
        piece_rows = lib.hg_piece_rows()
        pieces = (end - start + (piece_rows - 1)) // piece_rows
        piece_incl = torch.cumsum(pieces, dim=1, dtype=torch.int32)
        n_pieces = -(-n // piece_rows) + n_buckets
        # the value columns in chunks of at most hg_max_vals (the piece
        # block's accumulators), each over the one sort and piece split
        chunk = min(v, lib.hg_max_vals())
        pcount = torch.empty((b, n_pieces), dtype=torch.int32, device=dev)
        partial = [torch.empty((b, n_pieces, chunk), dtype=torch.float32,
                               device=dev) for _ in range(3)]
        for j0 in range(0, v, chunk):
            _build.check(lib.hg_aggregate(
                order.data_ptr(), keys.data_ptr(), values.data_ptr(),
                claimed.data_ptr(), start.data_ptr(), end.data_ptr(),
                piece_incl.data_ptr(), pcount.data_ptr(),
                *(t.data_ptr() for t in partial), count.data_ptr(),
                *(t.data_ptr() for t in out), n, v, j0, min(chunk, v - j0),
                b, n_buckets, n_pieces, stream), lib.hg_error_string,
                "group_aggregate aggregate pass")
        _build.check(lib.hg_overflow(
            keys.data_ptr(), claimed.data_ptr(), overflow.data_ptr(), n, b,
            n_buckets, stream), lib.hg_error_string,
            "group_aggregate overflow pass")
    return dict(bucket_keys=claimed, count=count, sum=out[0], min=out[1],
                max=out[2], overflow_mask=overflow)


def group_aggregate_plain(keys: torch.Tensor, values: torch.Tensor,
                          n_buckets: int) -> dict:
    """The kernel's function in plain torch, on the keys' device: same
    arguments and results as `group_aggregate`."""
    _check_group_args(keys, values, n_buckets)
    return ref.group_aggregate(keys, values, n_buckets)
