"""The kernel entry points the pipeline calls (port of `repro/kernels/ops.py`).

Each function dispatches on the device of the tensor it is given: a CUDA
tensor launches the hand-written kernel (and raises if it cannot), a CPU
tensor runs the kernel's plain torch version. There is no other switch and
no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ctr_crypt as _ctr
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dfa_match as _dfa
from repro_torch.kernels import hash_group as _hg
from repro_torch.kernels import hash_join as _hj
from repro_torch.kernels import ref
from repro_torch.kernels import select_project as _sp


def _pick(t: torch.Tensor, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {t.device}")


def select_project(table: torch.Tensor, sel_ops, sel_vals, proj_mask,
                   n_valid: torch.Tensor):
    """table (B, N, C) f32; sel_ops (C,) int32, sel_vals (C,) f32 and
    proj_mask (C,) host arrays; n_valid (B,) int32 on table's device.

    The contract of `repro.kernels.ops.select_project_xla` with valid =
    row < n_valid[b], for each request b of the stack. Returns (packed
    (B, N, C) f32, count (B,) int32), on table's device."""
    fn = _pick(table, _sp.select_project, _sp.select_project_plain)
    return fn(table, sel_ops, sel_vals, proj_mask, n_valid)


def crypt(data: torch.Tensor, key, nonce: int,
          idx: torch.Tensor | None = None) -> torch.Tensor:
    """data (B, L) int32 words; key two uint32 ints; optional (B, L) int32
    stream positions. The involutive CTR cipher of `repro.kernels.ref.
    ctr_crypt`, each request's stream starting at position 0 unless idx
    is given."""
    fn = _pick(data, _ctr.ctr_crypt, _ctr.ctr_crypt_plain)
    return fn(data, key, nonce, idx)


def crypt_bytes(data: torch.Tensor, key, nonce: int,
                row_ids: torch.Tensor | None = None,
                width: int | None = None) -> torch.Tensor:
    """data (B, L) uint8 bytes: a (B, n, w) string stack flattened per
    request; key two uint32 ints; optional (B, n) int32 row ids with the
    row width w. The reference's pre-decrypt of a string table: byte i
    XORed with the low byte of the keystream word at its position, i
    within its request or row_id * w + col (mod 2^32) given row ids.
    Returns a new (B, L) uint8 tensor."""
    fn = _pick(data, _ctr.ctr_crypt_bytes, _ctr.ctr_crypt_bytes_plain)
    return fn(data, key, nonce, row_ids, width)


# ---------------------------------------------------------------------------
# regex
# ---------------------------------------------------------------------------
def regex_match(strings: torch.Tensor, lengths: torch.Tensor, table,
                accept, n_valid: torch.Tensor | None = None):
    """strings (N, L) or (B, N, L) uint8; lengths (N,) / (B, N) int32 on
    the strings' device; table (S, 256) and accept (S,): host arrays
    (checked and uploaded by `dfa_match.prepare_dfa`) or its result;
    n_valid (B,)
    int32 on the strings' device, or None for every row. Returns the (N,)
    / (B, N) bool match mask of `repro.kernels.ref.dfa_match`, rows at or
    past n_valid[b] False."""
    if not isinstance(table, torch.Tensor):
        table, accept = _dfa.prepare_dfa(table, accept, strings.device)
    flat = strings.dim() == 2
    if flat:
        strings, lengths = strings[None], lengths[None]
    if n_valid is None:
        n_valid = torch.full((strings.shape[0],), strings.shape[1],
                             dtype=torch.int32, device=strings.device)
    fn = _pick(strings, _dfa.dfa_match, _dfa.dfa_match_plain)
    mask = fn(strings, lengths, n_valid, table, accept)
    return mask[0] if flat else mask


# ---------------------------------------------------------------------------
# far-KV decode attention
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, scale: float | None = None):
    """q (B, Hq, D); k/v (B, S, Hkv, D) f32 or bf16; lengths (B,) integer,
    on q's device. The contract of `repro.kernels.ops.decode_attention`
    (no padding needed), but for an empty (b, head), whose m is -1e30 as
    the Pallas kernel gives it. A stack of shards, q (P, B, Hq, D) with
    k/v (P, B, S, Hkv, D) and lengths (P, B), runs in one launch. Returns
    the unnormalized partials (o f32, m, l) for a cross-shard merge."""
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    flat = q.dim() == 3
    if flat:
        q, k, v, lengths = q[None], k[None], v[None], lengths[None]
    fn = _pick(q, _da.decode_attention, _da.decode_attention_plain)
    o, m, l = fn(q, k, v, lengths.to(torch.int32), scale)
    return (o[0], m[0], l[0]) if flat else (o, m, l)


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------
def group_prep(table: torch.Tensor, kcol: int, vcols, sel_ops, sel_vals,
               n_valid: torch.Tensor, drop_key: int):
    """table (B, N, C) f32; the grouping prologue of `repro/core/
    pipeline.py::_group_body` for each request: rows that fail the
    predicate or lie past n_valid[b] get key drop_key and zero values,
    the others key rint(table[..., kcol]) (saturated to int32) and the
    value columns vcols. Returns (keys (B, N) int32, values (B, N, V))."""
    fn = _pick(table, _hg.group_prep, _hg.group_prep_plain)
    return fn(table, kcol, vcols, sel_ops, sel_vals, n_valid, drop_key)


def group_aggregate(keys: torch.Tensor, values: torch.Tensor,
                    n_buckets: int = 1024) -> dict:
    """keys (B, N) int32, values (B, N, V) f32 -> the dict of `ref.
    group_aggregate` for each request (aggregates + overflow mask).
    Overflow rows (bucket collisions) go to the client for the merge,
    mirroring the paper's cuckoo-overflow contract."""
    fn = _pick(keys, _hg.group_aggregate, _hg.group_aggregate_plain)
    return fn(keys, values, n_buckets)


# ---------------------------------------------------------------------------
# small-table join
# ---------------------------------------------------------------------------
def hash_join(probe: torch.Tensor, kcol: int, build_keys: torch.Tensor,
              build_vals: torch.Tensor, n_valid: torch.Tensor, *,
              out: torch.Tensor | None = None):
    """probe (B, N, w) f32 words (key = rint of column kcol, saturated to
    int32) or int32 keys; build_keys (K,) int32 unique, build_vals (K, V)
    f32; n_valid (B,) int32 on probe's device. The join probe of
    `repro/core/pipeline.py`'s join branch (`ops.hash_join_xla`) for each
    request, into the widened select/project input `out` (B, N, >= w +
    V + 1; new when None): each probe row, its V matched build words
    (bitwise; zeros on a miss and past n_valid[b]), its hit flag (1.0 /
    0.0) and zeros. Returns out."""
    fn = _pick(probe, _hj.hash_join, _hj.hash_join_plain)
    return fn(probe, kcol, build_keys, build_vals, n_valid, out=out)


def check_build_unique(build_keys) -> None:
    """The join's eager host check: ValueError on a duplicate build key."""
    _hj.check_unique(build_keys)


def hash_join_full(probe_keys, build_keys, build_vals, *,
                   device=None) -> tuple:
    """The contract of `repro.kernels.ops.hash_join`: probe_keys (N,)
    int32, build_keys (K,) int32 UNIQUE (a duplicate raises ValueError,
    checked on the host first), build_vals (K, V) f32, host arrays or
    tensors, run on `device` (None means the CUDA card, raising where
    there is none; "cpu" the plain version). Returns (joined (N, V) f32,
    hit (N,) bool) on that device; K = 0 launches nothing."""
    dev = _entry_device(device, "hash_join_full")
    check_build_unique(build_keys)
    pk = torch.as_tensor(np.asarray(probe_keys, np.int32)).to(dev)
    bk = torch.as_tensor(np.asarray(build_keys, np.int32)).to(dev)
    bv = torch.as_tensor(np.asarray(build_vals, np.float32)).to(dev)
    n_valid = torch.full((1,), pk.shape[0], dtype=torch.int32, device=dev)
    out = hash_join(pk[None, :, None], 0, bk, bv, n_valid)[0]
    v = bv.shape[1]
    return out[:, 1: 1 + v], out[:, 1 + v] == 1.0


def _entry_device(device, caller: str) -> torch.device:
    # imported here: core.pipeline imports this module
    from repro_torch.core.pipeline import resolve_device
    return resolve_device(device, caller)


def group_aggregate_full(keys, values, *, n_buckets: int = 1024,
                         device=None) -> dict:
    """Kernel aggregation + client-side overflow merge -> exact dict result.

    keys (N,) int32, values (N, V) f32 (host arrays), run on `device`:
    None means the CUDA card (raising where there is none), "cpu" the
    plain versions. The smart memory aggregates what fits its hash table;
    collision overflow is merged in "client software". Returns {key:
    (count, sum, min, max)} over all keys."""
    dev = _entry_device(device, "group_aggregate_full")
    k = torch.as_tensor(np.asarray(keys, np.int32)).to(dev)
    v = torch.as_tensor(np.asarray(values, np.float32)).to(dev)
    res = group_aggregate(k[None], v[None], n_buckets)
    return _finalize_group_full(keys, values,
                                {f: x[0] for f, x in res.items()})


def _finalize_group_full(keys, values, res) -> dict:
    """Finalize boundary: bring the bucket outputs to the host and merge
    collision overflow in "client software" (the paper's split)."""
    out: dict[int, tuple] = {}
    bkeys = res["bucket_keys"].cpu().numpy()
    cnts = res["count"].cpu().numpy()
    sums = res["sum"].cpu().numpy()
    mins = res["min"].cpu().numpy()
    maxs = res["max"].cpu().numpy()
    for i in range(bkeys.shape[0]):
        if bkeys[i] != ref.KEY_SENTINEL and cnts[i] > 0:
            out[int(bkeys[i])] = (int(cnts[i]), sums[i].copy(),
                                  mins[i].copy(), maxs[i].copy())
    ovf = res["overflow_mask"].cpu().numpy()
    kh = np.asarray(keys)[ovf]
    vh = np.asarray(values, np.float32)[ovf]
    for k, row in zip(kh.tolist(), vh):
        if k in out:
            c, s, mn, mx = out[k]
            out[k] = (c + 1, s + row, np.minimum(mn, row),
                      np.maximum(mx, row))
        else:
            out[k] = (1, row.copy(), row.copy(), row.copy())
    return out


def distinct(keys, *, n_buckets: int = 1024, device=None) -> list:
    """DISTINCT via group_aggregate (count only) + client-side overflow
    dedup. keys (N,) int32 (a host array), run on `device` as in
    `group_aggregate_full`; returns the sorted distinct keys."""
    k = torch.as_tensor(np.asarray(keys, np.int32)).to(
        _entry_device(device, "distinct"))
    vals = torch.zeros((1, k.shape[0], 1), dtype=torch.float32,
                       device=k.device)
    res = group_aggregate(k[None], vals, n_buckets)
    return _finalize_distinct(keys, {f: x[0] for f, x in res.items()})


def _finalize_distinct(keys, res) -> list:
    """Finalize boundary: host-side dedup of bucket keys + overflow rows."""
    bk = res["bucket_keys"].cpu().numpy()
    cnt = res["count"].cpu().numpy()
    found = set(bk[(bk != ref.KEY_SENTINEL) & (cnt > 0)].tolist())
    found.update(np.asarray(keys)[res["overflow_mask"].cpu().numpy()]
                 .tolist())
    return sorted(found)
