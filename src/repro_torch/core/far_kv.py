"""Disaggregated KV cache with attention push-down (port of
`repro/core/far_kv.py`: Farview for LM serving).

The KV cache is the LM's buffer pool: large, append-only, read-dominated.
It is sharded by *sequence* over a pool of P shards (the cache rows live
on "memory" devices like Farview's network-attached DRAM), with three read
paths per the paper's evaluation matrix:

  mode="far"    (FV):   partial flash-attention runs at each shard owner
                        (one `decode_attention` kernel launch over all
                        shards); only (o, m, l) = Hq*(D+2) floats a shard
                        are merged. This is operator push-down:
                        softmax-weighted-sum is the aggregation operator.
  mode="naive"  (RCPU): the shards' raw KV rows are concatenated on the
                        compute side, which attends over them. Bytes ∝
                        2*S*Hkv*D.
  mode="local"  (LCPU): no disaggregation: the cache is head-sharded like
                        standard TP serving.

The JAX functions run inside `shard_map` over a named pool axis. Here the
pool axis is explicit: the P shards (= the tensor-parallel degree) are
the leading axis of one tensor on one device. `pmax`/`psum` become
reductions over dim 0, `all_gather` a concatenation over the shards (the
bytes "naive" ships), `axis_index` `arange(P)`. Projections stay
`torch.matmul`, as the JAX package leaves them to XLA; the attention is
the hand-written kernel on the card and its plain version on the CPU
(`kernels/ops.py` picks by the tensors' device).

Nothing in a decode step (`attend_block`) waits for the card: positions
and lengths stay device tensors, the append writes in place through index
tensors. The caches are updated in place (the JAX functions return new
arrays) and also returned. `block_weights_from_numpy` and `shard_cache`
carry full weights and a (B, S, Hkv, D) cache into the per-shard stacks;
they take `device=None`, meaning the card, and raise `FarviewError` where
there is none.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pipeline import resolve_device
from repro_torch.kernels import ops

MODES = ("far", "naive", "local")


# ---------------------------------------------------------------------------
# partial attention (the decode_attention kernel) and the merge
# ---------------------------------------------------------------------------
def partial_attention(q, k, v, lengths, *, scale: float):
    """Unnormalized flash partials of every shard, in one launch.

    q (P, B, Hq, D); k/v (P, B, S_loc, Hkv, D); lengths (P, B) *local*
    valid rows (a single shard, q (B, Hq, D), k/v (B, S, Hkv, D) and
    lengths (B,), also runs). Returns o (P, B, Hq, D) f32, m (P, B, Hq),
    l (P, B, Hq); m = -1e30 where a shard holds no row of a sequence.
    All math in f32 over the stored values (the JAX function casts q and
    p to the cache's type for the TPU's matrix unit)."""
    return ops.decode_attention(q, k, v, lengths, scale=scale)


def merge_partials(o, m, l):
    """LSE-merge the shards' partials (dim 0); the counterpart of
    `merge_partials_named` (Hq*(D+2) floats a shard). Returns (B, Hq, D)
    f32."""
    m_g = m.amax(dim=0)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(dim=0)
    o_g = (o * w[..., None]).sum(dim=0)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# cache append (write path) — sequence-sharded pool
# ---------------------------------------------------------------------------
def _positions(pos, b: int, device) -> torch.Tensor:
    """Write positions as a (B,) int64 tensor on `device`: an int fills
    one on the device (no copy), a () or (B,) tensor there is expanded."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def _write_rows(caches, news, index, in_range) -> None:
    """cache[index] = new where in_range, else the row as it was."""
    for cache, new in zip(caches, news):
        old = cache[index]
        cache[index] = torch.where(in_range, new.to(cache.dtype), old)


def append_seq_sharded(k_cache, v_cache, k_new, v_new, pos):
    """Write one token's K/V into the owning sequence shard, in place.

    k_cache/v_cache (P, B, S_loc, Hkv, D); k_new/v_new (B, Hkv, D). pos:
    the global write position, an int or an integer tensor on the caches'
    device, () or (B,) (one position a sequence). A position outside [0,
    P * S_loc) writes nothing. Returns the caches."""
    p, b, s_loc = k_cache.shape[:3]
    dev = k_cache.device
    pos = _positions(pos, b, dev)
    shard = torch.div(pos, s_loc, rounding_mode="floor").clamp(0, p - 1)
    off = (pos - shard * s_loc).clamp(0, s_loc - 1)
    in_range = ((pos >= 0) & (pos < p * s_loc))[:, None, None]
    rows = torch.arange(b, device=dev)
    _write_rows((k_cache, v_cache), (k_new, v_new), (shard, rows, off),
                in_range)
    return k_cache, v_cache


def local_lengths(global_len, s_loc: int, n_shards: int):
    """Per-shard valid-row counts (P, B) int32 given global cache lengths
    (B,)."""
    start = torch.arange(n_shards, device=global_len.device)[:, None] * s_loc
    return (global_len.to(torch.int64)[None] - start).clamp(
        0, s_loc).to(torch.int32)


# ---------------------------------------------------------------------------
# the three read paths
# ---------------------------------------------------------------------------
def attend_far(q_rep, k_cache, v_cache, global_len, *, scale: float):
    """FV: push-down. q (B, Hq, D) replicated; cache seq-sharded (P, B,
    S_loc, Hkv, D); returns (B, Hq, D) f32."""
    p, _, s_loc = k_cache.shape[:3]
    loc_len = local_lengths(global_len, s_loc, p)
    o, m, l = partial_attention(q_rep.expand(p, *q_rep.shape), k_cache,
                                v_cache, loc_len, scale=scale)
    return merge_partials(o, m, l)


def attend_naive(q_rep, k_cache, v_cache, global_len, *, scale: float):
    """RCPU: fetch-then-compute. All KV rows cross the wire: the shards
    are concatenated in sequence order (a copy of the whole cache)."""
    p, b, s_loc, hkv, d = k_cache.shape
    k_full = k_cache.transpose(0, 1).reshape(b, p * s_loc, hkv, d)
    v_full = v_cache.transpose(0, 1).reshape(b, p * s_loc, hkv, d)
    o, _, l = partial_attention(q_rep, k_full, v_full, global_len,
                                scale=scale)
    return o / torch.clamp(l, min=1e-30)[..., None]


def attend_local(q_loc, k_cache_loc, v_cache_loc, global_len, *,
                 scale: float):
    """LCPU: head-sharded cache, no cross-shard traffic in attention. q
    (P, B, Hq_loc, D); caches (P, B, S, Hkv_loc, D); returns (P, B,
    Hq_loc, D) f32."""
    lens = global_len.expand(q_loc.shape[0], -1)
    o, _, l = partial_attention(q_loc, k_cache_loc, v_cache_loc, lens,
                                scale=scale)
    return o / torch.clamp(l, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# full decode attention block (projections + far pool)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BlockWeights:
    """The TP shards of one attention block's projections, stacked on a
    leading axis of P = tp shards."""
    wq: torch.Tensor    # (P, d, hq_loc * dh)
    wk: torch.Tensor    # (P, d, hkv_loc * dh)
    wv: torch.Tensor    # (P, d, hkv_loc * dh)
    wo: torch.Tensor    # (P, hq_loc * dh, d)


def attend_block(x, w: BlockWeights, k_cache, v_cache, pos, global_len, *,
                 n_q_heads: int, n_kv_heads: int, head_dim: int,
                 mode: str = "far", scale: float | None = None):
    """One decode attention block over a pool of P = tp shards.

    x: (B, d) activations. Caches: mode far/naive -> seq-sharded (P, B,
    S_loc, Hkv, D); mode local -> head-sharded (P, B, S, Hkv_loc, D). pos:
    the write position (an int, or a () or (B,) integer tensor on x's
    device); global_len (B,) integer tensor on x's device. Returns ((B, d)
    output, the caches, updated in place)."""
    if mode not in MODES:
        raise ValueError(mode)
    tp = w.wq.shape[0]
    if scale is None:
        scale = 1.0 / float(np.sqrt(head_dim))
    b = x.shape[0]
    hq_loc = n_q_heads // tp
    hkv_loc = max(1, n_kv_heads // tp)

    q_loc = torch.matmul(x, w.wq).reshape(tp, b, hq_loc, head_dim)
    k_loc = torch.matmul(x, w.wk).reshape(tp, b, hkv_loc, head_dim)
    v_loc = torch.matmul(x, w.wv).reshape(tp, b, hkv_loc, head_dim)
    pos = _positions(pos, b, x.device)
    glen = torch.maximum(global_len.to(x.device, torch.int64), pos + 1)

    if mode == "local":
        s = k_cache.shape[2]
        in_range = ((pos >= 0) & (pos < s))[None, :, None, None]
        rows = torch.arange(b, device=x.device)
        _write_rows((k_cache, v_cache), (k_loc, v_loc),
                    (slice(None), rows, pos.clamp(0, s - 1)), in_range)
        attn = attend_local(q_loc, k_cache, v_cache, glen, scale=scale)
        out = torch.matmul(attn.reshape(tp, b, -1).to(x.dtype), w.wo)
        return out.sum(dim=0), k_cache, v_cache

    # far / naive: replicate q + the new KV heads (tiny), seq-sharded pool.
    # When tp > n_kv_heads the kv projections are replicated per head group
    # (shard i computes kv head i * n_kv // tp); de-dup by striding.
    q_rep = q_loc.transpose(0, 1).reshape(b, n_q_heads, head_dim)
    k_all = k_loc.transpose(0, 1).reshape(b, tp * hkv_loc, head_dim)
    v_all = v_loc.transpose(0, 1).reshape(b, tp * hkv_loc, head_dim)
    if tp > n_kv_heads:
        stride = tp // n_kv_heads
        k_new, v_new = k_all[:, ::stride], v_all[:, ::stride]
    else:
        k_new, v_new = k_all, v_all
    append_seq_sharded(k_cache, v_cache, k_new, v_new, pos)
    attend = attend_far if mode == "far" else attend_naive
    attn = attend(q_rep, k_cache, v_cache, glen, scale=scale)
    # out-projection: shard i's head slice x its wo shard, summed
    attn_loc = attn.reshape(b, tp, hq_loc * head_dim).transpose(0, 1)
    out = torch.matmul(attn_loc.to(x.dtype), w.wo)
    return out.sum(dim=0), k_cache, v_cache


def shipped_bytes_per_layer(mode: str, *, batch: int, hq: int, hkv: int,
                            head_dim: int, seq_len: int, tp: int,
                            bytes_per_el: int = 2) -> int:
    """Modeled network bytes per decode step per layer (the Fig. 8 economics)."""
    if mode == "local":
        return batch * hq * head_dim * bytes_per_el          # psum of out proj
    q_ship = batch * hq * head_dim * bytes_per_el            # all_gather q
    kv_new = 2 * batch * hkv * head_dim * bytes_per_el
    if mode == "far":
        merge = batch * hq * (head_dim + 2) * 4              # o,m,l f32 psum
        return q_ship + kv_new + merge
    if mode == "naive":
        fetch = 2 * batch * seq_len * hkv * head_dim * bytes_per_el * (tp - 1) // tp
        return q_ship + kv_new + fetch
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# carrying weights and caches into the per-shard stacks
# ---------------------------------------------------------------------------
def _kv_heads_of_shards(tp: int, n_kv_heads: int) -> np.ndarray:
    """The KV head each shard holds when tp > n_kv_heads."""
    return np.arange(tp) * n_kv_heads // tp


def _check_split(tp: int, n_q_heads: int, n_kv_heads: int) -> None:
    if tp < 1 or n_q_heads % tp or n_q_heads % n_kv_heads or (
            n_kv_heads % tp if tp <= n_kv_heads else tp % n_kv_heads):
        raise ValueError(f"tp = {tp} does not split {n_q_heads} query and "
                         f"{n_kv_heads} KV heads")


def block_weights_from_numpy(wq, wk, wv, wo, *, tp: int, n_q_heads: int,
                             n_kv_heads: int, head_dim: int,
                             dtype=torch.float32, device=None
                             ) -> BlockWeights:
    """Full projections -> the per-shard stacks of `attend_block`.

    wq (d, Hq*Dh), wk/wv (d, Hkv*Dh), wo (Hq*Dh, d), host arrays. wq is
    split by columns and wo by rows; wk/wv by columns when tp <= n_kv,
    else shard i gets KV head i * n_kv // tp (the layout `attend_block`
    de-duplicates by stride). On `device` (None: the card, raising where
    there is none), in `dtype`."""
    dev = resolve_device(device, "block_weights_from_numpy")
    _check_split(tp, n_q_heads, n_kv_heads)
    wq, wk, wv, wo = (np.asarray(a, np.float32) for a in (wq, wk, wv, wo))
    d = wq.shape[0]

    def cols(a, per):
        return a.reshape(d, tp, per).transpose(1, 0, 2)

    def kv(a):
        if tp <= n_kv_heads:
            return cols(a, n_kv_heads // tp * head_dim)
        return np.stack([a[:, h * head_dim:(h + 1) * head_dim]
                         for h in _kv_heads_of_shards(tp, n_kv_heads)])

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return BlockWeights(to(cols(wq, n_q_heads // tp * head_dim)), to(kv(wk)),
                        to(kv(wv)), to(wo.reshape(tp, -1, wo.shape[1])))


def shard_cache(k, v, *, tp: int, mode: str, device=None):
    """A (B, S, Hkv, D) cache (host arrays or tensors) -> the shards of
    `attend_block`: mode far/naive, P = tp sequence shards (tp, B, S/tp,
    Hkv, D); mode local, head shards (tp, B, S, Hkv/tp, D), or when tp >
    Hkv shard i's KV head i * Hkv // tp (tp, B, S, 1, D). On `device`
    (None: the card, raising where there is none), in the input's type;
    always a copy, never a view of the input."""
    dev = resolve_device(device, "shard_cache")
    if mode not in MODES:
        raise ValueError(mode)

    def one(x):
        x = torch.as_tensor(x)
        b, s, hkv, d = x.shape
        if mode != "local":
            if s % tp:
                raise ValueError(f"S = {s} does not split into {tp} shards")
            y = x.reshape(b, tp, s // tp, hkv, d).transpose(0, 1)
        elif tp <= hkv:
            if hkv % tp:
                raise ValueError(f"{hkv} KV heads do not split over {tp}")
            y = x.reshape(b, s, tp, hkv // tp, d).permute(2, 0, 1, 3, 4)
        else:
            heads = torch.from_numpy(_kv_heads_of_shards(tp, hkv)).to(
                x.device)
            y = x[:, :, heads, None].permute(2, 0, 1, 3, 4)
        return y.to(dev, copy=True, memory_format=torch.contiguous_format)

    return one(k), one(v)
