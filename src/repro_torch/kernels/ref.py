"""Plain torch oracles for the port's kernels (port of `repro/kernels/ref.py`).

Each function is the semantic ground truth of one CUDA kernel in this
package, written in plain torch ops so it runs on the CPU and on the card
alike. Only the functions the ported slices need are here: the
rows kind's `eval_predicate`, `select_project`, `threefry2x32`,
`ctr_crypt` and the string tables' `ctr_crypt_bytes`, and the grouping's
`bucket_of`, `sort_by_bucket`, `segment_spans`, `segmented_reduce`,
`group_aggregate` and `group_aggregate_exact`, the join's `hash_join`,
the regex verb's `dfa_match` and far-KV's `decode_attention`,
`merge_partials` and `full_attention_oracle`.

Cipher words are uint32 in the reference. torch on the CPU has no add,
shift or compare for `torch.uint32`, so the cipher carries its words in
int64 masked to 32 bits, and data words cross in and out as int32 bit
patterns. Float words are reinterpreted with `.view(torch.int32)`, never
converted, so NaN payloads and -0.0 survive bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# Predicate op codes shared with the kernels (paper §5.3 predicate selection).
OP_SKIP, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE = range(7)

KEY_SENTINEL = -2**31           # "empty bucket" marker (hash_group)

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# select_project
# ---------------------------------------------------------------------------
def eval_predicate(table: torch.Tensor, sel_ops: torch.Tensor,
                   sel_vals: torch.Tensor) -> torch.Tensor:
    """AND of per-column comparisons: table (..., N, A) f32, sel_ops (A,)
    int32 op codes (OP_SKIP, or any other code, passes), sel_vals (A,) f32.
    Returns the (..., N) bool mask.

    IEEE f32 compares (NaN fails every op but `!=`) with subnormal
    operands read as zero, on both sides: the reference compares that way
    on the TPU (no f32 subnormals) and under XLA on the CPU (flush-to-zero
    compares), so a subnormal word selects as 0.0 does."""
    val = flush_subnormals(sel_vals.to(table.device, torch.float32))
    ops = sel_ops.to(table.device, torch.int32)
    table = flush_subnormals(table)
    per_col = torch.ones(table.shape, dtype=torch.bool, device=table.device)
    for code, cmp in ((OP_LT, torch.lt), (OP_LE, torch.le), (OP_GT, torch.gt),
                      (OP_GE, torch.ge), (OP_EQ, torch.eq),
                      (OP_NE, torch.ne)):
        per_col = torch.where(ops == code, cmp(table, val), per_col)
    return per_col.all(dim=-1)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """f32 values with a zero exponent field (zeros and subnormals) -> 0.0;
    for the operands of compares and group arithmetic, never for the words
    a response carries."""
    exponent = x.view(torch.int32) & 0x7F800000
    return torch.where(exponent == 0, 0.0, x)


def select_project(table: torch.Tensor, sel_ops: torch.Tensor,
                   sel_vals: torch.Tensor, proj_mask: torch.Tensor,
                   valid: torch.Tensor | None = None):
    """Filter rows by predicate (and `valid`), zero dropped columns, compact.

    table (..., N, A) f32; valid (..., N) bool or None. Returns (packed
    (..., N, A) f32 with survivors moved to the front in original order,
    projected words copied bitwise, dropped columns and the tail zero;
    count (...) int32). The contract of `repro.kernels.ops.
    select_project_xla`, over any number of leading stack axes.
    """
    mask = eval_predicate(table, sel_ops, sel_vals)
    if valid is not None:
        mask = mask & valid
    keep = proj_mask.to(table.device).bool()
    bits = torch.where(keep, table.view(torch.int32), 0)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    packed = torch.where(mask.gather(-1, order)[..., None],
                         bits.gather(-2, order[..., None].expand_as(bits)),
                         0)
    return packed.view(torch.float32), mask.sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# ctr_crypt (ARX counter-mode cipher, Threefry-2x32 schedule)
# ---------------------------------------------------------------------------
_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key: tuple[int, int], c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32, 20 rounds. key: two uint32 ints; c0/c1: int64 tensors
    holding uint32 values. Returns two int64 tensors of uint32 values."""
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK32
    x1 = (c1 + ks[1]) & _MASK32
    for block in range(5):
        for r in range(4):
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, _ROTS[(4 * block + r) % 8])
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK32
    return x0, x1


def _keystream(n: int, key: tuple[int, int], nonce: int,
               idx: torch.Tensor | None, device) -> torch.Tensor:
    """The keystream words (int64 holding uint32) at stream positions
    idx (default 0..n-1), taken mod 2^32: lane `p & 1` of threefry(key,
    p >> 1, nonce)."""
    pos = (torch.arange(n, dtype=torch.int64, device=device)
           if idx is None else idx.to(torch.int64) & _MASK32)
    s0, s1 = threefry2x32(key, pos >> 1,
                          torch.full_like(pos, int(nonce) & _MASK32))
    return torch.where((pos & 1) == 0, s0, s1)


def ctr_crypt(data: torch.Tensor, key: tuple[int, int], nonce: int,
              idx: torch.Tensor | None = None) -> torch.Tensor:
    """XOR data (N,) int32 words with the Threefry CTR keystream. Involutive.

    Word i is XORed with lane `p & 1` of threefry(key, p >> 1, nonce) at
    stream position p = idx[i] (default i). Positions are taken mod 2^32,
    as the reference's uint32 arithmetic takes them."""
    stream = _keystream(data.shape[0], key, nonce, idx, data.device)
    out = (data.to(torch.int64) & _MASK32) ^ stream
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def ctr_crypt_bytes(data: torch.Tensor, key: tuple[int, int], nonce: int,
                    idx: torch.Tensor | None = None) -> torch.Tensor:
    """XOR data (N,) uint8 bytes with the low byte of the keystream word
    at each byte's position: byte i becomes data[i] ^ (ks(p) & 0xFF), p =
    idx[i] (default i) mod 2^32. `ctr_crypt` over the bytes widened to
    words, cut back to their low byte, as the reference's pre-decrypt of
    a string table computes it. Involutive."""
    stream = _keystream(data.shape[0], key, nonce, idx, data.device)
    return (data.to(torch.int64) ^ (stream & 0xFF)).to(torch.uint8)


# ---------------------------------------------------------------------------
# hash_group (distinct / group-by / aggregation)
#
# f32 arithmetic here follows the reference as XLA runs it on the CPU:
# every add and min/max reads subnormal operands as zero, and every output
# of `segmented_reduce` over two or more rows has passed through one more
# `+ 0.0` (the interleave of `jax.lax.associative_scan`), so -0.0 and
# subnormal results come out as +0.0. A lone row is returned untouched.
# NaN propagates through min and max.
# ---------------------------------------------------------------------------
_FIB = 0x9E3779B1
F32_BIG = torch.finfo(torch.float32).max


def bucket_of(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative (Fibonacci) hash of int32 keys into n_buckets (a
    power of 2): the top log2(n_buckets) bits of the uint32 product
    key * 0x9E3779B1. Carried in int64, the product split in 16-bit
    halves so that no intermediate leaves the int64 range."""
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of 2, got {n_buckets}")
    k = keys.to(torch.int64) & _MASK32
    lo, hi = k & 0xFFFF, k >> 16
    h = (lo * _FIB + (((hi * _FIB) & 0xFFFF) << 16)) & _MASK32
    return (h >> (32 - (n_buckets.bit_length() - 1))).to(torch.int32)


def sort_by_bucket(bucket: torch.Tensor, n_buckets: int):
    """Stable sort of rows by bucket id along the last axis -> (order
    int64, sorted_buckets). Rows of one bucket keep ascending index, the
    order of the reference's composite-key sort."""
    del n_buckets               # any stable sort gives the same order
    sb, order = torch.sort(bucket, dim=-1, stable=True)
    return order, sb


def segment_spans(sorted_seg_ids: torch.Tensor, n_segments: int):
    """Per-segment [start, end] row spans of a segment-sorted id array
    (..., N), along its last axis. Returns (start, end, nonempty), each
    (..., S); end is the INCLUSIVE last row, start and end clipped to a
    valid index (mask with `nonempty` before trusting them). start and
    end are int64 (torch's index type)."""
    n = sorted_seg_ids.shape[-1]
    ids = sorted_seg_ids.contiguous()
    seg = torch.arange(n_segments, dtype=ids.dtype, device=ids.device)
    seg = seg.expand(*ids.shape[:-1], n_segments).contiguous()
    lo = torch.searchsorted(ids, seg, side="left")
    hi = torch.searchsorted(ids, seg, side="right")
    top = max(n - 1, 0)
    return lo.clamp(0, top), (hi - 1).clamp(0, top), hi > lo


def rint_to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as `jnp.rint(x).astype(jnp.int32)` converts: round half
    to even, NaN -> 0, out of range saturates to INT32_MIN / INT32_MAX
    (torch's own cast gives INT32_MIN for all of those)."""
    r = torch.round(x)
    high = r >= 2.0**31
    low = r < -2.0**31
    safe = torch.where(high | low | torch.isnan(r), 0.0, r).to(torch.int32)
    return torch.where(high, 2**31 - 1, torch.where(low, -2**31, safe)).to(
        torch.int32)


def _add_daz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 add with subnormal operands read as zero (the result itself
    is not flushed)."""
    return flush_subnormals(a) + flush_subnormals(b)


def _canonical(x: torch.Tensor) -> torch.Tensor:
    """x + 0.0 with subnormal operands read as zero: -0.0 and subnormals
    -> +0.0; everything else unchanged."""
    return flush_subnormals(x) + 0.0


def segmented_reduce(sums: torch.Tensor, mins: torch.Tensor,
                     maxs: torch.Tensor, starts: torch.Tensor,
                     counts: torch.Tensor | None = None):
    """Inclusive segmented scan of (sum, min, max[, count]) along the row
    axis. sums/mins/maxs (..., N, V) f32; starts (..., N) bool segment-
    start flags over rows already sorted by segment; counts optional
    (..., N) int weights. Row i of each output holds the reduction since
    its segment's first row, so segment totals sit at segment END rows.
    A log-depth (Hillis-Steele) scan. Returns (sum, min, max), or
    (count, sum, min, max) when counts is given."""
    n = sums.shape[-2]
    s, mn, mx, f, c = sums, mins, maxs, starts, counts
    d = 1
    while d < n:
        fb = f[..., d:]
        fv = fb[..., None]
        s = torch.cat([s[..., :d, :], torch.where(
            fv, s[..., d:, :], _add_daz(s[..., :-d, :], s[..., d:, :]))], -2)
        mn = torch.cat([mn[..., :d, :], torch.where(
            fv, mn[..., d:, :], torch.minimum(mn[..., :-d, :],
                                              mn[..., d:, :]))], -2)
        mx = torch.cat([mx[..., :d, :], torch.where(
            fv, mx[..., d:, :], torch.maximum(mx[..., :-d, :],
                                              mx[..., d:, :]))], -2)
        if c is not None:
            c = torch.cat([c[..., :d], torch.where(
                fb, c[..., d:], c[..., :-d] + c[..., d:])], -1)
        f = torch.cat([f[..., :d], f[..., :-d] | fb], -1)
        d *= 2
    if n >= 2:
        s, mn, mx = _canonical(s), _canonical(mn), _canonical(mx)
    return (s, mn, mx) if c is None else (c, s, mn, mx)


def group_aggregate(keys: torch.Tensor, values: torch.Tensor,
                    n_buckets: int):
    """Hash-grouped aggregation with first-claim buckets + overflow, over
    the last axis of keys (..., N) int32 and the row axis of values
    (..., N, V) f32 (any leading stack axes; one aggregation each).

    The first row (lowest index) hashing into a bucket claims it; rows
    with a different key in that bucket overflow (shipped to the client
    for software post-aggregation). Returns dict with bucket_keys (..., B)
    int32 (KEY_SENTINEL if unclaimed), count (..., B) int32, sum/min/max
    (..., B, V) f32 over each bucket's owned rows (rows it does not own
    carry 0, +F32_BIG and -F32_BIG into the bucket's sum, min and max),
    overflow_mask (..., N) bool. The contract of `repro.kernels.ref.
    group_aggregate`."""
    n, v = values.shape[-2:]
    lead = keys.shape[:-1]
    dev = keys.device
    if n == 0:
        return dict(
            bucket_keys=torch.full((*lead, n_buckets), KEY_SENTINEL,
                                   dtype=torch.int32, device=dev),
            count=torch.zeros((*lead, n_buckets), dtype=torch.int32,
                              device=dev),
            sum=torch.zeros((*lead, n_buckets, v), device=dev),
            min=torch.full((*lead, n_buckets, v), F32_BIG, device=dev),
            max=torch.full((*lead, n_buckets, v), -F32_BIG, device=dev),
            overflow_mask=torch.zeros((*lead, 0), dtype=torch.bool,
                                      device=dev))
    b = bucket_of(keys, n_buckets)
    order, sb = sort_by_bucket(b, n_buckets)
    start, end, nonempty = segment_spans(sb, n_buckets)
    sorted_keys = keys.gather(-1, order)
    claimed = torch.where(nonempty, sorted_keys.gather(-1, start),
                          KEY_SENTINEL)
    owns = keys == claimed.gather(-1, b.to(torch.int64))
    so = owns.gather(-1, order)
    sv = values.gather(-2, order[..., None].expand(*order.shape, v))
    oc = so.to(torch.int32)
    csum = torch.cumsum(oc, -1, dtype=torch.int32)
    count = torch.where(nonempty, csum.gather(-1, end)
                        - (csum.gather(-1, start) - oc.gather(-1, start)), 0)
    flags = torch.cat([torch.ones_like(sb[..., :1], dtype=torch.bool),
                       sb[..., 1:] != sb[..., :-1]], -1)
    own = so[..., None]
    ssum, smin, smax = segmented_reduce(
        torch.where(own, sv, 0.0), torch.where(own, sv, F32_BIG),
        torch.where(own, sv, -F32_BIG), flags)
    at_end = end[..., None].expand(*end.shape, v)
    ne = nonempty[..., None]
    return dict(bucket_keys=claimed.to(torch.int32),
                count=count.to(torch.int32),
                sum=torch.where(ne, ssum.gather(-2, at_end), 0.0),
                min=torch.where(ne, smin.gather(-2, at_end), F32_BIG),
                max=torch.where(ne, smax.gather(-2, at_end), -F32_BIG),
                overflow_mask=~owns)


def group_aggregate_exact(keys, values) -> dict:
    """Dict-based exact group-by (numpy, float64 sums): the oracle for
    the kernel plus the client-side merge."""
    out: dict[int, list] = {}
    for k, row in zip(np.asarray(keys).tolist(), np.asarray(values)):
        e = out.setdefault(k, [0, np.zeros_like(row, dtype=np.float64),
                               np.full_like(row, np.inf, dtype=np.float64),
                               np.full_like(row, -np.inf, dtype=np.float64)])
        e[0] += 1
        e[1] = e[1] + row
        e[2] = np.minimum(e[2], row)
        e[3] = np.maximum(e[3], row)
    return out


# ---------------------------------------------------------------------------
# hash_join (small-table inner join; the paper's stated future work)
# ---------------------------------------------------------------------------
def hash_join(probe_keys: torch.Tensor, build_keys: torch.Tensor,
              build_vals: torch.Tensor):
    """Unique-key inner join: probe_keys (..., N) int32, build_keys (K,)
    int32 unique, build_vals (K, V) f32. Returns (joined (..., N, V) —
    the matched build row's words, copied bitwise, or zeros; hit (..., N)
    bool). K = 0 matches nothing. The contract of `repro.kernels.ops.
    hash_join_xla`: the build sorted once, each probe key looked up with
    a binary search (`torch.searchsorted`)."""
    k, v = build_vals.shape
    dev = probe_keys.device
    if k == 0:
        return (torch.zeros((*probe_keys.shape, v), dtype=torch.float32,
                            device=dev),
                torch.zeros(probe_keys.shape, dtype=torch.bool, device=dev))
    sk, order = torch.sort(build_keys.to(dev))
    bits = build_vals.to(dev).view(torch.int32)[order]
    probe_keys = probe_keys.contiguous()
    idx = torch.searchsorted(sk, probe_keys).clamp_(max=k - 1)
    hit = sk[idx] == probe_keys
    joined = torch.where(hit[..., None], bits[idx], 0)
    return joined.view(torch.float32), hit


# ---------------------------------------------------------------------------
# dfa_match (regex)
# ---------------------------------------------------------------------------
def dfa_match(strings: torch.Tensor, lengths: torch.Tensor,
              table: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """Run a DFA over each row of byte-strings.

    strings: (..., R, L) uint8 (0-padded). lengths: (..., R) int32.
    table: (S, 256) int32 transition table. accept: (S,) bool.
    Semantics: start in state 0, consume chars [0, len); accept iff the state
    after the last consumed char is accepting (a length above L consumes
    the L chars, one of 0 or below none). Returns the (..., R) bool mask.
    The contract of `repro.kernels.ref.dfa_match`, over any number of
    leading stack axes."""
    dev = strings.device
    table = table.to(dev, torch.int64)
    lengths = lengths.to(dev)
    state = torch.zeros(strings.shape[:-1], dtype=torch.int64, device=dev)
    for t in range(strings.shape[-1]):
        nxt = table[state, strings[..., t].to(torch.int64)]
        state = torch.where(t < lengths, nxt, state)
    return accept.to(dev, torch.bool)[state]


# ---------------------------------------------------------------------------
# decode_attention (far-KV partial flash attention)
# ---------------------------------------------------------------------------
NEG_INF = -1.0e30               # m of a (b, head) with no valid row


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float | None = None):
    """Single-token GQA attention over a KV shard, returning merge partials.

    q (..., Hq, D); k/v (..., S, Hkv, D); lengths (...) valid KV rows, over
    any stack of leading axes. Query head j reads KV head j // (Hq / Hkv).
    Returns o (..., Hq, D) un-normalized, o = sum(exp(s - m) v); m (...,
    Hq) the max score; l (..., Hq) sum(exp(s - m)). All math in f32 over
    the stored values. The contract of `repro.kernels.ref.decode_attention`
    but for one deliberate change: a (b, head) with no valid row gets m =
    NEG_INF (-1e30), as the Pallas kernel and `far_kv.partial_attention`
    give it, not 0, so that merging it beside a shard of very negative
    scores does not underflow (ROADMAP.md queue 3). A (b, head) whose
    largest score is +inf or NaN takes 0 as its base, p = exp(s), and
    returns m = 0, as the reference's `msafe` does."""
    *lead, hq, d = q.shape
    s, hkv = k.shape[-3], k.shape[-2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    qf = q.float().reshape(*lead, hkv, g, d)
    scores = torch.einsum("...hgd,...shd->...hgs", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    valid = pos < lengths.to(q.device)[..., None, None, None]
    scores = scores.masked_fill(~valid, float("-inf"))
    if s == 0:
        m = torch.full(scores.shape[:-1], NEG_INF, device=q.device)
    else:
        m = scores.amax(dim=-1)
        # a +inf or NaN max takes 0 as its base, as the reference's msafe
        m = torch.where(torch.isnan(m) | (m == float("inf")), 0.0,
                        torch.clamp(m, min=NEG_INF))
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    o = torch.einsum("...hgs,...shd->...hgd", p, v.float())
    return (o.reshape(*lead, hq, d), m.reshape(*lead, hq),
            p.sum(dim=-1).reshape(*lead, hq))


def merge_partials(parts) -> torch.Tensor:
    """Merge per-shard (o, m, l) partials into the final attention output.

    parts: a list of (o, m, l). Returns the normalized (..., Hq, D) f32
    output (the log-sum-exp weighted combine of `repro.kernels.ref.
    merge_partials`)."""
    os_ = torch.stack([p[0] for p in parts])
    ms = torch.stack([p[1] for p in parts])
    ls = torch.stack([p[2] for p in parts])
    m = ms.amax(dim=0)
    w = torch.exp(ms - m[None])
    l = (ls * w).sum(dim=0)
    o = (os_ * w[..., None]).sum(dim=0)
    return o / torch.clamp(l, min=1e-30)[..., None]


def full_attention_oracle(q, k, v, lengths, scale=None) -> torch.Tensor:
    """Plain masked softmax attention for testing partial merges."""
    o, _, l = decode_attention(q, k, v, lengths, scale)
    return o / torch.clamp(l, min=1e-30)[..., None]
