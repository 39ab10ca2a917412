"""The port's CUDA kernels on the card, at edge shapes, against their plain
versions; and the node's request mix on the card against the CPU.

Marked `cuda`: these need an NVIDIA GPU and `nvcc` and skip elsewhere.
Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

`chip_smoke.py` covers the main path's shapes (2^25-row stacks); these
cover the ragged ones: row counts that are not a multiple of the kernel's
1024-row block, 1..128 columns, odd stream lengths, single requests, one
row, one bucket and many, more than 16 value columns, the grouping's
special values (subnormals, +-0.0, +-inf, NaN, saturated keys, drop-key
rows) and its determinism, the join probe over empty, small and
larger-than-shared-memory builds with special keys and values, and a
warm join round flushed without a host sync; the DFA kernel at widths of
every alignment (1..1000 bytes, a stack starting off a 16-byte boundary),
lengths below 0, 0 and past the width, 2..256 states, zero-width rows,
and stacked string rounds flushed without a host sync; the byte-stream
cipher (`ctr_crypt_bytes`) at odd and even widths, with row ids past the
uint32 wrap and from an odd byte offset, and pre-Crypt string rounds
(stacked and partitioned) flushed without a host sync; the far-KV
decode_attention kernel at chip_smoke's shapes (granite-3-8b's block, G =
1 and 8, D = 64 and 256, G past a block's 32 query rows, rows whose bytes
take scalar loads), lengths 0, 1, ragged and full, f32 and bf16 caches,
and far-KV decode steps flushed without a host sync; the tiered gather
(`tier_gather`) over random descriptors (widths 0..33, straddling and
out-of-range offsets) and over a pool's real cold frames (plane widths
1..32, delta and dictionary planes, 3, 5, 7 and 8 columns, mixed raw and
cold pages, null-descriptor padding, NaN and subnormal payloads), B = 1
and 4, one request alone against the same request stacked, and a tiered
round flushed without a host sync.
"""
import numpy as np
import pytest
import torch

import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.pipeline import _DROP_KEY
from repro_torch.core.pool import FarPool as TFarPool
from repro_torch.core import far_kv as tfk
from repro_torch.kernels import ctr_crypt as tctr
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import dfa_match as tdfa
from repro_torch.kernels import hash_group as thg
from repro_torch.kernels import hash_join as thj
from repro_torch.kernels import select_project as tsp
from repro_torch.kernels import tier as ttier

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _table(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape).astype(np.float32)
    flat = t.reshape(-1)
    for v in (np.inf, -np.inf, np.nan, -0.0, 0.0):
        flat[rng.integers(0, flat.size, size=max(1, flat.size // 50))] = v
    flat[rng.integers(0, flat.size, size=max(1, flat.size // 50))] = (
        np.array([5, 0x807FFFFF], np.uint32).view(np.float32)[0])
    return t


@pytest.mark.parametrize("n", [1, 255, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("c", [1, 3, 9, 32])
def test_select_project_kernel_matches_plain(card, n, c):
    rng = np.random.default_rng(n * 100 + c)
    b = 3
    table = torch.from_numpy(_table(c, (b, n, c))).to(card)
    ops = rng.integers(0, 8, size=c).astype(np.int32)
    vals = rng.normal(size=c).astype(np.float32)
    proj = (rng.random(c) < 0.6).astype(np.float32)
    n_valid = torch.tensor([n, n // 2, max(0, n - 7)], dtype=torch.int32,
                           device=card)
    before = tsp.select_project.launches
    got, cnt = tsp.select_project(table, ops, vals, proj, n_valid)
    exp, ecnt = tsp.select_project_plain(table, ops, vals, proj, n_valid)
    torch.cuda.synchronize()
    assert tsp.select_project.launches == before + 1
    assert torch.equal(cnt, ecnt)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("n", [1, 1025, 5000])
@pytest.mark.parametrize("c", [33, 64, 128])
def test_select_project_kernel_matches_plain_on_wide_tables(card, n, c):
    rng = np.random.default_rng(n * 100 + c)
    table = torch.from_numpy(_table(c, (2, n, c))).to(card)
    ops = np.zeros(c, np.int32)
    vals = np.zeros(c, np.float32)
    for col in rng.choice(c, size=4, replace=False):
        ops[col] = rng.integers(1, 7)
        vals[col] = rng.normal()
    proj = (rng.random(c) < 0.5).astype(np.float32)
    n_valid = torch.tensor([n, max(0, n - 300)], dtype=torch.int32,
                           device=card)
    before = tsp.select_project.launches
    got, cnt = tsp.select_project(table, ops, vals, proj, n_valid)
    exp, ecnt = tsp.select_project_plain(table, ops, vals, proj, n_valid)
    torch.cuda.synchronize()
    assert tsp.select_project.launches == before + 1
    assert torch.equal(cnt, ecnt)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("length", [1, 2, 3, 1001, 65537])
@pytest.mark.parametrize("with_idx", [False, True])
def test_ctr_crypt_kernel_matches_plain(card, length, with_idx):
    rng = np.random.default_rng(length)
    data = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, length),
                                         dtype=np.int64).astype(np.int32))
    idx = None
    if with_idx:
        idx = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, length),
                                            dtype=np.int64).astype(np.int32))
        idx = idx.to(card)
    data = data.to(card)
    before = tctr.ctr_crypt.launches
    got = tctr.ctr_crypt(data, (0xA5A5A5A5, 0x5A5A5A5A), 0xFFFFFFFF, idx=idx)
    exp = tctr.ctr_crypt_plain(data, (0xA5A5A5A5, 0x5A5A5A5A), 0xFFFFFFFF,
                               idx=idx)
    torch.cuda.synchronize()
    assert tctr.ctr_crypt.launches == before + 1
    assert torch.equal(got, exp)


def _group_input(seed, b, n, v, integer):
    """Keys over few and many buckets, drop-key and saturated rows; values
    N(0,1) (or small integers) with subnormals, +-0.0, +-inf, NaN."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-50, 300, size=(b, n)).astype(np.int32)
    flat = keys.reshape(-1)
    for k in (_DROP_KEY, -2**31, 2**31 - 1, 0):
        flat[rng.integers(0, flat.size, size=max(1, flat.size // 40))] = k
    vals = rng.normal(size=(b, n, v)).astype(np.float32)
    if integer:
        vals = np.round(vals * 8)
    fv_ = vals.reshape(-1)
    specials = np.array([0x00000005, 0x807FFFFF, 0x80000000, 0x00000000,
                         0x7F800000, 0xFF800000, 0x7FC00000],
                        np.uint32).view(np.float32)
    for x in specials:
        fv_[rng.integers(0, fv_.size, size=max(1, fv_.size // 300))] = x
    return torch.from_numpy(keys), torch.from_numpy(vals)


def _words_nan(t):
    t = t.cpu()
    if t.dtype == torch.float32:
        t = torch.where(torch.isnan(t), float("nan"), t)   # one NaN word
        return t.view(torch.int32)
    return t


def _same_groups(got, exp, integer):
    for f in ("bucket_keys", "count", "min", "max", "overflow_mask"):
        assert torch.equal(_words_nan(got[f]), _words_nan(exp[f])), f
    gs, es = got["sum"].cpu(), exp["sum"].cpu()
    if integer:
        assert torch.equal(_words_nan(gs), _words_nan(es))
    else:
        assert torch.equal(torch.isnan(gs), torch.isnan(es))
        fin = torch.isfinite(es)
        assert torch.equal(gs[~fin & ~torch.isnan(es)],
                           es[~fin & ~torch.isnan(es)])
        assert torch.all((gs[fin] - es[fin]).abs() <= 1e-5 * es[fin].abs()
                         + 1e-6)


@pytest.mark.parametrize("n", [1, 2, 255, 1025, 5000])
@pytest.mark.parametrize("n_buckets", [2, 32, 1024])
@pytest.mark.parametrize("v,integer", [(1, True), (3, False)])
def test_hash_group_kernel_matches_plain(card, n, n_buckets, v, integer):
    keys, vals = _group_input(n * 7 + n_buckets, 3, n, v, integer)
    keys, vals = keys.to(card), vals.to(card)
    before = thg.group_aggregate.launches
    got = thg.group_aggregate(keys, vals, n_buckets)
    again = thg.group_aggregate(keys, vals, n_buckets)
    exp = thg.group_aggregate_plain(keys, vals, n_buckets)
    torch.cuda.synchronize()
    assert thg.group_aggregate.launches == before + 2
    _same_groups(got, exp, integer)
    for f in got:                               # deterministic: bitwise
        assert torch.equal(got[f].cpu().view(torch.uint8),
                           again[f].cpu().view(torch.uint8)), f


def _bytes_equal(a, b, what):
    for f in a:
        assert torch.equal(a[f].cpu().view(torch.uint8),
                           b[f].cpu().view(torch.uint8)), (what, f)


def _group_paths(card, keys, vals, nb, integer):
    """Both private paths of `group_aggregate` (the direct one where
    direct_chunk takes n_buckets, else the .cu refuses it) on the same
    inputs against the plain version by `_same_groups`, each launched
    twice and bitwise equal; the public wrapper bitwise equal to the path
    n_buckets picks. Returns the picked path's result."""
    lib = _build.lib("hash_group.cu")
    keys, vals = keys.to(card), vals.to(card)
    exp = thg.group_aggregate_plain(keys, vals, nb)
    got = {}
    for path in (thg._direct, thg._sorted):
        def run():
            return path(lib, keys, vals, nb, torch.empty(
                keys.shape, dtype=torch.bool, device=card))
        if path is thg._direct and not thg.direct_chunk(nb):
            with pytest.raises(RuntimeError, match="direct path"):
                run()
            continue
        got[path], again = run(), run()
        torch.cuda.synchronize()
        _same_groups(got[path], exp, integer)
        _bytes_equal(got[path], again, path.__name__)
    before = thg.group_aggregate.launches
    pub = thg.group_aggregate(keys, vals, nb)
    assert thg.group_aggregate.launches == before + 1
    picked = got[thg._direct if thg.direct_chunk(nb) else thg._sorted]
    _bytes_equal(pub, picked, "group_aggregate")
    return picked


def test_direct_chunk_equals_the_librarys(card):
    """The host's copy of the direct path's shared-memory layout
    (`direct_chunk`) gives the library's hg_direct_chunk at every power of
    two up to 2^20 buckets."""
    lib = _build.lib("hash_group.cu")
    for nb in (1 << e for e in range(21)):
        assert thg.direct_chunk(nb) == lib.hg_direct_chunk(nb), nb


@pytest.mark.parametrize("n", [70001, 1])
@pytest.mark.parametrize("v", [1, 16, 17, 20])
@pytest.mark.parametrize("nb", [1, 1024, 4096, 8192])
def test_hash_group_paths_match_plain(card, nb, v, n):
    """The direct path (up to 4096 buckets) and the sort path on each side
    of the direct path's limit, value columns in one chunk and in several
    (1024 buckets: 5 a chunk; 4096: 1), many blocks with a ragged last one
    (70001 rows) and a stack of one-row requests. Integer values with
    +-inf, NaN, -0.0 and subnormals bitwise; |N(0,1)| values (sums without
    cancellation, so |sum| scales their rounding) within `_same_groups`'
    tolerance. Keys include INT32_MIN, INT32_MAX and the drop key."""
    for integer in (True, False):
        keys, vals = _group_input(nb + 31 * v + n, 2, n, v, integer)
        _group_paths(card, keys, vals if integer else vals.abs(), nb,
                     integer)


@pytest.mark.parametrize("nb", [256, 4096])
@pytest.mark.parametrize("kind", ["one_key", "drop_key", "zipf"])
def test_hash_group_hot_buckets_match_plain(card, kind, nb):
    """Hot buckets on both paths: every row one key (a bucket holding all
    rows, 32 peers a warp group), 90% drop-key rows (a selective
    predicate's) and Zipf-skewed keys."""
    rng = np.random.default_rng(nb)
    n = 200003
    for integer in (True, False):
        keys, vals = _group_input(n + nb, 2, n, 2, integer)
        k = keys.numpy()
        if kind == "one_key":
            k[:] = 12345
        elif kind == "drop_key":
            k[rng.random(k.shape) < 0.9] = _DROP_KEY
        else:
            k[:] = np.minimum(rng.zipf(1.3, size=k.shape), 2**31 - 1)
        got = _group_paths(card, keys, vals if integer else vals.abs(), nb,
                           integer)
        if kind == "one_key":
            assert int(got["count"].max()) == n


@pytest.mark.parametrize("nb,v", [(1024, 2), (256, 17), (8192, 1)])
@pytest.mark.parametrize("n", [70001, 2_100_003])
def test_hash_group_stacked_equals_solo_bitwise(card, nb, v, n):
    """One request of N(0,1) values gives the same bits alone and stacked
    with 3 others, on both sides of the path choice: its row ranges, and
    so the order of its f32 sums, are fixed by its own rows alone
    (2_100_003 rows reach the direct path's cap of 256 blocks a
    request)."""
    keys, vals = _group_input(n + nb + v, 4, n, v, False)
    keys, vals = keys.to(card), vals.to(card)
    solo = thg.group_aggregate(keys[2:3].contiguous(),
                               vals[2:3].contiguous(), nb)
    stacked = thg.group_aggregate(keys, vals, nb)
    torch.cuda.synchronize()
    for f in solo:
        assert torch.equal(solo[f][0].cpu().view(torch.uint8),
                           stacked[f][2].cpu().view(torch.uint8)), f


@pytest.mark.parametrize("n", [1, 300, 4099])
def test_group_prep_kernel_matches_plain(card, n):
    rng = np.random.default_rng(n)
    t = _table(n, (3, n, 8))
    # key column 0: half-way values, NaN, +-inf, +-1e10, a subnormal
    kc = (np.round(rng.normal(size=(3, n)) * 50) / 2).astype(np.float32)
    words = np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 2.5, -0.5, 3.5,
                      1e-40], np.float32)
    flat = kc.reshape(-1)
    flat[::13] = words[np.arange(flat[::13].size) % words.size]
    t[:, :, 0] = kc
    table = torch.from_numpy(t).to(card)
    ops = np.array([0, 1, 0, 4, 0, 0, 6, 0], np.int32)
    sel = np.array([0, 0.5, 0, -1.0, 0, 0, 0.0, 0], np.float32)
    n_valid = torch.tensor([n, n // 2, max(0, n - 9)], dtype=torch.int32,
                           device=card)
    before = thg.group_prep.launches
    got = thg.group_prep(table, 0, [2, 5, 0], ops, sel, n_valid, _DROP_KEY)
    exp = thg.group_prep_plain(table, 0, [2, 5, 0], ops, sel, n_valid,
                               _DROP_KEY)
    torch.cuda.synchronize()
    assert thg.group_prep.launches == before + 1
    assert torch.equal(got[0], exp[0])
    assert torch.equal(got[1].view(torch.int32), exp[1].view(torch.int32))


def test_wide_group_prep_and_many_value_columns_match_plain(card):
    """C = 64 table columns, V = 20 value columns: two chunks of the
    aggregation over one bucket sort."""
    rng = np.random.default_rng(64)
    t = _table(64, (2, 3000, 64))
    t[:, :, 5] = rng.integers(0, 300, size=(2, 3000))
    table = torch.from_numpy(t).to(card)
    ops = np.zeros(64, np.int32)
    sel = np.zeros(64, np.float32)
    ops[63], sel[63] = 1, 0.5
    vcols = list(range(40, 60))
    n_valid = torch.tensor([3000, 2222], dtype=torch.int32, device=card)
    before = (thg.group_prep.launches, thg.group_aggregate.launches)
    keys, vals = thg.group_prep(table, 5, vcols, ops, sel, n_valid, _DROP_KEY)
    ek, ev = thg.group_prep_plain(table, 5, vcols, ops, sel, n_valid,
                                  _DROP_KEY)
    assert torch.equal(keys, ek)
    assert torch.equal(vals.view(torch.int32), ev.view(torch.int32))
    for integer in (True, False):
        v = torch.round(vals * 4) if integer else vals
        v = torch.where(torch.isfinite(vals), v, vals)
        got = thg.group_aggregate(keys, v, 256)
        exp = thg.group_aggregate_plain(keys, v, 256)
        torch.cuda.synchronize()
        _same_groups(got, exp, integer)
    assert (thg.group_prep.launches, thg.group_aggregate.launches) == (
        before[0] + 1, before[1] + 2)


def _join_input(seed, b, n, k):
    """A (b, n, 3) f32 probe stack (key column 1: integers, NaN, +-inf,
    +-2^31, +-1e10, halves, a subnormal) and a build of k unique keys
    (the saturated ones among them) with special value words."""
    rng = np.random.default_rng(seed)
    probe = rng.normal(size=(b, n, 3)).astype(np.float32)
    keys = rng.integers(-2 * k - 5, 2 * k + 5, size=(b, n)).astype(np.float32)
    words = np.array([np.nan, np.inf, -np.inf, 2.0**31, -2.0**31, 1e10,
                      -1e10, 2.5, -0.5, 3.5, 1e-40], np.float32)
    at = rng.random((b, n)) < 0.1
    keys[at] = rng.choice(words, at.sum())
    probe[..., 1] = keys
    pool = np.unique(np.concatenate([
        rng.permutation(np.arange(-2 * k - 5, 2 * k + 5))[:k],
        [2**31 - 1, -2**31, 0, 2, 4]]).astype(np.int32))
    bk = rng.permutation(pool)[:k]
    bv = rng.normal(size=(k, 2)).astype(np.float32)
    specials = np.array([0x7FC00000, 0x7FC0BEEF, 0x7F800000, 0xFF800000,
                         0x80000000, 0x00000005, 0x807FFFFF],
                        np.uint32).view(np.float32)
    hit = rng.random(bv.shape) < 0.3
    bv[hit] = rng.choice(specials, hit.sum())
    return probe, bk, bv


@pytest.mark.parametrize("k", [0, 1, 64, 512, 65536])
@pytest.mark.parametrize("b", [1, 4])
def test_hash_join_kernel_matches_plain(card, k, b):
    n = 5000
    probe, bk, bv = _join_input(k + b, b, n, k)
    probe = torch.from_numpy(probe).to(card)
    bk, bv = torch.from_numpy(bk).to(card), torch.from_numpy(bv).to(card)
    n_valid = torch.tensor([n, n - 1, 1, 0][:b], dtype=torch.int32,
                           device=card)
    before = thj.hash_join.launches
    got = thj.hash_join(probe, 1, bk, bv, n_valid)
    exp = thj.hash_join_plain(probe, 1, bk, bv, n_valid)
    # the widened rows, from a view with a stride between requests
    big = torch.cat([probe, probe[:, :77]], 1)
    wide = torch.zeros((b, n, 7), device=card)
    thj.hash_join(big[:, :n], 1, bk, bv, n_valid, out=wide)
    ewide = thj.hash_join_plain(probe, 1, bk, bv, n_valid,
                                out=torch.zeros((b, n, 7), device=card))
    # int32 keys taken as they are
    ikeys = torch.where(torch.isfinite(probe), probe, 0.0).clamp(
        -1e9, 1e9).to(torch.int32)
    igot = thj.hash_join(ikeys, 1, bk, bv, n_valid)
    iexp = thj.hash_join_plain(ikeys, 1, bk, bv, n_valid)
    torch.cuda.synchronize()
    assert thj.hash_join.launches == before + (3 if k else 0)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    assert torch.equal(wide.view(torch.int32), ewide.view(torch.int32))
    assert torch.equal(igot.view(torch.int32), iexp.view(torch.int32))
    if k:
        assert int(got[..., 5].sum()) > 0


@pytest.mark.parametrize("k", [512, 65536])
def test_hash_join_kernel_widens_rows_wider_than_the_tile(card, k):
    """40-word probe rows: the widened output rows (43 words) are written
    straight, not through the shared-memory tile."""
    n = 3000
    probe, bk, bv = _join_input(k, 2, n, k)
    probe = torch.from_numpy(np.concatenate(
        [probe] + [probe[..., :1] * 2] * 37, 2)).to(card)
    bk, bv = torch.from_numpy(bk).to(card), torch.from_numpy(bv).to(card)
    n_valid = torch.tensor([n, 1234], dtype=torch.int32, device=card)
    got = thj.hash_join(probe, 1, bk, bv, n_valid,
                        out=torch.empty((2, n, 44), device=card))
    exp = thj.hash_join_plain(probe, 1, bk, bv, n_valid,
                              out=torch.empty((2, n, 44), device=card))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


def _dfa_input(seed, b, n, w):
    """(b, n, w) bytes over letters, 0 and >= 128, with tokens the test
    patterns match planted in a fifth of the rows each; lengths in
    [-3, w + 3] (below 0, 0 and above the width among them)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"aeerrxzfq \x00\x80\xff", np.uint8)
    mat = alphabet[rng.integers(0, alphabet.size, (b, n, w))]
    for tok in (b"err", b"exxfr", b"eaqrx"):
        if len(tok) <= w:
            rows = rng.random((b, n)) < 0.2
            at = int(rng.integers(0, w - len(tok) + 1))
            mat[rows, at: at + len(tok)] = np.frombuffer(tok, np.uint8)
    lens = rng.integers(-3, w + 4, (b, n)).astype(np.int32)
    return mat, lens


@pytest.mark.parametrize("w", [1, 3, 16, 17, 32, 40, 64, 128, 253, 1000])
@pytest.mark.parametrize("pattern", ["err", "e(r|x)+[a-f]*r?",
                                     "(a|e)....[xz]"])
def test_dfa_match_kernel_matches_plain(card, w, pattern):
    """Widths of every alignment (tiles of 256 rows up to 252 bytes, fewer
    above), ragged n_valid (0, 1, past n), and a stack that starts one
    byte into its buffer."""
    from repro_torch.core.regex import compile_regex
    b, n = 3, 5000
    mat, lens = _dfa_input(w, b, n, w)
    table, accept = tdfa.prepare_dfa(*compile_regex(pattern), card)
    strings = torch.from_numpy(mat).to(card)
    lengths = torch.from_numpy(lens).to(card)
    for nv in ([n, n - 1, 0], [1, 257, n + 9]):
        n_valid = torch.tensor(nv, dtype=torch.int32, device=card)
        before = tdfa.dfa_match.launches
        got = tdfa.dfa_match(strings, lengths, n_valid, table, accept)
        exp = tdfa.dfa_match_plain(strings, lengths, n_valid, table, accept)
        torch.cuda.synchronize()
        assert tdfa.dfa_match.launches == before + 1
        assert torch.equal(got, exp)
    assert 0 < int(exp.sum()) < exp.numel() or w < 16
    buf = torch.zeros(b * n * w + 1, dtype=torch.uint8, device=card)
    buf[1:] = strings.view(-1)
    got = tdfa.dfa_match(buf[1:].view(b, n, w), lengths, n_valid, table,
                         accept)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


def test_dfa_match_kernel_takes_256_states_and_refuses_more(card):
    rng = np.random.default_rng(3)
    mat, lens = _dfa_input(5, 2, 3000, 40)
    strings = torch.from_numpy(mat).to(card)
    lengths = torch.from_numpy(lens).to(card)
    n_valid = torch.tensor([3000, 1500], dtype=torch.int32, device=card)
    for s in (2, 200, 256):
        table, accept = tdfa.prepare_dfa(
            rng.integers(0, s, (s, 256)), rng.random(s) < 0.5, card)
        got = tdfa.dfa_match(strings, lengths, n_valid, table, accept)
        exp = tdfa.dfa_match_plain(strings, lengths, n_valid, table, accept)
        torch.cuda.synchronize()
        assert torch.equal(got, exp)
    table, accept = tdfa.prepare_dfa(rng.integers(0, 257, (257, 256)),
                                     np.ones(257, bool), card)
    with pytest.raises(ValueError, match="states"):
        tdfa.dfa_match(strings, lengths, n_valid, table, accept)
    # zero-width strings: every valid row ends in state 0
    empty = torch.empty((2, 3000, 0), dtype=torch.uint8, device=card)
    table, accept = tdfa.prepare_dfa(np.zeros((1, 256)), [True], card)
    got = tdfa.dfa_match(empty, lengths, n_valid, table, accept)
    exp = tdfa.dfa_match_plain(empty, lengths, n_valid, table, accept)
    torch.cuda.synchronize()
    assert torch.equal(got, exp) and int(got.sum()) == 4500


def test_string_round_never_waits_and_matches_the_cpu(card):
    """Stacked regex rounds of mixed rows and widths (one dispatch per
    signature) and a solo string request flush under sync debug mode
    "error"; masks and byte counts equal the CPU node's."""
    results = []
    for device in (card, torch.device("cpu")):
        node = fv.FViewNode(8 * 2**20, n_regions=5, device=device)
        qps = [fv.open_connection(node) for _ in range(5)]
        sizes = [(3000, 64), (2500, 48), (2100, 64), (2049, 40), (100, 16)]
        reqs_in = []
        for i, (n, w) in enumerate(sizes):
            mat, lens = _dfa_input(i, 1, n, w)
            ft = fv.FTable(f"s{i}", (fv.Column("bytes", "str"),), n_rows=n,
                           str_width=w)
            reqs_in.append((ft, mat[0], lens[0]))
        pipes = [(op.RegexMatch("err"),),
                 (op.RegexMatch("e(r|x)+[a-f]*r?"),
                  op.Crypt((4, 5), 6, "post"))]
        before = (tdfa.dfa_match.launches, tctr.ctr_crypt.launches,
                  node.dispatches)
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            reqs = [fv.submit_request(qp, ft, p, strings=m, lengths=ln)
                    for p in pipes for qp, (ft, m, ln) in zip(qps, reqs_in)]
            node.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # per pipeline: the four 4096-row requests stack, the 100-row one
        # runs alone
        assert node.dispatches == before[2] + 4
        if device.type == "cuda":
            assert (tdfa.dfa_match.launches, tctr.ctr_crypt.launches) == (
                before[0] + 4, before[1])
        res = [r.wait() for r in reqs]
        assert all(r.mask.device.type == device.type for r in res)
        results.append(([r.mask.cpu() for r in res],
                        [(r.shipped_bytes, r.read_bytes) for r in res]))
    (mask_g, meta_g), (mask_c, meta_c) = results
    assert meta_g == meta_c
    assert meta_c[0] == (3000, 3000 * 64)
    for g, c in zip(mask_g, mask_c):
        assert torch.equal(g, c)


BYTE_KEY, BYTE_NONCE = (0x0BADF00D, 0x5EED5EED), 1234


def _byte_row_ids(rng, kind, b, n, w):
    """(b, n) int32 row ids: none, a permutation, or ids whose row_id * w
    (uint32) passes 2^31 and, where w > 1, 2^32 (negative ids among
    them)."""
    if kind == "stream":
        return None
    if kind == "row_ids":
        return rng.permutation(4 * b * n)[: b * n].reshape(b, n)
    pool = np.concatenate([c + np.arange(-n, n) for c in (
        2**31 // w, min(2**32 // w, 2**31 - 1))] + [-1 - np.arange(n)])
    return rng.choice(pool, (b, n)).astype(np.int64).astype(np.int32)


@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("kind", ["stream", "row_ids", "wrapping_row_ids"])
@pytest.mark.parametrize("w", [1, 17, 40, 64])
def test_ctr_crypt_bytes_kernel_matches_plain(card, w, kind, n):
    """The byte-stream entry against its plain version, bitwise: odd and
    even widths (rows starting on odd positions), row ids past the uint32
    wrap, one launch counted; its own inverse; the same result from a
    stack starting one byte into its buffer; the input left as it was."""
    rng = np.random.default_rng(w * 100 + n + len(kind))
    b = 3
    data = torch.from_numpy(rng.integers(0, 256, (b, n * w),
                                         dtype=np.uint8)).to(card)
    ids = _byte_row_ids(rng, kind, b, n, w)
    ids = None if ids is None else torch.from_numpy(
        np.asarray(ids, np.int32)).to(card)
    kept = data.clone()
    before = tctr.ctr_crypt_bytes.launches
    got = tctr.ctr_crypt_bytes(data, BYTE_KEY, BYTE_NONCE, ids, w)
    exp = tctr.ctr_crypt_bytes_plain(data, BYTE_KEY, BYTE_NONCE, ids, w)
    torch.cuda.synchronize()
    assert tctr.ctr_crypt_bytes.launches == before + 1
    assert torch.equal(got, exp)
    assert torch.equal(data, kept)
    assert torch.equal(tctr.ctr_crypt_bytes(got, BYTE_KEY, BYTE_NONCE, ids,
                                            w), data)
    buf = torch.zeros(data.numel() + 1, dtype=torch.uint8, device=card)
    buf[1:] = data.view(-1)
    odd = tctr.ctr_crypt_bytes(buf[1:].view(b, n * w), BYTE_KEY, BYTE_NONCE,
                               ids, w)
    torch.cuda.synchronize()
    assert torch.equal(odd, exp)


def test_ctr_crypt_bytes_kernel_refuses_what_it_does_not_take(card):
    data = torch.zeros((2, 12), dtype=torch.uint8, device=card)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="uint8"):
        tctr.ctr_crypt_bytes(data.int(), BYTE_KEY, BYTE_NONCE)
    with pytest.raises(ValueError, match="width"):
        tctr.ctr_crypt_bytes(data, BYTE_KEY, BYTE_NONCE, ids, 5)
    with pytest.raises(ValueError, match="one id a row"):
        tctr.ctr_crypt_bytes(data, BYTE_KEY, BYTE_NONCE, ids.cpu(), 4)
    empty = torch.zeros((2, 0), dtype=torch.uint8, device=card)
    before = tctr.ctr_crypt_bytes.launches
    assert tctr.ctr_crypt_bytes(empty, BYTE_KEY, BYTE_NONCE).shape == (2, 0)
    assert tctr.ctr_crypt_bytes.launches == before


def test_pre_crypt_string_rounds_never_wait_and_match_the_cpu(card):
    """Pre-Crypt regex rounds flushed under sync debug mode "error": three
    requests of width 64 and mixed rows (one dispatch), one of width 48
    (its own: the width is pinned), then one encrypted table in three
    partitions with their row ids (one dispatch); one byte-cipher launch
    and one dfa_match launch a dispatch, no word cipher; masks and byte
    counts equal the CPU node's, the partitions' masks scattered back the
    whole table's."""
    pipe = (op.Crypt(BYTE_KEY, BYTE_NONCE, "pre"), op.RegexMatch("err"))
    sizes = [(3000, 64), (2500, 64), (2100, 64), (1000, 48)]
    reqs_in = []
    for i, (n, w) in enumerate(sizes):
        mat, lens = _dfa_input(i, 1, n, w)
        enc = tctr.ctr_crypt_bytes_plain(torch.from_numpy(mat[0].reshape(
            1, -1)), BYTE_KEY, BYTE_NONCE).numpy().reshape(n, w)
        reqs_in.append((fv.FTable(f"s{i}", (fv.Column("bytes", "str"),),
                                  n_rows=n, str_width=w), enc, lens[0],
                        None))
    n, w = 4001, 40
    mat, lens = _dfa_input(9, 1, n, w)
    table = tctr.ctr_crypt_bytes_plain(torch.from_numpy(mat[0].reshape(
        1, -1)), BYTE_KEY, BYTE_NONCE).numpy().reshape(n, w)
    parts = np.array_split(np.random.default_rng(9).permutation(n), 3)
    part_in = [(fv.FTable(f"p{i}", (fv.Column("bytes", "str"),),
                          n_rows=len(p), str_width=w), table[p], lens[0][p],
                p) for i, p in enumerate(parts)]
    results = []
    for device in (card, torch.device("cpu")):
        node = fv.FViewNode(8 * 2**20, n_regions=4, device=device)
        qps = [fv.open_connection(node) for _ in range(4)]
        got = []
        for batch, dispatches in ((reqs_in, 2), (part_in, 1)):
            before = (tdfa.dfa_match.launches, tctr.ctr_crypt_bytes.launches,
                      tctr.ctr_crypt.launches, node.dispatches)
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                reqs = [fv.submit_request(qp, ft, pipe, strings=m,
                                          lengths=ln, row_ids=rid)
                        for qp, (ft, m, ln, rid) in zip(qps, batch)]
                node.flush()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert node.dispatches == before[3] + dispatches
            if device.type == "cuda":
                assert (tdfa.dfa_match.launches,
                        tctr.ctr_crypt_bytes.launches,
                        tctr.ctr_crypt.launches) == (
                    before[0] + dispatches, before[1] + dispatches,
                    before[2])
            got += [r.wait() for r in reqs]
        results.append(([r.mask.cpu() for r in got],
                        [(r.shipped_bytes, r.read_bytes) for r in got]))
    (mask_g, meta_g), (mask_c, meta_c) = results
    assert meta_g == meta_c
    assert meta_c[0] == (3000, 3000 * 64)
    for g, c in zip(mask_g, mask_c):
        assert torch.equal(g, c)
    whole = tdfa.dfa_match_plain(
        torch.from_numpy(mat), torch.from_numpy(lens),
        torch.tensor([n], dtype=torch.int32),
        *tdfa.prepare_dfa(*_regex_tables("err"), "cpu"))[0]
    scattered = torch.zeros(n, dtype=torch.bool)
    for m, p in zip(mask_g[len(reqs_in):], parts):
        scattered[torch.from_numpy(p)] = m
    assert torch.equal(scattered, whole) and 0 < int(whole.sum()) < n


def _regex_tables(pattern):
    from repro_torch.core.regex import compile_regex
    return compile_regex(pattern)


def test_flush_never_waits_for_the_card(card):
    """The lazy contract: from submit through flush nothing synchronises
    with the device (torch raises on a synchronising call while the sync
    debug mode is "error"); finalize is where the host waits."""
    node = fv.FViewNode(8 * 2**20, page_bytes=64 * 2**10, device=card)
    qps = [fv.open_connection(node) for _ in range(2)]
    cols = tuple(fv.Column(f"c{i}") for i in range(8))
    ft = fv.alloc_table_mem(qps[0], fv.FTable("t", cols, 3000))
    fv.table_write(qps[0], ft, _table(0, (3000, 8)))
    sel = op.Select((op.Predicate("c1", "<", 0.1),))
    pipes = [(sel,), (op.SmartAddress(("c5", "c2")), sel),
             (op.Crypt((1, 2), 3, "pre"), op.Project(("c0",)), sel,
              op.Crypt((4, 5), 6, "post")),
             (op.Crypt((1, 2), 3, "pre"), op.SmartAddress(("c3", "c1")),
              sel),
             (op.GroupBy("c0", ("c1", "c2"), n_buckets=64),),
             (sel, op.Distinct(("c0",), n_buckets=16))]
    torch.cuda.set_sync_debug_mode("error")
    try:
        reqs = [fv.submit_request(qp, ft, p) for p in pipes for qp in qps]
        reqs.append(fv.submit_request(qps[0], ft, pipes[2],
                                      row_ids=np.arange(3000) + 9))
        node.flush()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(r.wait().shipped_bytes > 0 for r in reqs)
    assert node.dispatches == len(pipes) + 1


def test_warm_join_round_never_waits_and_matches_the_cpu(card):
    """A join round after the build's first (cold) round flushes under
    sync debug mode "error"; its results equal the CPU node's."""
    results = []
    for device in (card, torch.device("cpu")):
        node = fv.FViewNode(8 * 2**20, page_bytes=64 * 2**10, device=device)
        qps = [fv.open_connection(node) for _ in range(4)]
        rng = np.random.default_rng(5)
        pcols = (fv.Column("k", "i32"), fv.Column("a"), fv.Column("b"))
        probes = []
        for i, n in enumerate((3000, 2500, 2100, 2049)):
            ft = fv.alloc_table_mem(qps[0], fv.FTable(f"p{i}", pcols, n))
            fv.table_write(qps[0], ft, ft.encode({
                "k": rng.integers(0, 1024, n).astype(np.int32),
                "a": rng.random(n).astype(np.float32),
                "b": rng.random(n).astype(np.float32)}))
            probes.append(ft)
        dim = fv.alloc_table_mem(qps[0], fv.FTable(
            "dim", (fv.Column("k", "i32"), fv.Column("v")), 512))
        fv.table_write(qps[0], dim, dim.encode({
            "k": rng.permutation(1024)[:512].astype(np.int32),
            "v": rng.random(512).astype(np.float32)}))
        join = op.JoinSmall("k", "dim", "k", ("v",))
        pipes = [(join,), (op.Select((op.Predicate("a", "<", 0.5),)), join),
                 (join, op.Crypt((4, 5), 6, "post"))]
        for p in pipes:                     # cold: the host check runs
            for r in [fv.submit_request(qp, ft, p)
                      for qp, ft in zip(qps, probes)]:
                r.wait()
        before = (thj.hash_join.launches, node.dispatches)
        if device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            reqs = [fv.submit_request(qp, ft, p)
                    for p in pipes for qp, ft in zip(qps, probes)]
            node.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if device.type == "cuda":
            assert thj.hash_join.launches == before[0] + len(pipes)
        assert node.dispatches == before[1] + len(pipes)
        res = [r.wait() for r in reqs]
        results.append(([r.rows.cpu() for r in res],
                        [(r.count, r.shipped_bytes, r.read_bytes)
                         for r in res]))
    (rows_g, meta_g), (rows_c, meta_c) = results
    assert meta_g == meta_c
    for g, c in zip(rows_g, rows_c):
        assert torch.equal(g.view(torch.int32), c.view(torch.int32))


def test_node_mix_on_the_card_matches_the_cpu(card):
    results = []
    for device in (card, torch.device("cpu")):
        node = fv.FViewNode(8 * 2**20, page_bytes=64 * 2**10, device=device)
        qps = [fv.open_connection(node) for _ in range(3)]
        cols = tuple(fv.Column(f"c{i}") for i in range(8))
        tables = []
        for i, n in enumerate((3000, 2100, 700)):
            ft = fv.alloc_table_mem(qps[0], fv.FTable(f"t{i}", cols, n))
            fv.table_write(qps[0], ft, _table(i, (n, 8)))
            tables.append(ft)
        sel = op.Select((op.Predicate("c1", "<", 0.1),))
        pipes = [(sel,), (op.SmartAddress(("c5", "c2")), sel),
                 (op.Crypt((1, 2), 3, "pre"), sel, op.Crypt((4, 5), 6,
                                                            "post"))]
        groups = [(op.Crypt((1, 2), 3, "pre"), sel,
                   op.GroupBy("c0", ("c2",), n_buckets=32)),
                  (op.Distinct(("c0",), n_buckets=8),)]
        reqs = [fv.submit_request(qp, ft, p)
                for p in pipes for qp, ft in zip(qps, tables)]
        reqs.append(fv.submit_request(qps[0], tables[0], pipes[0],
                                      row_ids=np.arange(3000) * 2 + 1))
        greqs = [fv.submit_request(qp, ft, p)
                 for p in groups for qp, ft in zip(qps, tables)]
        node.flush()
        res = [r.wait() for r in reqs]
        gres = [r.wait() for r in greqs]
        results.append((gres, [r.rows.cpu() for r in res],
                         [(r.count, r.shipped_bytes, r.read_bytes)
                          for r in res], res[-1].sel_ids, node.dispatches,
                         [(qp.bytes_read_pool, qp.bytes_shipped)
                          for qp in qps]))
    (grp_g, rows_g, meta_g, ids_g, disp_g, qp_g), (
        grp_c, rows_c, meta_c, ids_c, disp_c, qp_c) = results
    assert meta_g == meta_c and disp_g == disp_c and qp_g == qp_c
    for g, c in zip(grp_g, grp_c):
        assert (g.shipped_bytes, g.read_bytes) == (c.shipped_bytes,
                                                   c.read_bytes)
        gg, cg = g.groups, c.groups
        for f in ("bucket_keys", "count", "min", "max"):
            assert torch.equal(_words_nan(gg[f]), _words_nan(cg[f])), f
        assert torch.allclose(gg["sum"].cpu(), cg["sum"], rtol=1e-5,
                              atol=1e-5, equal_nan=True)
        np.testing.assert_array_equal(gg["ovf_keys"], cg["ovf_keys"])
        np.testing.assert_array_equal(gg["ovf_vals"].view(np.uint32),
                                      cg["ovf_vals"].view(np.uint32))
    np.testing.assert_array_equal(ids_g, ids_c)
    for g, c in zip(rows_g, rows_c):
        assert torch.equal(g.view(torch.int32), c.view(torch.int32))


def test_call_without_device_runs_on_the_card(card):
    cols = tuple(fv.Column(f"c{i}") for i in range(8))
    pipe = fv.compile_pipeline(fv.FTable("t", cols, 0), (
        op.Crypt((1, 2), 3, "pre"), op.Select((op.Predicate("c1", "<",
                                                            0.1),)),
        op.Crypt((4, 5), 6, "post")))
    rows = _table(5, (3000, 8))
    ids = np.arange(3000) * 3 + 2
    before = (tsp.select_project.launches, tctr.ctr_crypt.launches)
    got = pipe(rows, row_ids=ids)                   # numpy in, card runs
    assert got.rows.device.type == "cuda"
    assert (tsp.select_project.launches, tctr.ctr_crypt.launches) == (
        before[0] + 1, before[1] + 2)
    exp = pipe(rows, row_ids=ids, device="cpu")
    assert (got.count, got.shipped_bytes, got.read_bytes) == (
        exp.count, exp.shipped_bytes, exp.read_bytes)
    np.testing.assert_array_equal(got.sel_ids, exp.sel_ids)
    assert torch.equal(got.rows.cpu().view(torch.int32),
                       exp.rows.view(torch.int32))


def test_full_and_distinct_without_device_run_on_the_card(card):
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 500, 3000).astype(np.int32)
    vals = rng.integers(-9, 9, (3000, 2)).astype(np.float32)
    before = thg.group_aggregate.launches
    got = tops.group_aggregate_full(keys, vals, n_buckets=32)
    assert thg.group_aggregate.launches == before + 1
    exp = tops.group_aggregate_full(keys, vals, n_buckets=32, device="cpu")
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k][0] == exp[k][0]
        for a, b in zip(got[k][1:], exp[k][1:]):
            np.testing.assert_array_equal(a, b)
    assert tops.distinct(keys, n_buckets=32) == sorted(set(keys.tolist()))
    assert thg.group_aggregate.launches == before + 2


# ------------------------------------------------------------ decode_attention
# (P, B, S, Hkv, G, D): chip_smoke's smoke shape (granite-3-8b's block over
# a 16-shard pool of 2048 rows), G = 1, 2 and 3 (the tensor-core kernel's
# three instances in bf16, G = 3 with a padding row), G = 8 at D = 64 (f32
# FMAs), D = 256 (at G = 8, the FMA kernel's largest shared memory in
# f32), G past a block's 8 query rows, and D = 20 (a bf16 row of 40 bytes:
# scalar loads)
DA_SHAPES = [(16, 8, 2048, 8, 4, 128), (2, 3, 300, 2, 1, 64),
             (2, 3, 300, 2, 2, 128), (2, 2, 100, 2, 3, 64),
             (2, 3, 300, 1, 8, 64), (2, 2, 100, 2, 4, 256),
             (2, 2, 100, 1, 8, 256), (1, 2, 70, 2, 40, 32),
             (2, 2, 50, 2, 3, 20)]
DA_TOL = dict(rtol=1e-5, atol=1e-5)      # f32 sums in other orders
# o sums up to 2048 signed terms p v in f32 in another order than cuBLAS:
# the two differ by up to 7.8e-5 where o is near 0 (on an H100), so o
# is held within 1e-5 of its sum of |terms|, sum p |v| (the rule of the
# group sums); l's terms are positive, so allclose is that rule for it
DA_REL_TOL = 1e-5


def _assert_sums_close(o, eo, o_abs):
    excess = (o - eo).abs() - DA_REL_TOL * o_abs
    assert float(excess.max()) <= 0.0, float((o - eo).abs().max())


def _da_inputs(card, shape, dtype, seed=0):
    p, b, s, hkv, g, d = shape
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q = torch.randn((p, b, hkv * g, d), generator=gen, device=card)
    k = torch.randn((p, b, s, hkv, d), generator=gen, device=card).to(dtype)
    v = torch.randn((p, b, s, hkv, d), generator=gen, device=card).to(dtype)
    # 0, 1, full and ragged lengths, spread over the (p, b) grid
    lens = torch.randint(0, s + 1, (p * b,), generator=gen, device=card)
    lens[0::4] = 0
    lens[1::4] = 1
    lens[2::4] = s
    return q, k, v, lens.view(p, b).to(torch.int32)


def _check_decode_attention(q, k, v, lens, scale):
    """One launch against the plain version by the DA rules, the empty
    (p, b) rule and bitwise determinism."""
    before = tda.decode_attention.launches
    o, m, l = tda.decode_attention(q, k, v, lens, scale)
    eo, em, el = tda.decode_attention_plain(q, k, v, lens, scale)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    o_abs = tda.decode_attention_plain(q, k, v.abs(), lens, scale)[0]
    _assert_sums_close(o, eo, o_abs)
    torch.testing.assert_close(l, el, **DA_TOL)
    torch.testing.assert_close(m, em, **DA_TOL)
    empty = (lens == 0)[..., None].expand_as(m)
    assert bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
    assert bool((o[empty] == 0).all())
    # deterministic: the warps and the splits fold in a fixed order
    o2, m2, l2 = tda.decode_attention(q, k, v, lens, scale)
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)


def _poison(k, v, lens, where):
    """A non-finite K or V element in every other (p, b) with rows: +inf,
    -inf and NaN in K and in V by turns, inside the length ("in") or at
    its last row ("last"); or +inf, -inf and NaN in V at or past it
    ("past", where rows remain). Returns the (p, b) indices poisoned."""
    p, b, s, hkv, d = k.shape
    kinds = [(k, float("inf")), (k, -float("inf")), (k, float("nan")),
             (v, float("inf")), (v, -float("inf")), (v, float("nan"))]
    hit = []
    for j, n in enumerate(lens.view(-1).tolist()):
        if j % 2 or (n >= s if where == "past" else n == 0):
            continue
        t, val = kinds[(j // 2) % 6]
        if where == "past":
            t, val, row = v, kinds[(j // 2) % 3][1], n + (j * 7) % (s - n)
        else:
            row = n - 1 if where == "last" else (j * 31) % n
        t[j // b, j % b, row, j % hkv, (j * 5) % d] = val
        hit.append(j)
    return hit


def _same_places(got, exp, what):
    """NaN and inf in the same places, inf with the same sign."""
    assert torch.equal(torch.isnan(got), torch.isnan(exp)), what
    inf = torch.isinf(exp)
    assert torch.equal(torch.isinf(got), inf), what
    assert torch.equal(got[inf], exp[inf]), what


# (Hkv, G, D, cache dtype) of each kernel: tensor cores (bf16, D = 128 and
# 64, G <= 4), FMA (f32 at G = 4, bf16 at G = 8) and staging (bf16 rows of
# 40 bytes, scalar loads); S = 32 is one split, S = 600 several
DA_NONFINITE = {"tensor": (2, 4, 128, torch.bfloat16),
                "tensor_d64": (2, 2, 64, torch.bfloat16),
                "fma": (2, 4, 128, torch.float32),
                "fma_g8": (1, 8, 64, torch.bfloat16),
                "staging": (2, 3, 20, torch.bfloat16)}


@pytest.mark.parametrize("where", ["in", "last", "past"])
@pytest.mark.parametrize("s", [32, 600])
@pytest.mark.parametrize("kernel", sorted(DA_NONFINITE))
def test_decode_attention_nonfinite_kv_matches_plain(card, kernel, s,
                                                     where):
    """+-inf and NaN in K and V inside the length: the kernel's NaN and inf
    where the plain version's are (a +inf or NaN score takes base 0, m =
    0), the rest by the DA rules. Past the length the kernels read no row
    (the plain version multiplies p = 0 into it, ROADMAP.md queue 3): the
    kernel equals the plain version over V with those rows zeroed. Two
    launches bitwise equal."""
    hkv, g, d, dtype = DA_NONFINITE[kernel]
    q, k, v, lens = _da_inputs(card, (2, 6, s, hkv, g, d), dtype, seed=s)
    lens[lens == 0] = s // 2
    lens[lens == s] = s - 3                   # rows past every length
    hit = _poison(k, v, lens, where)
    assert len(hit) >= 2
    seen = v.clone()
    if where == "past":
        pos = torch.arange(s, device=card)
        seen[pos[None, None, :] >= lens[..., None]] = 0
    scale = d ** -0.5
    o, m, l = tda.decode_attention(q, k, v, lens, scale)
    eo, em, el = tda.decode_attention_plain(q, k, seen, lens, scale)
    torch.cuda.synchronize()
    for got, exp, what in ((o, eo, "o"), (l, el, "l"), (m, em, "m")):
        _same_places(got, exp, what)
    o_abs = tda.decode_attention_plain(q, k, seen.abs(), lens, scale)[0]
    fin = torch.isfinite(eo) & torch.isfinite(o_abs)
    _assert_sums_close(o[fin], eo[fin], o_abs[fin])
    fin = torch.isfinite(el)
    torch.testing.assert_close(l[fin], el[fin], **DA_TOL)
    torch.testing.assert_close(m, em, **DA_TOL)
    o2, m2, l2 = tda.decode_attention(q, k, v, lens, scale)
    for a, b_ in ((o, o2), (m, m2), (l, l2)):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    if where != "past":
        assert bool((m == 0).any()) and bool(torch.isnan(o).any())
    else:   # the plain version over the poisoned V: NaN the kernel has not
        po = tda.decode_attention_plain(q, k, v, lens, scale)[0]
        assert bool(torch.isnan(po).any()) and bool(torch.isfinite(o).all())


def test_decode_attention_tensor_core_tiny_parts_match_plain(card):
    """The tensor-core kernel splits an f32 q element and a p into three
    bf16 parts. A nonzero one of at most 2^-134, which bf16 rounds to 0,
    keeps a nonzero part 0 of its sign, so against an infinite K or V
    element the kernel gives the plain version's infinity, not NaN: p =
    exp(-95) ~ 5.5e-42 and exp(-90) ~ 8.2e-40 (a bf16 subnormal) against
    +inf and -inf in V, then q = 1e-41 against +inf in K."""
    d = 128
    q = torch.zeros((1, 1, 4, d), device=card)
    q[..., 0] = 1.0
    q[..., 1] = 1e-41                        # under 2^-134 ~ 4.6e-41
    k = torch.zeros((1, 1, 3, 1, d), device=card, dtype=torch.bfloat16)
    v = torch.ones((1, 1, 3, 1, d), device=card, dtype=torch.bfloat16)
    k[0, 0, 1, 0, 0] = -95.0
    k[0, 0, 2, 0, 0] = -90.0
    v[0, 0, 1, 0, 0] = float("inf")
    v[0, 0, 2, 0, 1] = -float("inf")
    lens = torch.tensor([[3]], dtype=torch.int32, device=card)
    for case in ("p", "q"):
        if case == "q":
            k[0, 0, 1:, 0, 0] = 0.0
            k[0, 0, 2, 0, 1] = float("inf")
            v[0, 0, 1:] = 1.0
        got = tda.decode_attention(q, k, v, lens, 1.0)
        exp = tda.decode_attention_plain(q, k, v, lens, 1.0)
        assert bool(torch.isinf(exp[0 if case == "p" else 2]).any()), case
        for g, e, what in zip(got, exp, "oml"):
            _same_places(g, e, f"{case}: {what}")
            fin = torch.isfinite(e)
            torch.testing.assert_close(g[fin], e[fin], **DA_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DA_SHAPES)
def test_decode_attention_kernel_matches_plain(card, shape, dtype):
    q, k, v, lens = _da_inputs(card, shape, dtype)
    _check_decode_attention(q, k, v, lens, shape[5] ** -0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_stage_and_split_boundaries(card, dtype):
    """Lengths one below, at and one past a stage of the streaming kernel
    and a split of the grid, and S - 1, S and 0."""
    p, b, s, hkv, g, d = 1, 9, 256, 2, 4, 128
    bf16 = int(dtype == torch.bfloat16)
    lib = _build.lib("decode_attention.cu")
    rows = lib.da_stage_rows(d, g, bf16)
    splits, chunk = tda._split_plan(p * b, hkv, g, s, d, bf16,
                                    tda._slots(card, d, g, bf16), lib)
    assert splits > 1 and chunk % rows == 0 and chunk + 1 < s - 1
    q, k, v, _ = _da_inputs(card, (p, b, s, hkv, g, d), dtype, seed=1)
    lens = torch.tensor([[rows - 1, rows, rows + 1, chunk - 1, chunk,
                          chunk + 1, s - 1, s, 0]], dtype=torch.int32,
                        device=card)
    _check_decode_attention(q, k, v, lens, d ** -0.5)


@pytest.mark.parametrize("s", [1, 5])
def test_decode_attention_shorter_than_a_stage(card, s):
    """A single row, and S below one stage's rows."""
    q, k, v, lens = _da_inputs(card, (2, 4, s, 2, 4, 128), torch.bfloat16,
                               seed=2)
    assert s < _build.lib("decode_attention.cu").da_stage_rows(128, 4, 1)
    _check_decode_attention(q, k, v, lens, 128 ** -0.5)


def test_decode_attention_reads_an_expanded_bf16_query(card):
    """The far path's query: bf16, replicated over the shards with stride
    0, read in place (no copy) and equal to the same query made whole."""
    p, b, s, hkv, g, d = 4, 3, 200, 2, 4, 128
    _, k, v, lens = _da_inputs(card, (p, b, s, hkv, g, d), torch.bfloat16,
                               seed=3)
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    q0 = torch.randn((b, hkv * g, d), generator=gen,
                     device=card).to(torch.bfloat16)
    q = q0.expand(p, *q0.shape)
    assert q.stride(0) == 0
    _check_decode_attention(q, k, v, lens, d ** -0.5)
    whole = tda.decode_attention(q.contiguous(), k, v, lens, d ** -0.5)
    for a, b_ in zip(tda.decode_attention(q, k, v, lens, d ** -0.5), whole):
        assert torch.equal(a, b_)


def test_decode_attention_refuses_what_it_does_not_take(card):
    q, k, v, lens = _da_inputs(card, (1, 2, 16, 2, 2, 32), torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tda.decode_attention(q, k.half(), v.half(), lens, 1.0)
    with pytest.raises(ValueError, match="1..256"):
        big = torch.zeros((1, 2, 4, 264), device=card)
        kv = torch.zeros((1, 2, 16, 2, 264), device=card)
        tda.decode_attention(big, kv, kv, lens, 1.0)
    with pytest.raises(ValueError, match="one device"):
        tda.decode_attention(q, k, v, lens.cpu(), 1.0)


def _far_block(card, dtype, mode, tp=4, nq=8, nkv=2, dh=16, dm=32, b=3,
               s=64, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    ws = [(rng.normal(size=sh) / np.sqrt(sh[0])).astype(f) for sh in (
        (dm, nq * dh), (dm, nkv * dh), (dm, nkv * dh), (nq * dh, dm))]
    k = rng.normal(size=(b, s, nkv, dh)).astype(f)
    v = rng.normal(size=(b, s, nkv, dh)).astype(f)
    kw = dict(tp=tp, n_q_heads=nq, n_kv_heads=nkv, head_dim=dh)
    w = tfk.block_weights_from_numpy(*ws, dtype=dtype, device=card, **kw)
    kc, vc = tfk.shard_cache(torch.from_numpy(k).to(dtype),
                             torch.from_numpy(v).to(dtype), tp=tp, mode=mode,
                             device=card)
    x = torch.from_numpy(rng.normal(size=(4, b, dm)).astype(f)).to(card,
                                                                  dtype)
    lens = torch.tensor([1, 17, 40], dtype=torch.int32, device=card)
    return w, kc, vc, x, lens, dict(n_q_heads=nq, n_kv_heads=nkv,
                                    head_dim=dh)


@pytest.mark.parametrize("mode", ["far", "naive", "local"])
def test_decode_step_never_waits_for_the_card(card, mode):
    w, kc, vc, x, lens, kw = _far_block(card, torch.bfloat16, mode)
    before = tda.decode_attention.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tfk.attend_block(x[i], w, kc, vc, lens + i, lens, mode=mode,
                                 **kw)[0] for i in range(4)]
        # the mode is live: a step that read a value back would raise
        with pytest.raises(RuntimeError):
            outs[-1].sum().item()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tda.decode_attention.launches == before + 4
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_decode_steps_on_the_card_match_the_cpu(card):
    """Every mode on the card, f32, against the port on the CPU (the
    plain version) step by step, and the modes against each other."""
    got = {}
    for mode in ("far", "naive", "local"):
        for dev in (card, torch.device("cpu")):
            w, kc, vc, x, lens, kw = _far_block(dev, torch.float32, mode)
            got[mode, dev.type] = [
                tfk.attend_block(x[i], w, kc, vc, lens + i, lens, mode=mode,
                                 **kw)[0].cpu() for i in range(4)]
    for (mode, _), outs in got.items():
        for a, b in zip(outs, got["far", "cpu"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ tier_gather
TG_PAGE = 4096
TG_PW = TG_PAGE // 4


def _tg_random(seed, b, p, c, n_frames=6):
    """A random word buffer and random descriptors: every mode, widths
    0..33, bit offsets straddling words and running off both ends of the
    frame, dictionary offsets outside it, bases across the u32 range."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 2**32, (n_frames, TG_PW), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    desc = (rng.integers(0, n_frames, (b, p)).astype(np.int32),
            rng.integers(0, 3, (b, p, c)).astype(np.int32),
            rng.integers(0, 34, (b, p, c)).astype(np.int32),
            rng.integers(0, 2**32, (b, p, c), dtype=np.uint64).astype(
                np.uint32),
            rng.integers(-8, TG_PW + 8, (b, p, c)).astype(np.int32),
            rng.integers(-64, TG_PW * 32 + 64, (b, p, c)).astype(np.int32))
    return buf, desc


def _tg_both(card, buf, desc, n, c, cols):
    tbuf = torch.from_numpy(np.ascontiguousarray(buf).view(np.int32).copy()
                            ).to(card).view(torch.float32)
    tier = ttier.tier_tensors(desc, card)
    before = ttier.tier_gather.launches
    got = ttier.tier_gather(tbuf, tier, n, c, cols, TG_PW)
    exp = ttier.tier_gather_plain(tbuf, tier, n, c, cols, TG_PW)
    torch.cuda.synchronize()
    assert ttier.tier_gather.launches == before + 1
    return got, exp


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("c", [3, 5, 7, 8])
def test_tier_gather_kernel_matches_plain_on_random_descriptors(card, c, b):
    buf, desc = _tg_random(10 * c + b, b, 3, c)
    n = 3 * TG_PW // c
    for cols in (None, [c - 1, 0, c - 1], [c // 2]):
        got, exp = _tg_both(card, buf, desc, n, c, cols)
        assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


def _tg_words(rng, n, c):
    """Words whose column planes need every packed width 1..32 (column j
    spans [0, 2^(j % 32 + 1))), some dictionary-friendly columns, and NaN
    payloads, inf, -0.0 and subnormals scattered in every third column."""
    u = np.zeros((n, c), np.uint64)
    for j in range(c):
        w = j % 32 + 1
        if j % 5 == 4:
            u[:, j] = rng.integers(0, 2**32, 7, dtype=np.uint64)[
                rng.integers(0, 7, n)]
        else:
            u[:, j] = rng.integers(0, 2**w, n, dtype=np.uint64)
            u[0, j] = 2**w - 1
    u = u.astype(np.uint32)
    specials = u[:, ::3]                # every third column: a dict plane
    flat = specials.reshape(-1)
    for v in (0x7FC0BEEF, 0xFFC00001, 0x7F800000, 0x80000000, 0x00000005,
              0x807FFFFF):
        flat[rng.integers(0, flat.size, max(1, flat.size // 200))] = v
    u[:, ::3] = flat.reshape(specials.shape)
    return u.view(np.float32)


@pytest.mark.parametrize("c", [3, 5, 7, 8, 32])
def test_tier_gather_kernel_matches_plain_on_pool_frames(card, c):
    """A table demoted in place on the card (every other page cold):
    the kernel equals the plain version and the written words, rows and
    columns, alone and in a stack with null-descriptor padding."""
    rng = np.random.default_rng(c)
    n = 2500 if c < 32 else 700
    words = _tg_words(rng, n, c)
    pool = TFarPool(8 * 2**20, page_bytes=TG_PAGE, device=card)
    ft = pool.alloc_table(fv.FTable(
        "t", tuple(fv.Column(f"c{i}") for i in range(c)), n_rows=n))
    pool.write_table(ft, words)
    p_n = len(ft.pages)
    assert pool.demote_table(ft, page_idx=range(0, p_n, 2)) > 0
    te = pool._tier[ft.table_id]
    assert te.cold.any() and not te.cold.all()
    widths = set(te.width[te.cold].reshape(-1).tolist())
    modes = set(te.mode[te.cold].reshape(-1).tolist())
    assert {1, 2} <= modes and (c < 32 or len(widths) >= 20)
    pad = p_n + 2
    # the dispatch's own descriptors (on the card), back on the host
    desc = tuple(a.view(np.uint32) if name == "base" else a
                 for name, a in zip(ttier.TIER_FIELDS, (
                     t[0].cpu().numpy()
                     for t in pool.tier_desc_stacked([ft], pad))))
    stack = tuple(np.stack([a, b]) for a, b in zip(
        ttier.null_descriptor(pad, c, pool.null_page), desc))
    buf = pool.buf.cpu().numpy()
    rows = pad * TG_PW // c
    for d in (desc, stack):
        for cols in (None, [c - 1, 0]):
            got, exp = _tg_both(card, buf, d, rows, c, cols)
            assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    got, _ = _tg_both(card, buf, desc, n, c, None)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  words.view(np.uint32))
    stacked, _ = _tg_both(card, buf, stack, n, c, None)
    assert torch.equal(stacked[1].view(torch.int32), got.view(torch.int32))
    assert not stacked[0].view(torch.int32).any()


def test_tier_gather_refuses_what_it_does_not_take(card):
    buf, desc = _tg_random(1, 1, 2, 4)
    tier = ttier.tier_tensors(desc, card)
    tbuf = torch.from_numpy(buf.view(np.int32).copy()).to(card).view(
        torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ttier.tier_gather(tbuf.cpu(), ttier.tier_tensors(desc, "cpu"), 4, 4,
                          None, TG_PW)
    with pytest.raises(ValueError, match="device"):
        ttier.tier_gather(tbuf, ttier.tier_tensors(desc, "cpu"), 4, 4, None,
                          TG_PW)
    with pytest.raises(ValueError, match="overrun"):
        ttier.tier_gather(tbuf, tier, 2 * TG_PW, 4, None, TG_PW)
    with pytest.raises(ValueError, match="outside"):
        ttier.tier_gather(tbuf, tier, 4, 4, [4], TG_PW)


def test_tiered_round_never_waits_and_matches_the_cpu(card):
    """Cold and mixed-tier tables on the card, a stacked round of each
    verb flushed under sync debug mode "error", against the same round on
    a CPU node: rows, counts and bytes bitwise."""
    rng = np.random.default_rng(7)
    n = 3000
    cols = tuple(fv.Column(f"c{i}", "i32" if i == 0 else "f32")
                 for i in range(8))
    words = np.concatenate([rng.integers(0, 64, (n, 1)),
                            rng.integers(0, 128, (n, 7))], 1).astype(
                                np.float32)
    pipes = {
        "sel": (op.Select((op.Predicate("c1", "<", 64.0),
                           op.Predicate("c2", ">", 16.0))),),
        "proj": (op.Project(("c0", "c3", "c5")),),
        "smart": (op.SmartAddress(("c2", "c6", "c7")),),
        "grp": (op.GroupBy("c0", ("c1", "c2"), n_buckets=64),),
        "post": (op.Select((op.Predicate("c1", "<", 64.0),)),
                 op.Crypt((5, 6), 7, "post")),
    }
    out = {}
    for dev in (card, "cpu"):
        node = fv.FViewNode(16 * 2**20, page_bytes=TG_PAGE, n_regions=4,
                            promote_after=10**9, device=dev)
        qps = [fv.open_connection(node) for _ in range(4)]
        fts = []
        for i, qp in enumerate(qps):
            ft = fv.alloc_table_mem(qp, fv.FTable(f"t{i}", cols,
                                                  n_rows=n - 300 * i))
            fv.table_write(qp, ft, words[: n - 300 * i])
            node.pool.demote_table(ft, page_idx=None if i % 2 == 0
                                   else range(0, len(ft.pages), 2))
            fts.append(ft)
        before = ttier.tier_gather.launches
        if dev is card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            reqs = {k: [fv.submit_request(qp, ft, p)
                        for qp, ft in zip(qps, fts)]
                    for k, p in pipes.items()}
            node.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if dev is card:
            assert ttier.tier_gather.launches == before + len(pipes)
        out[dev if dev == "cpu" else "cuda"] = {
            k: [r.wait() for r in rs] for k, rs in reqs.items()}
    for k in pipes:
        for r, c in zip(out["cuda"][k], out["cpu"][k]):
            assert r.read_bytes == c.read_bytes
            assert r.shipped_bytes == c.shipped_bytes
            if r.kind == "groups":
                for f in ("bucket_keys", "count", "sum", "min", "max"):
                    assert torch.equal(r.groups[f].cpu(), c.groups[f])
                continue
            assert r.count == c.count
            assert torch.equal(r.rows.cpu().view(torch.int32),
                               c.rows.view(torch.int32))
