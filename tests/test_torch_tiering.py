"""Memory tiering in the port against the JAX package, on the CPU.

The contract: demoting pages to the compressed cold tier is invisible to
every verb except in the byte accounting. Each case runs the same writes,
demotes and requests through the JAX package and through the port (its
plain versions, on the CPU) and holds them together — rows and counts
bitwise, shipped and read bytes exactly:

- decode: the port's `gather_rows_tiered` / `gather_columns_tiered`
  against JAX `kernels/tier.py` on the same buffer and descriptors: a
  pool's real cold frames at 3, 5, 7 and 8 columns (pages start mid-row),
  NaN payloads and subnormals, null-descriptor padding, stacked requests;
  and random descriptors (widths 0..33, straddling and out-of-range bit
  and dictionary offsets) for the reference's clamps and wraps;
- the pool: buffer, tier bits, descriptors, physical read bytes and the
  capacity summary bitwise the JAX pool's after the same demotes and
  promotes;
- the verbs of the reference's `test_tiering.py` (solo, string,
  mechanics and scheduler classes) against the JAX node;
- `load_node_state` of a JAX pool image that holds cold tables.
"""
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jfv
from repro.core import operators as jop
from repro.core.pool import FarPool as JFarPool
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.core.table import string_table as jstring_table
from repro.kernels import ref as jref
from repro.kernels import tier as jtier
import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.pool import FarPool
from repro_torch.kernels import tier

# the JAX package's verbs with its table classes, shaped like `repro_torch`
jx = SimpleNamespace(**{k: getattr(jfv, k) for k in dir(jfv)
                        if not k.startswith("_")})
jx.Column, jx.FTable = JColumn, JFTable

PAGE = 4096                      # small pool pages: 5-page tables at N=600
PW = PAGE // 4
N = 600
KEY, NONCE = (11, 22), 7
MIXED = [0, 2, 4]                # pages demoted in the mixed-tier layout
CAP = 2 * 2**20


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _cols(mod, n=8):
    return tuple(mod.Column(f"c{i}", "i32" if i == 0 else "f32")
                 for i in range(n))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    d = {"c0": rng.integers(0, 13, N).astype(np.int32)}
    for i in range(1, 8):
        # integer-valued floats: sums are order-insensitive, so bitwise is
        # meaningful for aggregates too
        d[f"c{i}"] = rng.integers(-50, 50, N).astype(np.float32)
    return d


def _words(data):
    return JFTable("t", _cols(jx), n_rows=N).encode(data)


def _pair(capacity=CAP, **kw):
    """A JAX node and a port node (CPU) of the same shape."""
    return (jfv.FViewNode(capacity, page_bytes=PAGE, **kw),
            fv.FViewNode(capacity, page_bytes=PAGE, device="cpu", **kw))


def _load(node, words, name="t", ncols=8):
    """Open a connection, allocate and write a table through the node's
    own package's verbs."""
    mod = jx if isinstance(node, jfv.FViewNode) else fv
    qp = mod.open_connection(node)
    ft = mod.alloc_table_mem(qp, mod.FTable(name, _cols(mod, ncols),
                                            n_rows=words.shape[0]))
    mod.table_write(qp, ft, words)
    return qp, ft


def _same_rows(r, j):
    assert r.count == j.count
    np.testing.assert_array_equal(_bits(r.rows.numpy()), _bits(j.rows))
    assert r.shipped_bytes == j.shipped_bytes
    assert r.read_bytes == j.read_bytes


def _same_groups(g, jg):
    for f in ("bucket_keys", "count", "sum", "min", "max"):
        np.testing.assert_array_equal(_bits(np.asarray(g[f], np.float32))
                                      if f in ("sum", "min", "max")
                                      else np.asarray(g[f]),
                                      _bits(np.asarray(jg[f], np.float32))
                                      if f in ("sum", "min", "max")
                                      else np.asarray(jg[f]))
    np.testing.assert_array_equal(g["ovf_keys"], np.asarray(jg["ovf_keys"]))
    np.testing.assert_array_equal(_bits(g["ovf_vals"]),
                                  _bits(jg["ovf_vals"]))


def _same_merged(m, jm):
    assert m.keys() == jm.keys()
    for k in jm:
        for a, b in zip(m[k], jm[k]):
            np.testing.assert_array_equal(np.asarray(a, np.float64),
                                          np.asarray(b, np.float64))


VERBS = {
    "selection": lambda o: (o.Select((o.Predicate("c1", "<", 0.0),
                                      o.Predicate("c2", ">", -20.0))),),
    "projection": lambda o: (o.Project(("c2", "c5")),),
    "smart": lambda o: (o.SmartAddress(("c3",)),),
    "crypt_post": lambda o: (o.Select((o.Predicate("c2", ">", 0.0),)),
                             o.Crypt(key=KEY, nonce=NONCE, when="post")),
}
GROUPED = {
    "group": lambda o: (o.GroupBy("c0", ("c1", "c2"), n_buckets=128),),
    "distinct": lambda o: (o.Distinct(("c0",), n_buckets=128),),
}


# ------------------------------------------------------------------ decode
def _special_words(rng, shape):
    """Integer-valued words with NaN payloads, inf, -0.0 and subnormals."""
    w = rng.integers(0, 40, shape).astype(np.float32)
    u = w.view(np.uint32).reshape(-1)
    for v in (0x7FC0BEEF, 0xFFC00001, 0x7F800000, 0x80000000, 0x00000005,
              0x807FFFFF):
        u[rng.integers(0, u.size, max(1, u.size // 40))] = v
    return w


@pytest.mark.parametrize("ncols", [3, 5, 7, 8])
def test_decode_matches_jax_on_pool_frames(ncols):
    """A table demoted in place (mixed tiers) decodes bitwise as the
    reference decodes it, alone, stacked, padded and column-granular."""
    rng = np.random.default_rng(ncols)
    n = 1100
    words = _special_words(rng, (n, ncols))
    jpool = JFarPool(CAP, page_bytes=PAGE)
    jft = jpool.alloc_table(JFTable("t", _cols(jx, ncols), n_rows=n))
    jpool.write_table(jft, words)
    P = len(jft.pages)
    assert jpool.demote_table(jft, page_idx=range(1, P, 2)) > 0
    assert jpool.tier_bits(jft).any() and not jpool.tier_bits(jft).all()
    buf = np.asarray(jpool.buf)
    tbuf = torch.from_numpy(buf.view(np.int32).copy()).view(torch.float32)
    desc = jpool.tier_desc_padded(jft, P + 2)       # two null-padding pages
    jdesc = tuple(jnp.asarray(a) for a in desc)
    tdesc = tier.tier_tensors(desc, "cpu")
    rows_n = (P + 2) * PW // ncols                  # reads the padding too
    jrows = jtier.gather_rows_tiered(jnp.asarray(buf), jdesc, rows_n, ncols,
                                     PW)
    got = tier.gather_rows_tiered(tbuf, tdesc, rows_n, ncols, PW)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jrows))
    np.testing.assert_array_equal(_bits(got.numpy()[:n]), _bits(words))
    assert not _bits(got.numpy()).reshape(-1)[(P * PW):].any()
    cols = (ncols - 1, 0) if ncols > 1 else (0,)
    jc = jtier.gather_columns_tiered(jnp.asarray(buf), jdesc, n, ncols,
                                     cols, PW)
    gc = tier.gather_columns_tiered(tbuf, tdesc, n, ncols, cols, PW)
    np.testing.assert_array_equal(_bits(gc.numpy()), _bits(jc))
    # a stack of two requests: this table and an all-null one
    null = tier.null_descriptor(P + 2, ncols, jpool.null_page)
    stack = tier.tier_tensors(tuple(np.stack([a, b]) for a, b in
                                    zip(desc, null)), "cpu")
    st = tier.gather_rows_tiered(tbuf, stack, rows_n, ncols, PW)
    np.testing.assert_array_equal(_bits(st[0].numpy()), _bits(jrows))
    assert not _bits(st[1].numpy()).any()


def _random_desc(rng, b, p, c, n_frames):
    """Random descriptors over a random buffer: every mode, widths 0..33,
    bit offsets straddling words and running off both ends of the frame,
    dictionary offsets outside it, bases across the u32 range."""
    phys = rng.integers(0, n_frames, (b, p)).astype(np.int32)
    mode = rng.integers(0, 3, (b, p, c)).astype(np.int32)
    width = rng.integers(0, 34, (b, p, c)).astype(np.int32)
    base = rng.integers(0, 2**32, (b, p, c), dtype=np.uint64).astype(
        np.uint32)
    dictoff = rng.integers(-8, PW + 8, (b, p, c)).astype(np.int32)
    bitoff = rng.integers(-64, PW * 32 + 64, (b, p, c)).astype(np.int32)
    return phys, mode, width, base, dictoff, bitoff


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ncols", [3, 5, 7, 8])
def test_decode_matches_jax_on_random_descriptors(ncols, seed):
    rng = np.random.default_rng(100 * ncols + seed)
    n_frames, p, b = 6, 3, 2
    buf = rng.integers(0, 2**32, (n_frames, PW), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    desc = _random_desc(rng, b, p, ncols, n_frames)
    n = p * PW // ncols
    tbuf = torch.from_numpy(buf.view(np.int32).copy()).view(torch.float32)
    got = tier.gather_rows_tiered(tbuf, tier.tier_tensors(desc, "cpu"), n,
                                  ncols, PW)
    cols = tuple(range(ncols))[::-2]
    gc = tier.gather_columns_tiered(tbuf, tier.tier_tensors(desc, "cpu"), n,
                                    ncols, cols, PW)
    for i in range(b):
        one = tuple(jnp.asarray(a[i]) for a in desc)
        exp = jtier.gather_rows_tiered(jnp.asarray(buf), one, n, ncols, PW)
        np.testing.assert_array_equal(_bits(got[i].numpy()), _bits(exp))
        exp = jtier.gather_columns_tiered(jnp.asarray(buf), one, n, ncols,
                                          cols, PW)
        np.testing.assert_array_equal(_bits(gc[i].numpy()), _bits(exp))


# -------------------------------------------------------------------- pool
def _same_pool(pool, jpool, fts, jfts):
    np.testing.assert_array_equal(_bits(pool.buf.numpy()), _bits(jpool.buf))
    assert pool.free_pages == jpool.free_pages
    assert pool.tier_summary() == jpool.tier_summary()
    for ft, jft in zip(fts, jfts):
        assert ft.pages == jft.pages
        assert pool.is_tiered(ft) == jpool.is_tiered(jft)
        np.testing.assert_array_equal(pool.tier_bits(ft),
                                      jpool.tier_bits(jft))
        for cols in (None, [1], [0, 2, 5], [7, 7]):
            assert (pool.tier_read_bytes(ft, cols)
                    == jpool.tier_read_bytes(jft, cols))
        if jpool.is_tiered(jft):
            for a, b in zip(pool.tier_desc(ft),
                            tier.tier_tensors(jpool.tier_desc_padded(
                                jft, len(ft.pages)), "cpu")):
                assert torch.equal(a, b)
    # the round's stack, as the dispatch builds it: one row a table, each
    # the reference's padded descriptors (two null-padding pages at least)
    cold = [(ft, jft) for ft, jft in zip(fts, jfts) if jpool.is_tiered(jft)]
    if cold:
        n = max(len(ft.pages) for ft, _ in cold) + 2
        stack = pool.tier_desc_stacked([ft for ft, _ in cold], n)
        for i, (_, jft) in enumerate(cold):
            for a, b in zip(stack, tier.tier_tensors(
                    jpool.tier_desc_padded(jft, n), "cpu")):
                assert a.dtype == b.dtype == torch.int32
                assert torch.equal(a[i], b)


def test_pool_demote_promote_matches_jax(data):
    pool = FarPool(CAP, page_bytes=PAGE, n_shards=2, device="cpu")
    jpool = JFarPool(CAP, page_bytes=PAGE, n_shards=2)
    words = _words(data)
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    fts, jfts = [], []
    for name, w in (("a", words), ("b", noise), ("c", words[:333])):
        fts.append(pool.alloc_table(fv.FTable(name, _cols(fv), w.shape[0])))
        jfts.append(jpool.alloc_table(JFTable(name, _cols(jx), w.shape[0])))
        pool.write_table(fts[-1], w)
        jpool.write_table(jfts[-1], w)
    steps = [("demote", 0, MIXED), ("demote", 1, None), ("demote", 2, None),
             ("demote", 0, None), ("promote", 0, [1, 2]),
             ("promote", 2, None), ("demote", 2, [0])]
    for what, t, idx in steps:
        got = getattr(pool, f"{what}_table")(fts[t], idx)
        exp = getattr(jpool, f"{what}_table")(jfts[t], idx)
        assert got == exp
        _same_pool(pool, jpool, fts, jfts)
    np.testing.assert_array_equal(_bits(pool.read_table(fts[0]).numpy()),
                                  _bits(words))
    np.testing.assert_array_equal(_bits(jpool.read_table(jfts[0])),
                                  _bits(words))
    np.testing.assert_array_equal(
        _bits(pool.read_columns(fts[0], [6, 1]).numpy()),
        _bits(jpool.read_columns(jfts[0], [6, 1])))
    assert vars(pool.stats) == vars(jpool.stats)
    pool.free_table(fts[0])
    jpool.free_table(jfts[0])
    assert pool.free_pages == jpool.free_pages
    assert pool.tier_summary() == jpool.tier_summary()


# ------------------------------------------------- solo verbs vs JAX node
@pytest.mark.parametrize("verb", sorted(VERBS))
@pytest.mark.parametrize("tier_kind", ["cold", "mixed"])
def test_rows_verbs_match_jax(data, verb, tier_kind):
    words = _words(data)
    jnode, node = _pair(promote_after=99)
    jqp, jft = _load(jnode, words)
    qp, ft = _load(node, words)
    hot = fv.farview_request(qp, ft, VERBS[verb](op)).finalize()
    _same_rows(hot, jfv.farview_request(jqp, jft, VERBS[verb](jop)))
    idx = MIXED if tier_kind == "mixed" else None
    n = node.pool.demote_table(ft, page_idx=idx)
    assert n == jnode.pool.demote_table(jft, page_idx=idx)
    assert n == (len(MIXED) if tier_kind == "mixed" else len(ft.pages))
    res = fv.farview_request(qp, ft, VERBS[verb](op)).finalize()
    _same_rows(res, jfv.farview_request(jqp, jft, VERBS[verb](jop)))
    assert res.count == hot.count and res.shipped_bytes == hot.shipped_bytes
    np.testing.assert_array_equal(_bits(res.rows.numpy()),
                                  _bits(hot.rows.numpy()))
    assert res.read_bytes < hot.read_bytes
    assert node.pool.is_tiered(ft)
    assert qp.bytes_read_pool == jqp.bytes_read_pool
    assert qp.bytes_shipped == jqp.bytes_shipped


@pytest.mark.parametrize("verb", sorted(GROUPED))
@pytest.mark.parametrize("tier_kind", ["cold", "mixed"])
def test_grouped_verbs_match_jax(data, verb, tier_kind):
    words = _words(data)
    jnode, node = _pair(promote_after=99)
    jqp, jft = _load(jnode, words)
    qp, ft = _load(node, words)
    idx = MIXED if tier_kind == "mixed" else None
    node.pool.demote_table(ft, page_idx=idx)
    jnode.pool.demote_table(jft, page_idx=idx)
    res = fv.farview_request(qp, ft, GROUPED[verb](op)).finalize()
    jres = jfv.farview_request(jqp, jft, GROUPED[verb](jop)).finalize()
    assert res.read_bytes == jres.read_bytes
    assert res.shipped_bytes == jres.shipped_bytes
    _same_groups(res.groups, jres.groups)
    merge = GROUPED[verb] if verb == "group" else (lambda o: ())
    _same_merged(fv.merge_group_partials(ft, merge(op), [res]).groups,
                 jfv.merge_group_partials(jft, merge(jop), [jres]).groups)


@pytest.mark.parametrize("tier_kind", ["cold", "mixed"])
def test_join_cold_probe_and_build_match_jax(data, tier_kind):
    """JoinSmall reads its build table through the pool's tiered read, so
    both sides of the join can be cold."""
    rng = np.random.default_rng(3)
    bd = {"k": rng.permutation(64)[:40].astype(np.int32),
          "v": rng.integers(0, 99, 40).astype(np.float32)}
    jdata = dict(data)
    jdata["c0"] = rng.integers(0, 64, N).astype(np.int32)
    words = _words(jdata)
    jnode, node = _pair(promote_after=99)
    out = []
    for mod, ops, n in ((jx, jop, jnode), (fv, op, node)):
        qp = mod.open_connection(n)
        b = mod.alloc_table_mem(qp, mod.FTable(
            "cust", (mod.Column("k", "i32"), mod.Column("v")), n_rows=40))
        mod.table_write(qp, b, b.encode(bd))
        qp, ft = _load(n, words)
        n.pool.demote_table(ft, page_idx=MIXED if tier_kind == "mixed"
                            else None)
        n.pool.demote_table(b)                  # build side cold too
        assert n.pool.is_tiered(b)
        pipe = (ops.JoinSmall(probe_key="c0", build_table="cust",
                              build_key="k", build_cols=("v",)),)
        out.append((mod.farview_request(qp, ft, pipe).finalize(), n))
    (jres, jn), (res, n) = out
    assert res.count > 0
    _same_rows(res, jres)
    assert vars(n.pool.stats) == vars(jn.pool.stats)


def test_crypt_pre_ciphertext_stays_raw_and_matches_jax(data):
    """Encrypted-at-rest pages are pseudo-random: the codec refuses them
    (raw tier bit) and the verb still decrypts bitwise as the JAX node."""
    flat = jnp.asarray(_words(data).reshape(-1))
    enc = np.asarray(jref.ctr_crypt(flat.view(jnp.uint32),
                                    jnp.asarray(KEY, jnp.uint32), NONCE)
                     ).view(np.float32).reshape(N, 8)
    jnode, node = _pair(promote_after=99)
    jqp, jft = _load(jnode, enc)
    qp, ft = _load(node, enc)
    before = node.pool.tier_stats["incompressible_pages"]
    got = node.pool.demote_table(ft)
    assert got == jnode.pool.demote_table(jft) and got <= 1
    assert node.pool.tier_stats == jnode.pool.tier_stats
    assert node.pool.tier_stats["incompressible_pages"] >= before + 4
    np.testing.assert_array_equal(node.pool.tier_bits(ft),
                                  jnode.pool.tier_bits(jft))
    assert not node.pool.tier_bits(ft)[:-1].any()
    pipe = lambda o: (o.Crypt(key=KEY, nonce=NONCE, when="pre"),  # noqa: E731
                      o.Select((o.Predicate("c1", "<", 0.0),)))
    res = fv.farview_request(qp, ft, pipe(op)).finalize()
    assert res.count > 0
    _same_rows(res, jfv.farview_request(jqp, jft, pipe(jop)))


def test_table_read_cold_matches_jax(data):
    words = _words(data)
    jnode, node = _pair(promote_after=99)
    jqp, jft = _load(jnode, words)
    qp, ft = _load(node, words)
    node.pool.demote_table(ft)
    jnode.pool.demote_table(jft)
    got = fv.table_read(qp, ft)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(words))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jfv.table_read(jqp, jft)))
    assert qp.bytes_shipped == jqp.bytes_shipped < ft.n_bytes
    assert qp.bytes_read_pool == jqp.bytes_read_pool


# ------------------------------------------------------------ string tier
def test_regex_after_demote_promotes_and_matches_jax():
    strs = [b"error: disk full", b"all fine", b"ERROR", b"warn: error",
            b"errr", b"late error"]
    rng = np.random.default_rng(5)
    picked = [strs[j] for j in rng.integers(0, len(strs), 300)]
    jnode, node = _pair()
    masks = []
    for mod, ops, n, mk in ((jx, jop, jnode, jstring_table),
                            (fv, op, node, fv.string_table)):
        ft, mat, lens = mk("logs", picked, 48)
        qp = mod.open_connection(n)
        mod.alloc_table_mem(qp, ft)
        assert n.pool.demote_table(ft) > 0          # extent-granular
        assert n.pool.is_tiered(ft)
        res = mod.farview_request(qp, ft, (ops.RegexMatch("error"),),
                                  strings=mat, lengths=lens).finalize()
        assert not n.pool.is_tiered(ft)             # promoted at first access
        masks.append(np.asarray(res.mask).tolist())
        assert n.pool.tier_stats["promoted_pages"] == len(ft.pages)
    assert masks[0] == masks[1] == [bool(re.search(b"error", s))
                                    for s in picked]
    assert node.pool.tier_summary() == jnode.pool.tier_summary()


def test_string_extent_read_while_cold_matches_jax():
    """A plain read of a cold string extent decodes the block stream and
    bills its encoded bytes."""
    strs = [b"abc" * k for k in range(1, 20)]
    jnode, node = _pair()
    out = []
    for mod, n, mk in ((jx, jnode, jstring_table),
                       (fv, node, fv.string_table)):
        ft, mat, _ = mk("s", strs * 20, 64)
        qp = mod.open_connection(n)
        mod.alloc_table_mem(qp, ft)
        mod.table_write(qp, ft, mat.view(np.float32))
        n.pool.demote_table(ft)
        out.append((n.pool.read_table(ft), n.pool.tier_read_bytes(ft)))
    np.testing.assert_array_equal(_bits(out[1][0].numpy()), _bits(out[0][0]))
    assert out[0][1] == out[1][1] < 380 * 64


# -------------------------------------------------------------- mechanics
def test_corrupt_cold_frame_raises_typed_error_as_jax(data):
    """A flipped bit in a cold frame is a typed failure on promote in
    both packages — never wrong bytes quietly restored."""
    words = _words(data)
    jnode, node = _pair(promote_after=99)
    for n in (jnode, node):
        _, ft = _load(n, words)
        assert n.pool.demote_table(ft) == len(ft.pages)
        te = n.pool._tier[ft.table_id]
        p = int(np.flatnonzero(te.cold)[0])
        frame, off = int(te.phys[p]), int(te.span[p][0])
        if n is node:
            n.pool.buf.view(torch.int32)[frame, off] ^= 1
            err = fv.PageCodecError
        else:
            w = n.pool.buf[frame, off:off + 1].view(jnp.uint32) ^ 1
            n.pool.buf = n.pool.buf.at[frame, off:off + 1].set(
                w.view(jnp.float32))
            err = jfv.PageCodecError
        with pytest.raises(err):
            n.pool.promote_table(ft)
    np.testing.assert_array_equal(_bits(node.pool.buf.numpy()),
                                  _bits(jnode.pool.buf))


def test_access_hysteresis_promotes_as_jax(data):
    words = _words(data)
    jnode, node = _pair()                   # promote_after=3 default
    jqp, jft = _load(jnode, words)
    qp, ft = _load(node, words)
    node.pool.demote_table(ft)
    jnode.pool.demote_table(jft)
    for i in range(3):
        res = fv.farview_request(qp, ft, VERBS["selection"](op)).finalize()
        jres = jfv.farview_request(jqp, jft, VERBS["selection"](jop))
        _same_rows(res, jres)
        assert node.pool.is_tiered(ft) == jnode.pool.is_tiered(jft) == (
            i < 2)                          # the third touch promotes
    assert node.pool.tier_stats == jnode.pool.tier_stats
    assert node.pool.tier_stats["promoted_pages"] == len(ft.pages)


def test_write_promotes_first_as_jax(data):
    words = _words(data)
    d2 = dict(data)
    d2["c1"] = data["c1"] + 1.0
    words2 = _words(d2)
    jnode, node = _pair(promote_after=99)
    (jqp, jft), (qp, ft) = _load(jnode, words), _load(node, words)
    node.pool.demote_table(ft)
    jnode.pool.demote_table(jft)
    fv.table_write(qp, ft, words2)
    jfv.table_write(jqp, jft, words2)
    assert not node.pool.is_tiered(ft) and not jnode.pool.is_tiered(jft)
    assert ft.pages == jft.pages
    got = fv.table_read(qp, ft)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(words2))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jfv.table_read(jqp, jft)))
    assert qp.bytes_read_pool == jqp.bytes_read_pool
    assert vars(node.pool.stats) == vars(jnode.pool.stats)


def test_effective_capacity_multiplier_matches_jax():
    """Dict-friendly analytics columns demote to >= 1.5 logical bytes per
    physical byte, as in the reference."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 13, (4000, 8)).astype(np.float32)
    jnode, node = _pair(promote_after=99)
    for n in (jnode, node):
        qp, ft = _load(n, words)
        free_before = n.pool.free_pages
        n.pool.demote_table(ft)
        assert n.pool.free_pages > free_before
    s = node.pool.tier_summary()
    assert s == jnode.pool.tier_summary()
    assert s["cold_pages"] == len(ft.pages)
    assert s["effective_capacity"] >= 1.5
    np.testing.assert_array_equal(fv.table_read(qp, ft).numpy(), words)


def test_demote_promote_roundtrip_exact_as_jax(data):
    words = _words(data)
    jnode, node = _pair(promote_after=99)
    (jqp, jft), (qp, ft) = _load(jnode, words), _load(node, words)
    for n, t in ((jnode, jft), (node, ft)):
        n.pool.demote_table(t)
        assert n.pool.promote_table(t) == len(t.pages)
        assert not n.pool.is_tiered(t)
    assert ft.pages == jft.pages
    assert node.pool.tier_summary() == jnode.pool.tier_summary()
    got = fv.table_read(qp, ft)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(words))
    np.testing.assert_array_equal(_bits(node.pool.buf.numpy()),
                                  _bits(jnode.pool.buf))


# -------------------------------------------------------------- scheduler
def test_cold_tables_coalesce_one_dispatch_as_jax(data):
    """Same-bucket cold tables ride ONE stacked tiered dispatch, each
    billing its own compressed bytes."""
    words = _words(data)
    jnode, node = _pair(8 * 2**20, n_regions=3, promote_after=99)
    out = []
    for mod, ops, n in ((jx, jop, jnode), (fv, op, node)):
        loads = [_load(n, words if i != 1 else words[:520], name=f"c{i}")
                 for i in range(3)]
        for _, ft in loads:
            n.pool.demote_table(ft)
        pends = [mod.submit_request(qp, ft, VERBS["selection"](ops))
                 for qp, ft in loads]
        before = n.dispatches
        n.flush()
        assert n.dispatches == before + 1
        res = [p.wait() for p in pends]
        for r, (_, ft) in zip(res, loads):
            assert r.read_bytes == n.pool.tier_read_bytes(ft) < ft.n_bytes
        out.append(res)
    for r, j in zip(out[1], out[0]):
        _same_rows(r, j)


def test_mixed_tier_round_splits_per_tier_as_jax(data):
    words = _words(data)
    jnode, node = _pair(8 * 2**20, n_regions=2, promote_after=99)
    out = []
    for mod, ops, n in ((jx, jop, jnode), (fv, op, node)):
        hot = _load(n, words, name="hot")
        cold = _load(n, words, name="cold")
        n.pool.demote_table(cold[1])
        pends = [mod.submit_request(qp, ft, VERBS["smart"](ops))
                 for qp, ft in (hot, cold)]
        before = n.dispatches
        n.flush()
        assert n.dispatches == before + 2
        out.append([p.wait() for p in pends])
    for r, j in zip(out[1], out[0]):
        _same_rows(r, j)
    assert out[1][0].rows.numpy().tobytes() == out[1][1].rows.numpy(
    ).tobytes()


# ------------------------------------------------------- carrying state
def _catalog(jnode):
    cat = []
    for t in jnode.tables.values():
        ent = {"name": t.name, "columns": [c.name for c in t.columns],
               "dtypes": [c.dtype for c in t.columns], "n_rows": t.n_rows,
               "str_width": t.str_width, "pages": list(t.pages),
               "table_id": t.table_id}
        te = jnode.pool._tier.get(t.table_id)
        if te is not None:
            ent["tier"] = {k: v for k, v in vars(te).items() if k != "hits"}
        cat.append(ent)
    return cat


def test_load_node_state_adopts_cold_tables(data):
    """A JAX pool image holding a cold, a mixed-tier and a cold string
    table, adopted with its cold frames and descriptors: both nodes
    compute the same thing from it."""
    words = _words(data)
    jnode = jfv.FViewNode(CAP, page_bytes=PAGE, promote_after=99)
    _, cold = _load(jnode, words, name="cold")
    _, mixed = _load(jnode, words, name="mixed")
    _, flat = _load(jnode, words, name="flat")
    jnode.pool.demote_table(cold)
    jnode.pool.demote_table(mixed, page_idx=MIXED)
    sft, mat, lens = jstring_table("logs", [b"an error", b"fine"] * 200, 32)
    jqp = jfv.open_connection(jnode)
    jfv.alloc_table_mem(jqp, sft)
    jfv.table_write(jqp, sft, mat.view(np.float32))
    assert jnode.pool.demote_table(sft) > 0
    jfv.close_connection(jqp)

    node = fv.FViewNode(CAP, page_bytes=PAGE, promote_after=99,
                        device="cpu")
    tables = fv.load_node_state(node, np.asarray(jnode.pool.buf),
                                _catalog(jnode))
    assert node.pool.free_pages == jnode.pool.free_pages
    assert node.pool.tier_summary()["cold_pages"] == (
        jnode.pool.tier_summary()["cold_pages"])
    for name in ("cold", "mixed", "flat", "logs"):
        np.testing.assert_array_equal(
            node.pool.tier_bits(tables[name]),
            jnode.pool.tier_bits(jnode.tables[name]))
    qp, jqp = fv.open_connection(node), jfv.open_connection(jnode)
    for name in ("cold", "mixed", "flat"):
        for verb in ("selection", "smart"):
            _same_rows(fv.farview_request(qp, tables[name],
                                          VERBS[verb](op)).finalize(),
                       jfv.farview_request(jqp, jnode.tables[name],
                                           VERBS[verb](jop)))
        np.testing.assert_array_equal(
            _bits(fv.table_read(qp, tables[name]).numpy()),
            _bits(jfv.table_read(jqp, jnode.tables[name])))
    res = fv.farview_request(qp, tables["logs"], (op.RegexMatch("err"),),
                             strings=mat, lengths=lens)
    jres = jfv.farview_request(jqp, jnode.tables["logs"],
                               (jop.RegexMatch("err"),), strings=mat,
                               lengths=lens)
    assert np.asarray(res.mask).tolist() == np.asarray(jres.mask).tolist()
    assert qp.bytes_read_pool == jqp.bytes_read_pool
    assert qp.bytes_shipped == jqp.bytes_shipped
    # promotion of the adopted frames restores the raw words
    node.pool.promote_table(tables["cold"])
    jnode.pool.promote_table(jnode.tables["cold"])
    np.testing.assert_array_equal(
        _bits(fv.table_read(qp, tables["cold"]).numpy()), _bits(words))
    assert node.pool.free_pages == jnode.pool.free_pages
