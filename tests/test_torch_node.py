"""The port's FViewNode against the JAX FViewNode, on the CPU.

A JAX node is loaded through its own verbs; the port node takes over the
same pool image and catalog through `load_node_state`. Then three QPairs
submit the same request mix to both: results (bitwise), the scheduler's
dispatch count (stacking), per-QPair read/shipped bytes and pool
counters must agree exactly; group verbs (over an i32-keyed table too)
must agree on their groups payloads and merged totals. Also: deadline
shedding, the card-by-default rule, the flat pool's allocator and reads,
and the client-side PageCache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jfv
from repro.core import operators as jop
from repro.core.pool import FarPool as JFarPool
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.kernels import ref as jref
import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.client import PageCache
from repro_torch.core.errors import DeadlineExceededError, FarviewError
from repro_torch.core.pool import FarPool

N_COLS = 8
CAPACITY, PAGE = 4 * 2**20, 64 * 2**10
KEY, NONCE = (0xC0FFEE, 0xFACADE), 42
COLS = tuple(f"c{i}" for i in range(N_COLS))
SIZES = {"a": 1000, "b": 700, "c": 300}      # a, b share the 1024 bucket


def _words(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, N_COLS)).astype(np.float32)
    for v in (np.inf, -np.inf, np.nan, -0.0):
        rows = rng.choice(n, size=max(1, n // 25), replace=False)
        t[rows, rng.integers(0, N_COLS, size=rows.size)] = v
    return t


def _k_data() -> dict:
    """Table k's columns: c0 integer keys (40 of them), c1.. N(0,1)."""
    rng = np.random.default_rng(9)
    kdata = {"c0": rng.integers(0, 40, 800).astype(np.int32)}
    kdata.update({c: rng.normal(size=800).astype(np.float32)
                  for c in COLS[1:]})
    return kdata


def _plain_rows(name: str) -> np.ndarray:
    """A table's rows as the pipeline sees them (table e decrypted)."""
    if name == "k":
        kdata = _k_data()
        return np.stack([kdata[c].astype(np.float32) for c in COLS], 1)
    name = "a" if name == "e" else name
    i = list(SIZES).index(name)
    return _words(i, SIZES[name])


def _pipelines(o):
    """The request vocabulary, built from either package's operator IR."""
    P = o.Predicate
    return {
        "sel": (o.Select((P("c1", "<", 0.1), P("c2", "!=", 0.0))),),
        "smart": (o.SmartAddress(("c4", "c0")),
                  o.Select((P("c4", ">", -0.3),))),
        "pre_sel": (o.Crypt(KEY, NONCE, "pre"),
                    o.Select((P("c3", "<=", 0.0),))),
        "sel_post": (o.Select((P("c5", ">=", 0.2),)),
                     o.Crypt((9, 10), 11, "post")),
        "proj_sel": (o.Project(("c6", "c7")),
                     o.Select((P("c7", "<", 1.0),))),
        "grp": (o.GroupBy("c0", ("c1", "c2"), n_buckets=16),),
        "sel_dist": (o.Select((P("c3", "<", 0.0),)),
                     o.Distinct(("c0",), n_buckets=8)),
        "pre_grp": (o.Crypt(KEY, NONCE, "pre"),
                    o.GroupBy("c0", ("c5",), n_buckets=32)),
    }


# per QPair: (verb, table, partition row ids?) in submission order
MIX = [
    [("sel", "a", False), ("smart", "c", False), ("pre_sel", "e", False),
     ("sel_post", "b", False), ("proj_sel", "a", False), ("sel", "a", True),
     ("grp", "k", False), ("sel_dist", "a", False)],
    [("sel", "b", False), ("smart", "a", False), ("pre_sel", "e", False),
     ("sel_post", "a", False), ("proj_sel", "c", False), ("sel", "b", True),
     ("grp", "k", False), ("pre_grp", "e", False)],
    [("sel", "c", False), ("smart", "b", False), ("pre_sel", "e", False),
     ("sel_post", "c", False), ("proj_sel", "b", False),
     ("grp", "a", False), ("sel_dist", "b", False)],
]


@pytest.fixture(scope="module")
def nodes():
    jnode = jfv.FViewNode(CAPACITY, page_bytes=PAGE, n_shards=2)
    jqp = jfv.open_connection(jnode)
    cols = tuple(JColumn(c) for c in COLS)
    data = {}
    for i, (name, n) in enumerate(SIZES.items()):
        ft = jfv.alloc_table_mem(jqp, JFTable(name, cols, n_rows=n))
        data[name] = _words(i, n)
        jfv.table_write(jqp, ft, data[name])
    # "e": table a encrypted at rest (CTR over the row-major word stream)
    enc = np.asarray(jref.ctr_crypt(
        jnp.asarray(data["a"].reshape(-1).view(np.uint32)),
        jnp.asarray(np.asarray(KEY, np.uint32)), NONCE))
    ft = jfv.alloc_table_mem(jqp, JFTable("e", cols, n_rows=SIZES["a"]))
    jfv.table_write(jqp, ft, enc.view(np.float32).reshape(-1, N_COLS))
    # "k": an i32 key column (integer keys, 40 of them) for the group verbs
    kcols = (JColumn("c0", "i32"),) + cols[1:]
    ft = jfv.alloc_table_mem(jqp, JFTable("k", kcols, n_rows=800))
    jfv.table_write(jqp, ft, ft.encode(_k_data()))
    jfv.close_connection(jqp)

    catalog = [{"name": t.name, "columns": [c.name for c in t.columns],
                "dtypes": [c.dtype for c in t.columns], "n_rows": t.n_rows,
                "pages": list(t.pages), "table_id": t.table_id}
               for t in jnode.tables.values()]
    node = fv.FViewNode(CAPACITY, page_bytes=PAGE, n_shards=2, device="cpu")
    tables = fv.load_node_state(node, np.asarray(jnode.pool.buf), catalog)
    return jnode, node, tables


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _run_mix(node, fvmod, ops_mod, tables):
    pipes = _pipelines(ops_mod)
    qps = [fvmod.open_connection(node) for _ in MIX]
    reqs = []
    for qp, mix in zip(qps, MIX):
        for verb, name, ids in mix:
            ft = tables[name]
            row_ids = (np.arange(ft.n_rows) * 3 + 5) if ids else None
            reqs.append(fvmod.submit_request(qp, ft, pipes[verb],
                                             row_ids=row_ids))
    before = node.dispatches
    node.flush()
    return qps, [r.wait() for r in reqs], node.dispatches - before


def test_request_mix_matches_jax_node(nodes):
    jnode, node, tables = nodes
    qps, res, n_disp = _run_mix(node, fv, op, tables)
    jqps, jres, j_disp = _run_mix(jnode, jfv, jop, jnode.tables)
    assert n_disp == j_disp
    assert n_disp < sum(len(m) for m in MIX)       # stacking happened
    assert tables["k"].columns[0].dtype == "i32"       # carried across
    for (verb, name, _), r, j in zip([x for m in MIX for x in m], res, jres):
        assert r.kind == j.kind
        assert r.shipped_bytes == j.shipped_bytes
        assert r.read_bytes == j.read_bytes
        if r.kind == "groups":
            _same_groups(r, j, _abs_sums(verb, name, j.groups["bucket_keys"]))
            _same_merge(fv.merge_group_partials(
                tables[name], _pipelines(op)[verb], [r]).groups,
                jfv.merge_group_partials(
                    jnode.tables[name], _pipelines(jop)[verb], [j]).groups,
                verb, name)
            continue
        assert r.count == j.count
        np.testing.assert_array_equal(_bits(r.rows.numpy()), _bits(j.rows))
        if j.sel_ids is None:
            assert r.sel_ids is None
        else:
            np.testing.assert_array_equal(r.sel_ids, j.sel_ids)
    for qp, jqp in zip(qps, jqps):
        assert qp.bytes_read_pool == jqp.bytes_read_pool
        assert qp.bytes_shipped == jqp.bytes_shipped
        assert qp.requests == jqp.requests
    for region, jregion in zip(node.regions, jnode.regions):
        assert region.reconfigurations == jregion.reconfigurations
    for qp, jqp in zip(qps, jqps):
        fv.close_connection(qp)
        jfv.close_connection(jqp)


def _nan_words(x) -> np.ndarray:
    """Integer arrays as they are; f32 arrays as words, NaN as one word."""
    a = np.asarray(x)
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


# per group verb: (predicate column "< 0.0" or None, value columns)
GROUP_VERBS = {"grp": (None, (1, 2)), "sel_dist": (3, (0,)),
               "pre_grp": (None, (5,))}
REL_TOL = 1e-5


def _abs_sums(verb, name, bucket_keys) -> np.ndarray:
    """Each bucket's sum of |v| over the rows it owns (those whose key is
    the bucket's key and that pass the verb's predicate), in float64."""
    rows = _plain_rows(name)
    with np.errstate(invalid="ignore"):
        keys = np.clip(np.rint(np.nan_to_num(rows[:, 0].astype(np.float64),
                                             nan=0.0)), -2**31, 2**31 - 1)
    pcol, vcols = GROUP_VERBS[verb]
    keep = np.ones(len(rows), bool) if pcol is None else rows[:, pcol] < 0
    absv = np.where(keep[:, None],
                    np.abs(rows[:, list(vcols)].astype(np.float64)), 0.0)
    return np.stack([absv[keys == k].sum(0)
                     for k in np.asarray(bucket_keys, np.int64)])


def _same_groups(r, j, abs_sum):
    """Groups payloads bitwise (a NaN compares as NaN), except the finite
    f32 sums: the packages add in different orders, so they agree within
    1e-5 of the bucket's sum of |v| (non-finite sums bitwise)."""
    g, jg = r.groups, j.groups
    for f in ("bucket_keys", "count", "min", "max"):
        np.testing.assert_array_equal(_nan_words(g[f].numpy()),
                                      _nan_words(jg[f]))
    got, exp = g["sum"].numpy(), np.asarray(jg["sum"])
    fin = np.isfinite(exp)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(_nan_words(got[~fin]), _nan_words(exp[~fin]))
    diff = np.abs(got[fin].astype(np.float64) - exp[fin])
    assert np.all(diff <= REL_TOL * abs_sum[fin])
    np.testing.assert_array_equal(g["ovf_keys"], np.asarray(jg["ovf_keys"]))
    np.testing.assert_array_equal(_nan_words(g["ovf_vals"]),
                                  _nan_words(jg["ovf_vals"]))


def _same_merge(merged, jmerged, verb, name):
    """Merged per-key totals: counts, min and max bitwise, finite sums
    within 1e-5 of the key's sum of |v| (non-finite sums bitwise)."""
    assert merged.keys() == jmerged.keys()
    keys = sorted(jmerged)
    abs_sum = _abs_sums(verb, name, keys)
    for k, a in zip(keys, abs_sum):
        c, s, mn, mx = merged[k]
        jc, js, jmn, jmx = (np.asarray(x) for x in jmerged[k])
        assert c == jc
        np.testing.assert_array_equal(_nan_words(np.asarray(mn, np.float32)),
                                      _nan_words(jmn.astype(np.float32)))
        np.testing.assert_array_equal(_nan_words(np.asarray(mx, np.float32)),
                                      _nan_words(jmx.astype(np.float32)))
        s = np.asarray(s, np.float64)
        fin = np.isfinite(js)
        np.testing.assert_array_equal(np.isfinite(s), fin)
        np.testing.assert_array_equal(np.isnan(s), np.isnan(js))
        assert np.all(np.abs(s[fin] - js[fin]) <= REL_TOL * a[fin])


def test_farview_request_and_plain_reads_match_jax(nodes):
    jnode, node, tables = nodes
    qp, jqp = fv.open_connection(node), jfv.open_connection(jnode)
    try:
        pipe = _pipelines(op)["pre_sel"]
        res = fv.farview_request(qp, tables["e"], pipe)
        jres = jfv.farview_request(jqp, jnode.tables["e"],
                                   _pipelines(jop)["pre_sel"])
        assert res.count == jres.count
        np.testing.assert_array_equal(_bits(res.rows.numpy()),
                                      _bits(jres.rows))
        rows = fv.table_read(qp, tables["b"])
        np.testing.assert_array_equal(
            _bits(rows.numpy()),
            _bits(jfv.table_read(jqp, jnode.tables["b"])))
        idx = [0, 699, 17, 400]
        np.testing.assert_array_equal(
            _bits(fv.table_read_rows(qp, tables["b"], idx).numpy()),
            _bits(jfv.table_read_rows(jqp, jnode.tables["b"], idx)))
        assert qp.bytes_shipped == jqp.bytes_shipped
        assert qp.bytes_read_pool == jqp.bytes_read_pool
    finally:
        fv.close_connection(qp)
        jfv.close_connection(jqp)


@pytest.mark.parametrize("deadline", [0, -1.0])
def test_spent_deadline_is_shed_not_dispatched(nodes, deadline):
    _, node, tables = nodes
    qp = fv.open_connection(node)
    try:
        before = node.dispatches
        req = node.submit(qp, tables["a"], _pipelines(op)["sel"],
                          deadline_s=deadline)
        node.flush()
        assert node.dispatches == before
        with pytest.raises(DeadlineExceededError):
            req.wait()
    finally:
        fv.close_connection(qp)


def test_close_connection_fails_queued_requests(nodes):
    _, node, tables = nodes
    qp = fv.open_connection(node)
    req = fv.submit_request(qp, tables["a"], _pipelines(op)["sel"])
    fv.close_connection(qp)
    with pytest.raises(FarviewError, match="closed"):
        req.wait()
    with pytest.raises(FarviewError, match="closed"):
        fv.submit_request(qp, tables["a"], _pipelines(op)["sel"])


def test_node_without_device_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FarviewError, match="CUDA"):
        fv.FViewNode(CAPACITY, page_bytes=PAGE)


def test_flat_pool_allocator_matches_jax():
    pool = FarPool(CAPACITY, page_bytes=PAGE, n_shards=4, device="cpu")
    jpool = JFarPool(CAPACITY, page_bytes=PAGE, n_shards=4)
    cols = tuple(JColumn(c) for c in COLS)
    sizes = [5000, 100, 9000, 1]
    fts = [pool.alloc_table(fv.FTable(f"t{i}", tuple(fv.Column(c)
                                                     for c in COLS), n))
           for i, n in enumerate(sizes)]
    jfts = [jpool.alloc_table(JFTable(f"t{i}", cols, n))
            for i, n in enumerate(sizes)]
    pool.free_table(fts[1])
    jpool.free_table(jfts[1])
    fts.append(pool.alloc_table(fv.FTable("x", fts[0].columns, 20000)))
    jfts.append(jpool.alloc_table(JFTable("x", cols, 20000)))
    assert [f.pages for f in fts] == [f.pages for f in jfts]
    assert [f.table_id for f in fts] == [f.table_id for f in jfts]
    assert pool.free_pages == jpool.free_pages
    words = _words(7, 20000)
    pool.write_table(fts[-1], words)
    jpool.write_table(jfts[-1], words)
    np.testing.assert_array_equal(_bits(pool.buf.numpy()),
                                  _bits(jpool.buf))
    assert vars(pool.stats) == vars(jpool.stats)
    with pytest.raises(MemoryError):
        pool.alloc_table(fv.FTable("big", fts[0].columns, 10**6))


def test_page_cache_matches_jax():
    cache, jcache = PageCache(3000), jfv.PageCache(3000)
    rng = np.random.default_rng(8)
    for step in range(60):
        name, part = f"t{rng.integers(0, 3)}", int(rng.integers(0, 4))
        epoch = int(rng.integers(0, 2))
        if rng.random() < 0.5:
            rows = rng.normal(size=(int(rng.integers(1, 60)), 4))
            cache.put(name, part, epoch, rows)
            jcache.put(name, part, epoch, rows)
        else:
            got, jgot = cache.get(name, part, epoch), jcache.get(name, part,
                                                                 epoch)
            assert (got is None) == (jgot is None)
            if got is not None:
                np.testing.assert_array_equal(got, jgot)
        if step == 40:
            assert cache.drop_table("t1") == jcache.drop_table("t1")
    assert cache.stats() == jcache.stats()
    assert cache.cached_bytes == jcache.cached_bytes and len(cache) == len(
        jcache)
