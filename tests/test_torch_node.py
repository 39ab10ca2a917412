"""The port's FViewNode against the JAX FViewNode, on the CPU.

A JAX node is loaded through its own verbs; the port node takes over the
same pool image and catalog through `load_node_state`. Then three QPairs
submit the same request mix to both: results (bitwise), the scheduler's
dispatch count (stacking), per-QPair read/shipped bytes and pool
counters must agree exactly. Also: deadline shedding, the card-by-default
rule, the flat pool's allocator and reads, and the client-side PageCache.
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
    }


# per QPair: (verb, table, partition row ids?) in submission order
MIX = [
    [("sel", "a", False), ("smart", "c", False), ("pre_sel", "e", False),
     ("sel_post", "b", False), ("proj_sel", "a", False), ("sel", "a", True)],
    [("sel", "b", False), ("smart", "a", False), ("pre_sel", "e", False),
     ("sel_post", "a", False), ("proj_sel", "c", False), ("sel", "b", True)],
    [("sel", "c", False), ("smart", "b", False), ("pre_sel", "e", False),
     ("sel_post", "c", False), ("proj_sel", "b", False)],
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
    for r, j in zip(res, jres):
        assert r.count == j.count
        assert r.shipped_bytes == j.shipped_bytes
        assert r.read_bytes == j.read_bytes
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
