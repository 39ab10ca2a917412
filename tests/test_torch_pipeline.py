"""The port's CompiledPipeline against the JAX CompiledPipeline, on the CPU.

Every rows-kind combination (select, project, smart addressing, explicit
pack, pre/post crypt, partition `row_ids`) goes through all three entry
points — `__call__`, `run_pages`, `run_pages_batched` — of both packages
on the same numpy inputs, and must agree BITWISE on packed rows and
exactly on counts, survivor ids, read bytes and shipped bytes. The JAX
side runs its CPU lowering (`*_xla` / ref), which its own tests pin
byte-identical to the Pallas kernels' contracts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jop
from repro.core.pipeline import compile_pipeline as jax_compile
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.core.table import string_table as jstring_table
from repro.kernels import ref as jref
from repro_torch.core import operators as op
from repro_torch.core.errors import FarviewError
from repro_torch.core.pipeline import (cache_builds, compile_pipeline,
                                       CompiledPipeline)
from repro_torch.core.table import Column, FTable

N_COLS = 8
# subnormal words compare as 0.0 in the reference (TPU and XLA on the CPU)
SUBNORMALS = tuple(np.array([0x00000005, 0x80000005, 0x007FFFFF, 0x80400000],
                            np.uint32).view(np.float32))
PAGE_WORDS = 1024
KEY_PRE, KEY_POST = (0x0BADF00D, 0x5EED), (77, 0xFFFF0000)


def P(c, o, v):
    return op.Predicate(c, o, v)


# name -> port pipeline (the JAX one is rebuilt from the same fields)
PIPELINES = {
    "select": (op.Select((P("c1", "<", 0.2), P("c3", ">=", -1.0))),),
    "project": (op.Project(("c0", "c5", "c7")),),
    "project_select": (op.Project(("c2", "c4")),
                       op.Select((P("c2", "!=", 0.0), P("c6", ">", -0.5)))),
    "smart": (op.SmartAddress(("c6", "c1")),),
    "smart_select": (op.SmartAddress(("c1", "c4")),
                     op.Select((P("c1", "<=", 0.3), P("c7", "<", 0.0)))),
    "pre_select": (op.Crypt(KEY_PRE, 3, "pre"),
                   op.Select((P("c0", "<", 0.0),))),
    "pre_smart": (op.Crypt(KEY_PRE, 3, "pre"), op.SmartAddress(("c3", "c0")),
                  op.Select((P("c3", "==", 0.0),))),
    "select_post": (op.Select((P("c5", ">", 0.1),)),
                    op.Crypt(KEY_POST, 2**32 - 1, "post")),
    "pre_project_select_post": (op.Crypt(KEY_PRE, 1, "pre"),
                                op.Project(("c1", "c2", "c3")),
                                op.Select((P("c2", "<", 1.0),)),
                                op.Crypt(KEY_POST, 5, "post")),
    "pack": (op.Pack(),),
    "project_select_pack": (op.Project(("c0",)),
                            op.Select((P("c0", ">", 0.0),)), op.Pack()),
}


def _to_jax(pipeline):
    out = []
    for o in pipeline:
        if isinstance(o, op.Select):
            out.append(jop.Select(tuple(jop.Predicate(p.col, p.op, p.value)
                                        for p in o.predicates)))
        elif isinstance(o, op.Crypt):
            out.append(jop.Crypt(o.key, o.nonce, o.when))
        elif isinstance(o, op.Pack):
            out.append(jop.Pack())
        else:
            out.append(getattr(jop, type(o).__name__)(o.cols))
    return tuple(out)


def _schemas():
    names = [f"c{i}" for i in range(N_COLS)]
    return (FTable("t", tuple(Column(c) for c in names)),
            JFTable("t", tuple(JColumn(c) for c in names)))


def _rows(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, N_COLS)).astype(np.float32)
    t[rng.random((n, N_COLS)) < 0.05] = 0.0
    for v in (np.inf, -np.inf, np.nan, -0.0, *SUBNORMALS):
        rows = rng.choice(n, size=max(1, n // 30), replace=False)
        t[rows, rng.integers(0, N_COLS, size=rows.size)] = v
    return t


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _same(port_res, jax_res):
    assert port_res.count == jax_res.count
    assert port_res.shipped_bytes == jax_res.shipped_bytes
    assert port_res.read_bytes == jax_res.read_bytes
    np.testing.assert_array_equal(_bits(port_res.rows.numpy()),
                                  _bits(jax_res.rows))
    if jax_res.sel_ids is None:
        assert port_res.sel_ids is None
    else:
        np.testing.assert_array_equal(port_res.sel_ids, jax_res.sel_ids)


def _pool(tables: list[np.ndarray], seed: int):
    """A pool image holding each table on shuffled pages, plus a null
    page at the end; returns (buf, page lists)."""
    rng = np.random.default_rng(seed)
    n_pages = [-(-t.size // PAGE_WORDS) for t in tables]
    order = rng.permutation(sum(n_pages))
    buf = np.zeros((sum(n_pages) + 1, PAGE_WORDS), np.float32)
    lists, at = [], 0
    for t, k in zip(tables, n_pages):
        pages = order[at: at + k]
        at += k
        flat = np.zeros(k * PAGE_WORDS, np.float32)
        flat[: t.size] = t.reshape(-1)
        buf[pages] = flat.reshape(k, PAGE_WORDS)
        lists.append(pages)
    return buf, lists


@pytest.mark.parametrize("with_ids", [False, True], ids=["solo", "row_ids"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_entry_points_match_jax(name, with_ids):
    schema, jschema = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES[name])
    jpipe = jax_compile(jschema, _to_jax(PIPELINES[name]))
    assert pipe.response_width == jpipe.response_width
    rng = np.random.default_rng(sorted(PIPELINES).index(name))

    # __call__: rows already materialized
    rows = _rows(1, 300)
    ids = rng.choice(10**5, size=300, replace=False) if with_ids else None
    _same(pipe(rows, row_ids=ids, device="cpu"), jpipe(jnp.asarray(rows), row_ids=ids))

    # run_pages: one request gathered from shuffled pool pages, tail masked
    sizes = [900, 1000, 513]
    tables = [_rows(2 + i, n) for i, n in enumerate(sizes)]
    buf, lists = _pool(tables, seed=3)
    tbuf, jbuf = torch.from_numpy(buf), jnp.asarray(buf)
    ids = rng.choice(10**5, size=900, replace=False) if with_ids else None
    for nv in (900, 611):
        _same(pipe.run_pages(tbuf, lists[0], nv, n_rows=900,
                             row_words=N_COLS, row_ids=ids),
              jpipe.run_pages(jbuf, lists[0], nv, n_rows=900,
                              row_words=N_COLS, row_ids=ids))

    # run_pages_batched: a stacked round at the 1024-row bucket, page lists
    # padded with the null page, per-request n_valid
    bucket = 1024
    pages = np.full((3, bucket * N_COLS // PAGE_WORDS), len(buf) - 1)
    for b, pg in enumerate(lists):
        pages[b, : len(pg)] = pg
    row_ids = None
    if with_ids:
        row_ids = np.zeros((3, bucket), np.int64)
        for b, n in enumerate(sizes):
            row_ids[b, :n] = rng.choice(10**5, size=n, replace=False)
    port = pipe.run_pages_batched(tbuf, pages, sizes, n_rows=bucket,
                                  row_words=N_COLS, row_ids=row_ids)
    ref = jpipe.run_pages_batched(jbuf, pages, np.asarray(sizes, np.int32),
                                  n_rows=bucket, row_words=N_COLS,
                                  row_ids=row_ids)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        _same(p, r)


def test_results_are_lazy_until_finalize():
    schema, _ = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES["select"])
    res = pipe(_rows(4, 64), device="cpu")
    seen = []
    res.on_finalize(lambda r: seen.append(r.shipped_bytes))
    assert res._raw is not None and seen == []
    assert isinstance(res.rows, torch.Tensor)      # raw view, no finalize
    assert res._raw is not None
    res.finalize()
    assert res._raw is None and seen == [res.count * N_COLS * 4]
    assert res.finalize() is res and len(seen) == 1


def test_call_without_device_runs_on_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    schema, _ = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES["select"])
    with pytest.raises(FarviewError, match="CUDA"):
        pipe(_rows(4, 64))
    with pytest.raises(FarviewError, match="CUDA"):
        pipe(torch.from_numpy(_rows(4, 64)))


def test_compile_cache_builds_once_per_signature():
    schema, _ = _schemas()
    first = compile_pipeline(schema, PIPELINES["project_select"])
    builds = cache_builds()
    again = compile_pipeline(FTable("other", schema.columns),
                             PIPELINES["project_select"])
    assert again is first and cache_builds() == builds
    other = compile_pipeline(schema, PIPELINES["select"] + (op.Pack(),))
    assert other is not first


JOIN = op.JoinSmall("c0", "build", "k", ("v",))


def test_pre_crypt_regex_builds_and_matches_jax():
    """A pre-Crypt over a string table builds and runs as the JAX pipeline
    does: the bytes are deciphered before the DFA, solo and with row
    ids."""
    pipeline = (op.Crypt(KEY_PRE, 3, "pre"), op.RegexMatch("ab+"))
    jpipeline = (jop.Crypt(KEY_PRE, 3, "pre"), jop.RegexMatch("ab+"))
    strs = [b"xxabbb", b"ab", b"a", b"b", b"zzzzzzzzab", b"", b"ba"] * 3
    jft, mat, lens = jstring_table("s", strs, 16)
    mat = np.asarray(mat)
    jp = jax_compile(jft, jpipeline)
    tp = CompiledPipeline(FTable("s", (Column("bytes", "str"),),
                                 str_width=16), pipeline)
    ids = np.random.default_rng(3).permutation(100)[: len(strs)]
    for row_ids in (None, ids):
        # the stored bytes: the JAX ref cipher over the widened clear
        # bytes at their positions (i, or row_id * 16 + col), cut to uint8
        pos = (np.arange(mat.size) if row_ids is None else
               (row_ids[:, None] * 16 + np.arange(16)).reshape(-1))
        enc = np.asarray(jref.ctr_crypt(
            jnp.asarray(mat.reshape(-1).astype(np.uint32)),
            jnp.asarray(np.asarray(KEY_PRE, np.uint32)), 3,
            idx=jnp.asarray(pos.astype(np.uint32)))).astype(
                np.uint8).reshape(mat.shape)
        exp = jp(jnp.asarray(enc), jnp.asarray(lens),
                 row_ids=row_ids).finalize()
        got = tp(enc, row_ids, lengths=lens, device="cpu").finalize()
        assert got.mask.tolist() == np.asarray(exp.mask).tolist() == [
            b"ab" in s for s in strs]
        assert (got.shipped_bytes, got.read_bytes) == (
            exp.shipped_bytes, exp.read_bytes) == (21, 21 * 16)


def test_join_with_grouping_is_refused_as_in_jax():
    schema, jschema = _schemas()
    pipeline = (JOIN, op.GroupBy("c1", ("c2",)))
    with pytest.raises(ValueError, match="composes with select/project"):
        CompiledPipeline(schema, pipeline)
    with pytest.raises(ValueError, match="composes with select/project"):
        jax_compile(jschema, (jop.JoinSmall("c0", "build", "k", ("v",)),
                              jop.GroupBy("c1", ("c2",))))


def test_string_tables_are_refused():
    schema = FTable("s", (Column("bytes", "str"),), str_width=16)
    with pytest.raises(NotImplementedError, match="string tables"):
        CompiledPipeline(schema, PIPELINES["pack"])


def test_string_table_without_regex_is_a_recorded_divergence():
    """The JAX pipeline runs a string table's raw bytes as the rows kind
    (one 4-byte word a row shipped, though w = 16); the port refuses the
    table at construction (ROADMAP.md queue 3). The port also refuses
    RegexMatch over a word table."""
    strs = [b"error: disk full", b"all fine", b"warn: error"]
    jft, mat, lens = jstring_table("s", strs, 16)
    got = jax_compile(jft, (jop.Pack(),))(jnp.asarray(mat),
                                          jnp.asarray(lens)).finalize()
    assert (got.count, got.shipped_bytes, got.read_bytes) == (3, 12, 48)
    schema = FTable("s", (Column("bytes", "str"),), str_width=16)
    with pytest.raises(NotImplementedError, match="queue 3"):
        CompiledPipeline(schema, (op.Pack(),))
    with pytest.raises(ValueError, match="string table"):
        CompiledPipeline(_schemas()[0], (op.RegexMatch("ab+"),))
