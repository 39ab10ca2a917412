"""The port's small-table join (JoinSmall) and its width, smart-addressing
and bucket-count repairs, against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages:

* the port's `ops.hash_join_full` and `ref.hash_join` against the JAX
  `ops.hash_join` (the Pallas kernel in interpret mode), `ref.hash_join`
  and `ops.hash_join_xla`: the cases of tests/test_join.py, an empty
  build, special probe key words (NaN, +-inf, +-2^31, halves: the
  saturating `rint` conversion) and special build values (NaN payloads,
  +-inf, -0.0, subnormals) held bitwise;
* the port's `compile_pipeline` against the JAX one for join, Select +
  join, Project + join, pre-Crypt + join and join + post-Crypt, each with
  and without partition `row_ids`, through all three entry points (a
  stacked `run_pages_batched` round with ragged n_valid): count, packed
  rows (bitwise), survivor ids, read and shipped bytes and
  `response_width`, all exact;
* the port's `FViewNode` against the JAX node over the same pool image:
  four connections sharing one build stack into one dispatch, equal
  results and byte counters; a build rewritten with a duplicate key
  raises on the next dispatch; a warm round skips the host check;
* the repairs: 40- and 128-column Select/Project against the JAX
  package; SmartAddress + GroupBy / Distinct / JoinSmall against the JAX
  `Project` form (the JAX SmartAddress form clamps its column indices:
  a deliberate divergence, ROADMAP.md queue 3), and the KeyError for a
  column the SmartAddress does not read; a non-power-of-two n_buckets
  refused at construction.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# hypothesis is optional, as in tests/test_join.py: only the property
# test needs it
try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

from repro.core import client as jfv
from repro.core import operators as jop
from repro.core.pipeline import compile_pipeline as jax_compile
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.pipeline import CompiledPipeline
from repro_torch.core.table import Column, FTable
from repro_torch.kernels import hash_join as thj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

PAGE_WORDS = 1024
KEY_PRE, KEY_POST = (0x0BADF00D, 0x5EED), (77, 0xFFFF0000)
COLS = ("k", "a", "b", "c")
# f32 words: NaNs with two payloads, +-inf, -0.0, subnormals, 0.0
SPECIAL_VALUES = np.array([0x7FC00000, 0x7FC0BEEF, 0x7F800000, 0xFF800000,
                           0x80000000, 0x00000005, 0x807FFFFF, 0x00000000],
                          np.uint32).view(np.float32)
# probe key words the conversion saturates or rounds: NaN, +-inf, +-2^31,
# +-1e10, halves, a subnormal
SPECIAL_KEYS = np.array([np.nan, np.inf, -np.inf, 2.0**31, -2.0**31, 1e10,
                         -1e10, 2.5, -0.5, 3.5, 1e-40], np.float32)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# ----------------------------------------------------------- kernel contract
@pytest.mark.parametrize("n,k,v", [(100, 8, 1), (1000, 64, 3), (257, 37, 2),
                                   (4096, 200, 4), (1, 1, 1)])
def test_hash_join_matches_jax(n, k, v):
    rng = np.random.default_rng(n * 7 + k)
    bk = rng.permutation(10 * k)[:k].astype(np.int32)
    bv = rng.normal(size=(k, v)).astype(np.float32)
    pk = rng.integers(0, 10 * k, n).astype(np.int32)
    j, h = tops.hash_join_full(pk, bk, bv, device="cpu")
    rj, rh = jref.hash_join(pk, bk, bv)
    kj, kh = jops.hash_join(jnp.asarray(pk), jnp.asarray(bk),
                            jnp.asarray(bv))
    np.testing.assert_array_equal(h.numpy(), rh)
    np.testing.assert_array_equal(h.numpy(), np.asarray(kh))
    np.testing.assert_array_equal(_bits(j), _bits(rj))
    np.testing.assert_allclose(j.numpy(), np.asarray(kj), rtol=1e-6)
    tj, th = tref.hash_join(torch.from_numpy(pk), torch.from_numpy(bk),
                            torch.from_numpy(bv))
    np.testing.assert_array_equal(_bits(tj), _bits(rj))
    np.testing.assert_array_equal(th.numpy(), rh)


def test_hash_join_rejects_duplicate_build_keys():
    bk = np.asarray([1, 2, 2], np.int32)
    bv = np.ones((3, 1), np.float32)
    with pytest.raises(ValueError, match="unique"):
        tops.hash_join_full(np.ones(10, np.int32), bk, bv, device="cpu")
    with pytest.raises(ValueError, match="unique"):
        jops.hash_join(jnp.asarray(np.ones(10, np.int32)), jnp.asarray(bk),
                       jnp.asarray(bv))


def test_hash_join_empty_build_matches_nothing():
    pk = np.arange(-5, 300, dtype=np.int32)
    bk = np.zeros((0,), np.int32)
    bv = np.zeros((0, 2), np.float32)
    j, h = tops.hash_join_full(pk, bk, bv, device="cpu")
    xj, xh = jops.hash_join_xla(jnp.asarray(pk), jnp.asarray(bk),
                                jnp.asarray(bv))
    kj, kh = jops.hash_join(jnp.asarray(pk), jnp.asarray(bk),
                            jnp.asarray(bv))
    assert j.shape == (305, 2) and not h.any()
    np.testing.assert_array_equal(_bits(j), _bits(xj))
    np.testing.assert_array_equal(_bits(j), _bits(kj))
    np.testing.assert_array_equal(h.numpy(), np.asarray(xh))
    np.testing.assert_array_equal(h.numpy(), np.asarray(kh))


def _special_join_inputs(seed, b, n):
    """A (b, n, 3) f32 probe stack (key column 1) with special key words,
    a build whose keys include the saturated ones, and build values with
    special words."""
    rng = np.random.default_rng(seed)
    probe = rng.normal(size=(b, n, 3)).astype(np.float32)
    keys = rng.integers(-20, 60, size=(b, n)).astype(np.float32)
    hit = rng.random((b, n)) < 0.2
    keys[hit] = rng.choice(SPECIAL_KEYS, hit.sum())
    probe[..., 1] = keys
    bk = np.concatenate([rng.permutation(np.arange(-20, 60))[:30],
                         [2**31 - 1, -2**31, 0, 2, 4]]).astype(np.int32)
    bk = np.unique(bk)
    rng.shuffle(bk)
    bv = rng.normal(size=(bk.size, 2)).astype(np.float32)
    at = rng.random(bv.shape) < 0.4
    bv[at] = rng.choice(SPECIAL_VALUES, at.sum())
    return probe, bk, bv


def test_hash_join_special_keys_and_values_bitwise():
    probe, bk, bv = _special_join_inputs(3, 2, 500)
    n_valid = torch.tensor([500, 321], dtype=torch.int32)
    got = tops.hash_join(torch.from_numpy(probe), 1, torch.from_numpy(bk),
                         torch.from_numpy(bv), n_valid)
    assert got.shape == (2, 500, 3 + 2 + 1)
    np.testing.assert_array_equal(_bits(got[..., :3]), _bits(probe))
    got = got[..., 3:]
    for b, nv in enumerate((500, 321)):
        keys = np.asarray(jnp.rint(jnp.asarray(probe[b, :, 1])).astype(
            jnp.int32))
        rj, rh = jref.hash_join(keys, bk, bv)
        xj, xh = jops.hash_join_xla(jnp.asarray(keys), jnp.asarray(bk),
                                    jnp.asarray(bv))
        rh[nv:] = False
        rj[nv:] = 0.0
        np.testing.assert_array_equal(np.asarray(xh)[:nv], rh[:nv])
        np.testing.assert_array_equal(_bits(xj)[:nv], _bits(rj)[:nv])
        np.testing.assert_array_equal(_bits(got[b, :, :2]), _bits(rj))
        np.testing.assert_array_equal(got[b, :, 2].numpy(),
                                      rh.astype(np.float32))
        assert rh[:nv].sum() > 0
    # the saturated and rounded keys hit: inf -> INT32_MAX, -inf -> INT32_MIN
    # NaN and -0.5 -> 0, 2.5 -> 2, 3.5 -> 4
    flat = probe[0, :, 1]
    for word, key in ((np.inf, 2**31 - 1), (-np.inf, -2**31), (np.nan, 0),
                      (2.5, 2), (3.5, 4), (-0.5, 0)):
        rows = np.flatnonzero((flat == word) | (np.isnan(flat)
                                                & np.isnan(word)))
        if rows.size:
            want = bv[list(bk).index(key)]
            np.testing.assert_array_equal(_bits(got[0, rows, :2]),
                                          np.broadcast_to(_bits(want),
                                                          (rows.size, 2)))


def test_hash_join_writes_the_widened_rows():
    """Each probe row is copied bitwise, then its join words, then zeros
    to the width of `out` (where the pipeline writes its id column
    afterwards)."""
    probe, bk, bv = _special_join_inputs(4, 2, 300)
    probe[0, 5, 2] = SPECIAL_VALUES[1]               # a NaN payload
    n_valid = torch.tensor([300, 123], dtype=torch.int32)
    args = (1, torch.from_numpy(bk), torch.from_numpy(bv), n_valid)
    out = torch.full((2, 300, 7), 7.0)
    # a view with a stride between requests, as the page gather gives
    big = torch.from_numpy(np.concatenate([probe, probe[:, :50]], 1))
    tops.hash_join(big[:, :300], *args, out=out)
    own = tops.hash_join(torch.from_numpy(probe), *args)
    assert own.shape == (2, 300, 6)
    np.testing.assert_array_equal(_bits(out[..., :6]), _bits(own))
    np.testing.assert_array_equal(_bits(out[..., :3]), _bits(probe))
    np.testing.assert_array_equal(_bits(out[..., 6]), 0)
    for k in (0, 3):                # an empty build copies the rows too
        empty = torch.full((2, 300, 6), 7.0)
        tops.hash_join(torch.from_numpy(probe), 1, torch.from_numpy(bk[:k]),
                       torch.from_numpy(bv[:k]), n_valid, out=empty)
        np.testing.assert_array_equal(_bits(empty[..., :3]), _bits(probe))
    with pytest.raises(ValueError, match="out"):
        tops.hash_join(torch.from_numpy(probe), *args,
                       out=torch.zeros((2, 300, 5)))


def test_hash_join_wrapper_refuses_cpu_tensors_and_bad_builds():
    probe = torch.zeros((1, 4, 2))
    keys = torch.zeros((2,), dtype=torch.int32)
    n_valid = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        thj.hash_join(probe, 0, keys, torch.zeros((2, 1)), n_valid)
    with pytest.raises(ValueError, match="build"):
        thj.hash_join_plain(probe, 0, keys, torch.zeros((3, 1)), n_valid)
    with pytest.raises(ValueError, match="column"):
        thj.hash_join_plain(probe, 2, keys, torch.zeros((2, 1)), n_valid)


if HAVE_HYPOTHESIS:
    @settings(deadline=None, max_examples=20)
    @given(n=st.integers(1, 500), k=st.integers(0, 60),
           seed=st.integers(0, 2**31 - 1))
    def test_join_hit_count_property(n, k, seed):
        """#hits == |probe keys that are build keys| (occurrences)."""
        rng = np.random.default_rng(seed)
        bk = rng.permutation(200)[:k].astype(np.int32)
        bv = rng.normal(size=(k, 1)).astype(np.float32)
        pk = rng.integers(0, 200, n).astype(np.int32)
        _, h = tops.hash_join_full(pk, bk, bv, device="cpu")
        assert int(h.sum()) == int(np.isin(pk, bk).sum())
else:
    @pytest.mark.skip(reason="optional dep: pip install hypothesis")
    def test_join_hit_count_property():
        pass


# ------------------------------------------------------------- the pipeline
def _schemas(cols=COLS, key_dtype="i32"):
    dt = [key_dtype if c == "k" else "f32" for c in cols]
    return (FTable("t", tuple(Column(c, d) for c, d in zip(cols, dt))),
            JFTable("t", tuple(JColumn(c, d) for c, d in zip(cols, dt))))


def _to_jax(pipeline):
    out = []
    for o in pipeline:
        if isinstance(o, op.Select):
            out.append(jop.Select(tuple(jop.Predicate(p.col, p.op, p.value)
                                        for p in o.predicates)))
        elif isinstance(o, op.Crypt):
            out.append(jop.Crypt(o.key, o.nonce, o.when))
        elif isinstance(o, op.JoinSmall):
            out.append(jop.JoinSmall(o.probe_key, o.build_table,
                                     o.build_key, o.build_cols))
        elif isinstance(o, op.GroupBy):
            out.append(jop.GroupBy(o.key, o.values, o.aggs, o.n_buckets))
        elif isinstance(o, op.Distinct):
            out.append(jop.Distinct(o.cols, o.n_buckets))
        elif isinstance(o, op.Pack):
            out.append(jop.Pack())
        else:
            out.append(getattr(jop, type(o).__name__)(o.cols))
    return tuple(out)


J = op.JoinSmall("k", "dim", "k", ("v", "w"))
PIPELINES = {
    "join": (J,),
    "select_join": (op.Select((op.Predicate("a", "<", 0.3),)), J),
    "project_join": (op.Project(("k", "b")), J),
    "pre_join": (op.Crypt(KEY_PRE, 3, "pre"), J),
    "join_post": (J, op.Crypt(KEY_POST, 5, "post")),
}


def _probe_table(seed, n):
    """(n, 4) f32 rows: k integer keys in [-20, 60) with special key words
    in 3% of rows, a, b, c N(0,1) with special words."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, 4)).astype(np.float32)
    at = rng.random((n, 4)) < 0.04
    t[at] = rng.choice(SPECIAL_VALUES, at.sum())
    t[:, 0] = rng.integers(-20, 60, n)
    sp = rng.random(n) < 0.03
    t[sp, 0] = rng.choice(SPECIAL_KEYS, sp.sum())
    return t


def _build(seed):
    _, bk, bv = _special_join_inputs(seed, 1, 1)
    return bk, bv


def _encrypted(t):
    words = jnp.asarray(t.reshape(-1).view(np.uint32))
    enc = np.asarray(jref.ctr_crypt(words, jnp.asarray(np.asarray(
        KEY_PRE, np.uint32)), 3))
    return enc.view(np.float32).reshape(t.shape).copy()


def _pool(tables, seed):
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


def _same_rows(port, ref, cols=None):
    """Count, rows (bitwise; ref's columns `cols` when given), survivor
    ids, read and shipped bytes."""
    assert port.count == ref.count
    assert port.shipped_bytes == ref.shipped_bytes
    rows = np.asarray(ref.rows)
    if cols is not None:
        rows = rows[:, cols]
    np.testing.assert_array_equal(_bits(port.rows), _bits(rows))
    if ref.sel_ids is None:
        assert port.sel_ids is None
    else:
        np.testing.assert_array_equal(port.sel_ids, ref.sel_ids)


def _entry_points(pipe, jpipe, build, enc, with_ids, seed, compare):
    """Run both pipelines through __call__, run_pages and a stacked
    run_pages_batched round, and hand each pair of results to compare."""
    rng = np.random.default_rng(seed)
    w = len(pipe._cols)

    def table(s, n):
        t = _probe_table(s, n)
        return _encrypted(t) if enc else t

    rows = table(seed, 300)
    ids = rng.choice(10**5, size=300, replace=False) if with_ids else None
    compare(pipe(rows, ids, build=build, device="cpu"),
            jpipe(jnp.asarray(rows), build=build, row_ids=ids))

    sizes = [900, 1000, 513]
    tables = [table(seed + 1 + i, n) for i, n in enumerate(sizes)]
    buf, lists = _pool(tables, seed=3)
    tbuf, jbuf = torch.from_numpy(buf), jnp.asarray(buf)
    for nv in (900, 611):
        ids = rng.choice(10**5, size=900, replace=False) if with_ids else None
        compare(pipe.run_pages(tbuf, lists[0], nv, build, n_rows=900,
                               row_words=w, row_ids=ids),
                jpipe.run_pages(jbuf, lists[0], nv, build, n_rows=900,
                                row_words=w, row_ids=ids))

    bucket = 1024
    pages = np.full((3, bucket * w // PAGE_WORDS), len(buf) - 1)
    for b, pg in enumerate(lists):
        pages[b, : len(pg)] = pg
    row_ids = None
    if with_ids:
        row_ids = np.zeros((3, bucket), np.int64)
        for b, n in enumerate(sizes):
            row_ids[b, :n] = rng.choice(10**5, size=n, replace=False)
    port = pipe.run_pages_batched(tbuf, pages, sizes, build, n_rows=bucket,
                                  row_words=w, row_ids=row_ids)
    ref = jpipe.run_pages_batched(jbuf, pages, np.asarray(sizes, np.int32),
                                  build, n_rows=bucket, row_words=w,
                                  row_ids=row_ids)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        compare(p, r)


@pytest.mark.parametrize("with_ids", [False, True], ids=["solo", "row_ids"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_join_pipelines_match_jax(name, with_ids):
    schema, jschema = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES[name])
    jpipe = jax_compile(jschema, _to_jax(PIPELINES[name]))
    assert pipe.kind == jpipe.kind == "rows"
    assert pipe.response_width == jpipe.response_width == 4 + 2 + 1
    build = _build(sorted(PIPELINES).index(name))

    def compare(p, r):
        _same_rows(p, r)
        assert p.read_bytes == r.read_bytes
        assert p.rows.shape[1] == pipe.response_width

    _entry_points(pipe, jpipe, build, name == "pre_join", with_ids,
                  seed=sorted(PIPELINES).index(name) * 10 + with_ids,
                  compare=compare)


def test_join_needs_a_build_and_refuses_a_duplicate_key():
    schema, _ = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES["join"])
    rows = _probe_table(0, 50)
    with pytest.raises(ValueError, match="build"):
        pipe(rows, device="cpu")
    bk, bv = _build(0)
    bk[1] = bk[0]
    with pytest.raises(ValueError, match="unique"):
        pipe(rows, build=(bk, bv), device="cpu")
    with pytest.raises(ValueError, match="value columns"):
        pipe(rows, build=(bk[:3], np.zeros((3, 5), np.float32)),
             device="cpu")


# ------------------------------------------------------ SmartAddress repairs
def test_smart_join_equals_the_jax_project_form():
    """The case of ROADMAP.md queue 3: columns a, b, k, c, about half of
    256 probe keys in the build's 0..9. JAX's SmartAddress form probes the
    clamped column `a` (U[0, 1) words: every row hits); the port gives the
    Project form's answer."""
    cols = ("a", "b", "k", "c")
    schema, jschema = _schemas(cols)
    rng = np.random.default_rng(11)
    t = rng.random((256, 4)).astype(np.float32)
    t[:, 2] = np.where(rng.random(256) < 0.5, rng.integers(0, 10, 256),
                       rng.integers(17, 40, 256))
    bk = np.arange(10, dtype=np.int32)
    bv = rng.random((10, 1)).astype(np.float32)
    join = op.JoinSmall("k", "dim", "k", ("v",))
    smart = CompiledPipeline(schema, (op.SmartAddress(("k", "a")), join))
    jproj = jax_compile(jschema, _to_jax((op.Project(("k", "a")), join)))
    jsmart = jax_compile(jschema, _to_jax((op.SmartAddress(("k", "a")),
                                           join)))
    port = smart(t, build=(bk, bv), device="cpu")
    ref = jproj(jnp.asarray(t), build=(bk, bv))
    assert port.count == ref.count == int(np.isin(t[:, 2], bk).sum()) < 256
    assert jsmart(jnp.asarray(t), build=(bk, bv)).count == 256   # clamped
    assert smart.response_width == 2 + 1 + 1
    # the rows: the addressed columns in SmartAddress order, then the
    # build column and the zeroed hit column; shipped as the Project form
    _same_rows(port, ref, cols=[2, 0, 4, 5])
    assert port.shipped_bytes == port.count * (2 + 1) * 4
    assert port.read_bytes == 256 * 2 * 4       # billed by columns


@pytest.mark.parametrize("name", ["groupby", "distinct", "join"])
def test_smart_address_resolves_columns_inside_its_own(name):
    schema, jschema = _schemas()
    cols = ("b", "k", "c")
    tail = {"groupby": op.GroupBy("k", ("c", "b"), n_buckets=32),
            "distinct": op.Distinct(("k",), n_buckets=16),
            "join": J}[name]
    smart = CompiledPipeline(schema, (op.SmartAddress(cols),
                                      op.Select((op.Predicate(
                                          "b", "<", 0.5),)), tail))
    jproj = jax_compile(jschema, _to_jax((op.Project(cols), op.Select((
        op.Predicate("b", "<", 0.5),)), tail)))
    build = _build(5) if name == "join" else None

    def compare(p, r):
        if name == "join":
            _same_rows(p, r, cols=[2, 0, 3, 4, 5, 6])
        else:
            assert p.shipped_bytes == r.shipped_bytes
            g, j = p.groups, r.groups
            for f in ("bucket_keys", "count"):
                np.testing.assert_array_equal(g[f].numpy(), np.asarray(j[f]))
            for f in ("sum", "min", "max"):
                np.testing.assert_array_equal(_bits(g[f]), _bits(j[f]))
            np.testing.assert_array_equal(g["ovf_keys"],
                                          np.asarray(j["ovf_keys"]))
            np.testing.assert_array_equal(_bits(g["ovf_vals"]),
                                          _bits(j["ovf_vals"]))

    # integer-valued value columns: group sums compare bitwise
    rng = np.random.default_rng(8)
    rows = np.round(rng.normal(size=(400, 4)) * 4).astype(np.float32)
    rows[:, 0] = rng.integers(-20, 60, 400)
    compare(smart(rows, build=build, device="cpu"),
            jproj(jnp.asarray(rows), build=build))
    buf, lists = _pool([rows], seed=1)
    port = smart.run_pages(torch.from_numpy(buf), lists[0], 333, build,
                           n_rows=400, row_words=4)
    compare(port, jproj.run_pages(jnp.asarray(buf), lists[0], 333, build,
                                  n_rows=400, row_words=4))
    assert port.read_bytes == 400 * len(cols) * 4


@pytest.mark.parametrize("tail", [
    op.GroupBy("c", ("b",)), op.GroupBy("k", ("a",)),
    op.Distinct(("a",)), op.JoinSmall("a", "dim", "k", ("v",))],
    ids=["group_key", "group_value", "distinct", "probe_key"])
def test_smart_address_refuses_a_column_it_does_not_read(tail):
    schema, _ = _schemas()
    with pytest.raises(KeyError, match="SmartAddress"):
        CompiledPipeline(schema, (op.SmartAddress(("k", "b")), tail))


@pytest.mark.parametrize("tail", [
    op.GroupBy("k", ("a",), n_buckets=1000), op.Distinct(("k",), n_buckets=6),
    op.GroupBy("k", ("a",), n_buckets=0)],
    ids=["groupby_1000", "distinct_6", "groupby_0"])
def test_non_power_of_two_buckets_are_refused_at_construction(tail):
    schema, _ = _schemas()
    with pytest.raises(ValueError, match="power of 2"):
        CompiledPipeline(schema, (tail,))


# ------------------------------------------------------------- wide tables
@pytest.mark.parametrize("n_cols", [33, 40, 128])
def test_wide_select_and_project_match_jax(n_cols):
    names = tuple(f"c{i}" for i in range(n_cols))
    schema = FTable("t", tuple(Column(c) for c in names))
    jschema = JFTable("t", tuple(JColumn(c) for c in names))
    sel = op.Select((op.Predicate("c1", "<", 0.2),
                     op.Predicate(f"c{n_cols - 1}", ">=", -1.0)))
    for pipeline in ((sel,), (op.Project(("c0", "c2", f"c{n_cols - 3}")),
                              sel),
                     (op.SmartAddress((f"c{n_cols - 1}", "c1", "c7")), sel)):
        pipe = CompiledPipeline(schema, pipeline)
        jpipe = jax_compile(jschema, _to_jax(pipeline))
        rng = np.random.default_rng(n_cols)
        rows = rng.normal(size=(300, n_cols)).astype(np.float32)
        at = rng.random(rows.shape) < 0.02
        rows[at] = rng.choice(SPECIAL_VALUES, at.sum())
        port, ref = pipe(rows, device="cpu"), jpipe(jnp.asarray(rows))
        _same_rows(port, ref)
        assert port.read_bytes == ref.read_bytes
        sizes = [300, 211]
        tables = [rows, rows[:211] * 2]
        buf, lists = _pool(tables, seed=2)
        pages = np.full((2, -(-512 * n_cols // PAGE_WORDS)), len(buf) - 1)
        for b, pg in enumerate(lists):
            pages[b, : len(pg)] = pg
        for p, r in zip(
                pipe.run_pages_batched(torch.from_numpy(buf), pages, sizes,
                                       n_rows=512, row_words=n_cols),
                jpipe.run_pages_batched(jnp.asarray(buf), pages,
                                        np.asarray(sizes, np.int32),
                                        n_rows=512, row_words=n_cols)):
            _same_rows(p, r)
            assert p.read_bytes == r.read_bytes


def test_wide_grouping_with_many_value_columns_matches_jax():
    """64 columns, 20 value columns: the card runs the aggregation in
    chunks of 16 value columns; on the CPU the plain version runs."""
    names = tuple(f"c{i}" for i in range(64))
    dt = ["i32"] + ["f32"] * 63
    schema = FTable("t", tuple(Column(c, d) for c, d in zip(names, dt)))
    jschema = JFTable("t", tuple(JColumn(c, d) for c, d in zip(names, dt)))
    pipeline = (op.Select((op.Predicate("c63", "<", 1.0),)),
                op.GroupBy("c0", tuple(f"c{i}" for i in range(40, 60)),
                           n_buckets=64))
    rng = np.random.default_rng(64)
    rows = np.round(rng.normal(size=(500, 64)) * 5).astype(np.float32)
    rows[:, 0] = rng.integers(0, 90, 500)
    port = CompiledPipeline(schema, pipeline)(rows, device="cpu")
    ref = jax_compile(jschema, _to_jax(pipeline))(jnp.asarray(rows))
    assert port.shipped_bytes == ref.shipped_bytes
    for f in ("count", "sum", "min", "max", "bucket_keys"):
        np.testing.assert_array_equal(port.groups[f].numpy(),
                                      np.asarray(ref.groups[f]))
    np.testing.assert_array_equal(_bits(port.groups["ovf_vals"]),
                                  _bits(ref.groups["ovf_vals"]))


# ------------------------------------------------------------------ the node
CAPACITY, PAGE = 4 * 2**20, 64 * 2**10
PROBE_SIZES = (1000, 900, 700, 600)      # one 1024-row bucket: one stack


@pytest.fixture(scope="module")
def nodes():
    """A JAX node loaded through its own verbs and a port node that took
    over its pool image: probe tables p0..p3 (k i32, a, b) and two build
    tables (k i32, v)."""
    jnode = jfv.FViewNode(CAPACITY, page_bytes=PAGE, n_shards=2)
    jqp = jfv.open_connection(jnode)
    rng = np.random.default_rng(21)
    pcols = (JColumn("k", "i32"), JColumn("a"), JColumn("b"))
    for i, n in enumerate(PROBE_SIZES):
        ft = jfv.alloc_table_mem(jqp, JFTable(f"p{i}", pcols, n_rows=n))
        jfv.table_write(jqp, ft, ft.encode({
            "k": rng.integers(0, 1024, n).astype(np.int32),
            "a": rng.random(n).astype(np.float32),
            "b": rng.random(n).astype(np.float32)}))
    bcols = (JColumn("k", "i32"), JColumn("v"))
    for k in (512, 64):
        ft = jfv.alloc_table_mem(jqp, JFTable(f"build{k}", bcols, n_rows=k))
        jfv.table_write(jqp, ft, ft.encode({
            "k": rng.permutation(1024)[:k].astype(np.int32),
            "v": rng.random(k).astype(np.float32)}))
    jfv.close_connection(jqp)
    catalog = [{"name": t.name, "columns": [c.name for c in t.columns],
                "dtypes": [c.dtype for c in t.columns], "n_rows": t.n_rows,
                "pages": list(t.pages), "table_id": t.table_id}
               for t in jnode.tables.values()]
    node = fv.FViewNode(CAPACITY, page_bytes=PAGE, n_shards=2, device="cpu")
    tables = fv.load_node_state(node, np.asarray(jnode.pool.buf), catalog)
    return jnode, node, tables


def _join_verbs(o, k=512):
    join = o.JoinSmall("k", f"build{k}", "k", ("v",))
    return {"join": (join,),
            "select_join": (o.Select((o.Predicate("a", "<", 0.5),)), join),
            "join_post": (join, o.Crypt(KEY_POST, 9, "post"))}


def test_node_join_rounds_match_jax_node(nodes):
    jnode, node, tables = nodes
    qps = [fv.open_connection(node) for _ in PROBE_SIZES]
    jqps = [jfv.open_connection(jnode) for _ in PROBE_SIZES]
    try:
        for k in (512, 64):
            verbs, jverbs = _join_verbs(op, k), _join_verbs(jop, k)
            read0 = (node.pool.stats.bytes_read, jnode.pool.stats.bytes_read)
            d0 = (node.dispatches, jnode.dispatches)
            reqs = [fv.submit_request(qp, tables[f"p{i}"], verbs[v])
                    for v in verbs for i, qp in enumerate(qps)]
            jreqs = [jfv.submit_request(qp, jnode.tables[f"p{i}"],
                                        jverbs[v])
                     for v in jverbs for i, qp in enumerate(jqps)]
            node.flush()
            jnode.flush()
            # four connections sharing one build: one dispatch a verb
            assert node.dispatches - d0[0] == jnode.dispatches - d0[1] == 3
            for r, j in zip(reqs, jreqs):
                p, q = r.wait(), j.wait()
                _same_rows(p, q)
                assert p.read_bytes == q.read_bytes
                assert p.count > 0
            # the build read is billed to the pool at every dispatch
            assert (node.pool.stats.bytes_read - read0[0]
                    == jnode.pool.stats.bytes_read - read0[1])
        for qp, jqp in zip(qps, jqps):
            assert qp.bytes_read_pool == jqp.bytes_read_pool
            assert qp.bytes_shipped == jqp.bytes_shipped
    finally:
        for qp in qps:
            fv.close_connection(qp)
        for jqp in jqps:
            jfv.close_connection(jqp)


def test_node_warm_round_skips_the_host_check(nodes, monkeypatch):
    _, node, tables = nodes
    calls = []
    check = tops.check_build_unique
    monkeypatch.setattr(tops, "check_build_unique",
                        lambda keys: calls.append(1) or check(keys))
    qps = [fv.open_connection(node) for _ in range(2)]
    try:
        build = tables["build64"]
        rows = node.pool.read_table(build).clone()
        fv.table_write(qps[0], build, rows)         # a new generation
        verb = _join_verbs(op, 64)["join"]

        def round_():
            reqs = [fv.submit_request(qp, tables[f"p{i}"], verb)
                    for i, qp in enumerate(qps)]
            node.flush()
            return [r.wait().count for r in reqs]

        first = round_()
        assert len(calls) == 1                      # cold: checked once
        assert round_() == first and len(calls) == 1   # warm: not again
        fv.table_write(qps[0], build, rows)         # rewritten: checked
        assert round_() == first and len(calls) == 2
    finally:
        for qp in qps:
            fv.close_connection(qp)


def test_node_build_rewritten_with_a_duplicate_key_raises(nodes):
    jnode, node, tables = nodes
    qp, jqp = fv.open_connection(node), jfv.open_connection(jnode)
    try:
        verb = _join_verbs(op, 512)["join"]
        assert fv.farview_request(qp, tables["p0"], verb).count > 0
        build = tables["build512"]
        rows = node.pool.read_table(build).clone()
        good = rows.clone()
        rows[7, 0] = rows[3, 0]
        fv.table_write(qp, build, rows)
        with pytest.raises(ValueError, match="unique"):
            fv.farview_request(qp, tables["p0"], verb)
        jbuild = jnode.tables["build512"]
        jfv.table_write(jqp, jbuild, rows.numpy())
        with pytest.raises(ValueError, match="unique"):
            jfv.farview_request(jqp, jnode.tables["p0"],
                                _join_verbs(jop, 512)["join"]).finalize()
        fv.table_write(qp, build, good)
        jfv.table_write(jqp, jbuild, good.numpy())
        assert fv.farview_request(qp, tables["p0"], verb).count > 0
    finally:
        fv.close_connection(qp)
        jfv.close_connection(jqp)
