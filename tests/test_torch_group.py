"""The port's grouping (GroupBy / Distinct) against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages:

* the port's `kernels/ref.py` grouping functions against the JAX ones;
* `ops.group_aggregate_full` / `ops.distinct` on the adversarial key sets
  of tests/test_overflow_grouping.py against `group_aggregate_exact`;
* the reference behaviours the port copies rather than repairs (subnormal
  values, +-0.0, NaN/inf, saturated key conversion, dropped rows that
  still claim buckets), each pinned against the JAX pipeline;
* the port's `compile_pipeline` against the JAX one for GroupBy,
  Distinct, Select + GroupBy and pre-Crypt + GroupBy through all three
  entry points, with ragged n_valid, and the client-side merge.

Comparison rule: bitwise everywhere (a NaN compares as NaN, whatever its
payload) except f32 sums, which are bitwise on integer-valued data and
within 1e-5 of the bucket's sum of |v| otherwise (the two packages add
in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jop
from repro.core.offload import _merge as jax_merge
from repro.core.pipeline import compile_pipeline as jax_compile
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.kernels import ref as jref
from repro_torch.core import operators as op
from repro_torch.core.client import merge_group_partials
from repro_torch.core.errors import FarviewError
from repro_torch.core.offload import _merge, merge_groups_device
from repro_torch.core.pipeline import _DROP_KEY, CompiledPipeline
from repro_torch.core.table import Column, FTable
from repro_torch.kernels import hash_group as thg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

N_COLS = 8
PAGE_WORDS = 1024
REL_TOL = 1e-5
KEY = (0x0BADF00D, 0x5EED)
# f32 words: subnormals, +-0.0, +-inf, NaNs with two payloads
# the JAX references, traced once per shape (eager dispatch of their scans
# is slow on the CPU)
jax_group_aggregate = jax.jit(jref.group_aggregate, static_argnums=2)
jax_segmented_reduce = jax.jit(jref.segmented_reduce)
SPECIALS = np.array([0x00000005, 0x807FFFFF, 0x80000005, 0x00400000,
                     0x80000000, 0x00000000, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0x7FC0BEEF], np.uint32).view(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _words(x) -> np.ndarray:
    """int32 words with every NaN made one word: NaN compares as NaN."""
    a = _np(x)
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def assert_exact(port, ref):
    np.testing.assert_array_equal(_words(port), _words(ref))


def assert_sums(port, ref, abs_sum=None):
    """Integer-valued data (abs_sum None): bitwise. Otherwise non-finite
    sums bitwise and finite ones within REL_TOL of the bucket's sum |v|."""
    p, r = _np(port).astype(np.float32), _np(ref).astype(np.float32)
    if abs_sum is None:
        assert_exact(p, r)
        return
    fin = np.isfinite(r)
    assert_exact(np.where(fin, 0, p), np.where(fin, 0, r))
    diff = np.abs(p[fin].astype(np.float64) - r[fin])
    assert np.all(diff <= REL_TOL * np.abs(_np(abs_sum)[fin]) + 1e-30)


def assert_groups(port: dict, ref: dict, abs_sum=None):
    for f in ("bucket_keys", "count", "min", "max"):
        assert_exact(port[f], ref[f])
    if "overflow_mask" in ref:
        assert_exact(port["overflow_mask"], ref["overflow_mask"])
    assert_sums(port["sum"], ref["sum"], abs_sum)


def _values(rng, n, v, integer, specials=0.1):
    vals = rng.normal(size=(n, v)).astype(np.float32)
    if integer:
        vals = np.round(vals * 6).astype(np.float32)
    hit = rng.random((n, v)) < specials
    vals[hit] = rng.choice(SPECIALS, hit.sum())
    return vals


def _keys(rng, n, high):
    keys = rng.integers(-5, high, n).astype(np.int32)
    keys[rng.random(n) < 0.05] = rng.choice(
        [-2**31, -2**31 + 1, 2**31 - 1], 1)[0]
    return keys


# ---------------------------------------------------------------- ref parity
REF_CASES = [(n, nb, v, integer) for n, nb, v, integer in (
    (1, 8, 1, True), (2, 2, 1, False), (3, 32, 2, True), (17, 8, 3, False),
    (257, 32, 2, True), (1000, 256, 1, False), (2048, 1024, 2, True),
    (2048, 16, 4, False))]


@pytest.mark.parametrize("n,nb,v,integer", REF_CASES)
def test_ref_group_functions_match_jax(n, nb, v, integer):
    rng = np.random.default_rng(n * 31 + nb)
    keys = _keys(rng, n, max(3, nb // 2))
    vals = _values(rng, n, v, integer)

    b = tref.bucket_of(_t(keys), nb)
    jb = np.asarray(jref.bucket_of(jnp.asarray(keys), nb))
    assert_exact(b, jb)
    order, sb = tref.sort_by_bucket(b, nb)
    jorder, jsb = jref.sort_by_bucket(jnp.asarray(jb), nb)
    assert_exact(order.to(torch.int32), np.asarray(jorder))
    assert_exact(sb, np.asarray(jsb))
    for port, ref in zip(tref.segment_spans(sb, nb),
                         jref.segment_spans(jnp.asarray(jsb), nb)):
        assert_exact(port.to(torch.int32) if port.dtype == torch.int64
                     else port, np.asarray(ref))

    flags = np.concatenate([[True], np.asarray(jsb)[1:]
                            != np.asarray(jsb)[:-1]])[:n]
    cnt = rng.integers(0, 4, n).astype(np.int32)
    sv = vals[np.asarray(jorder)]
    port = tref.segmented_reduce(_t(sv), _t(sv), _t(sv), _t(flags),
                                 counts=_t(cnt))
    ref = jax_segmented_reduce(jnp.asarray(sv), jnp.asarray(sv),
                                jnp.asarray(sv), jnp.asarray(flags),
                                counts=jnp.asarray(cnt))
    assert_exact(port[0], np.asarray(ref[0]))
    assert_exact(port[2], np.asarray(ref[2]))
    assert_exact(port[3], np.asarray(ref[3]))
    abs_scan = jax_segmented_reduce(*(jnp.asarray(np.abs(sv)),) * 3,
                                    jnp.asarray(flags))[0]
    assert_sums(port[1], np.asarray(ref[1]),
                None if integer else np.asarray(abs_scan))

    res = tref.group_aggregate(_t(keys), _t(vals), nb)
    jres = jax_group_aggregate(jnp.asarray(keys), jnp.asarray(vals), nb)
    abs_sum = None if integer else np.asarray(jax_group_aggregate(
        jnp.asarray(keys), jnp.asarray(np.abs(vals)), nb)["sum"])
    assert_groups(res, {f: np.asarray(x) for f, x in jres.items()}, abs_sum)

    # the wrapper's plain version takes a stack: each request as alone
    stack = thg.group_aggregate_plain(_t(np.stack([keys, keys[::-1]])),
                                      _t(np.stack([vals, vals[::-1]])), nb)
    assert_groups({f: x[0] for f, x in stack.items()}, res, abs_sum)
    back = tref.group_aggregate(_t(keys[::-1].copy()),
                                _t(vals[::-1].copy()), nb)
    assert_groups({f: x[1] for f, x in stack.items()}, back, abs_sum)


def test_ref_group_aggregate_exact_matches_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 9, 300).astype(np.int32)
    vals = _values(rng, 300, 2, False, specials=0.0)
    port, ref = (tref.group_aggregate_exact(keys, vals),
                 jref.group_aggregate_exact(keys, vals))
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k][0] == ref[k][0]
        for a, b in zip(port[k][1:], ref[k][1:]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ adversarial key sets
def _same_bucket_keys(n_distinct, n_buckets):
    cand = np.arange(1, 200000, dtype=np.int32)
    b = np.asarray(jref.bucket_of(jnp.asarray(cand), n_buckets))
    return cand[b == 0][:n_distinct]


def _adversarial_sets(rng):
    """The three sets of tests/test_overflow_grouping.py: every key in one
    bucket, 500 keys over 32 buckets, one dominant key + colliding tail."""
    one = _same_bucket_keys(60, 32)
    return 32, [one[rng.integers(0, len(one), 480)],
                rng.integers(0, 500, 480).astype(np.int32),
                np.concatenate([np.full(400, int(one[0]), np.int32),
                                one[:40], one[:40]])]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["one_bucket", "500_keys",
                                                  "skew"])
def test_group_aggregate_full_adversarial_exact(which):
    nb, key_sets = _adversarial_sets(np.random.default_rng(11))
    keys = key_sets[which]
    vals = np.random.default_rng(which).integers(
        -9, 9, (len(keys), 2)).astype(np.float32)
    got = tops.group_aggregate_full(keys, vals, n_buckets=nb, device="cpu")
    exact = jref.group_aggregate_exact(keys, vals)
    assert set(got) == set(exact)
    for k in exact:
        assert got[k][0] == exact[k][0]
        for a, b in zip(got[k][1:], exact[k][1:]):
            np.testing.assert_array_equal(np.asarray(a, np.float64), b)
    raw = tops.group_aggregate(_t(keys[None]), _t(vals[None]), nb)
    if which < 2:   # sets one_bucket / 500_keys really are overflow-heavy
        assert raw["overflow_mask"].float().mean() > 0.5
    assert (tops.distinct(keys, n_buckets=nb, device="cpu")
            == sorted(set(keys.tolist())))


def test_full_and_distinct_without_device_run_on_the_card_or_raise(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.arange(8, dtype=np.int32)
    with pytest.raises(FarviewError, match="CUDA"):
        tops.group_aggregate_full(keys, np.ones((8, 1), np.float32))
    with pytest.raises(FarviewError, match="CUDA"):
        tops.distinct(keys)


# ------------------------------------------------------------ the pipelines
def _schemas():
    names = [f"c{i}" for i in range(N_COLS)]
    dt = ["i32"] + ["f32"] * (N_COLS - 1)
    return (FTable("t", tuple(Column(c, d) for c, d in zip(names, dt))),
            JFTable("t", tuple(JColumn(c, d) for c, d in zip(names, dt))))


def _to_jax(pipeline):
    out = []
    for o in pipeline:
        if isinstance(o, op.Select):
            out.append(jop.Select(tuple(jop.Predicate(p.col, p.op, p.value)
                                        for p in o.predicates)))
        elif isinstance(o, op.Crypt):
            out.append(jop.Crypt(o.key, o.nonce, o.when))
        elif isinstance(o, op.GroupBy):
            out.append(jop.GroupBy(o.key, o.values, o.aggs, o.n_buckets))
        else:
            out.append(jop.Distinct(o.cols, o.n_buckets))
    return tuple(out)


PIPELINES = {
    "groupby": (op.GroupBy("c0", ("c1", "c2"), n_buckets=32),),
    "distinct": (op.Distinct(("c0",), n_buckets=16),),
    "select_groupby": (op.Select((op.Predicate("c3", "<", 0.0),)),
                       op.GroupBy("c0", ("c1",), ("count", "sum", "min",
                                                  "max"), n_buckets=64)),
    "pre_groupby": (op.Crypt(KEY, 7, "pre"),
                    op.GroupBy("c0", ("c4", "c5", "c6"), n_buckets=8)),
}


def _rows(seed, n, integer=False):
    rng = np.random.default_rng(seed)
    t = _values(rng, n * N_COLS, 1, integer, specials=0.03).reshape(
        n, N_COLS)
    t[:, 0] = rng.integers(0, 50, n)
    t[rng.random(n) < 0.03, 0] = rng.choice(
        np.array([np.nan, np.inf, -np.inf, 1e10, -1e10, 2.5, -0.5],
                 np.float32), 1)[0]
    return t


def _encrypted(t):
    words = jnp.asarray(t.reshape(-1).view(np.uint32))
    enc = np.asarray(jref.ctr_crypt(words, jnp.asarray(np.asarray(
        KEY, np.uint32)), 7))
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


def _same_result(port, ref, abs_ref=None):
    assert port.kind == ref.kind == "groups"
    assert port.shipped_bytes == ref.shipped_bytes
    assert port.read_bytes == ref.read_bytes
    g, j = port.groups, ref.groups
    assert g["drop_key"] == j["drop_key"] == _DROP_KEY
    abs_sum = None if abs_ref is None else np.asarray(abs_ref.groups["sum"])
    assert_groups(g, {f: np.asarray(j[f]) for f in
                      ("bucket_keys", "count", "sum", "min", "max")}, abs_sum)
    assert_exact(g["ovf_keys"], np.asarray(j["ovf_keys"]))
    np.testing.assert_array_equal(np.asarray(g["ovf_vals"]).view(np.uint32),
                                  np.asarray(j["ovf_vals"]).view(np.uint32))


def _abs_table(t, pipe_name):
    """t with every value word made non-negative (keys untouched): the
    sums of this table bound each bucket's rounding. Encrypted tables are
    decrypted, made non-negative and encrypted again."""
    plain = _encrypted(t) if pipe_name == "pre_groupby" else t
    a = np.abs(plain)
    a[:, 0] = plain[:, 0]
    a[:, 3] = plain[:, 3]               # the predicate column stays
    return _encrypted(a) if pipe_name == "pre_groupby" else a


@pytest.mark.parametrize("integer", [True, False], ids=["int", "normal"])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_group_pipelines_match_jax(name, integer):
    schema, jschema = _schemas()
    pipe = CompiledPipeline(schema, PIPELINES[name])
    jpipe = jax_compile(jschema, _to_jax(PIPELINES[name]))
    assert pipe.kind == jpipe.kind == "groups"
    seed = sorted(PIPELINES).index(name) * 10 + integer
    enc = name == "pre_groupby"

    def table(s, n):
        t = _rows(s, n, integer)
        return _encrypted(t) if enc else t

    def tol(t):
        return None if integer else _abs_table(t, name)

    # __call__: rows already materialized
    rows = table(seed, 300)
    abs_ref = None if integer else jpipe(jnp.asarray(tol(rows)))
    _same_result(pipe(rows, device="cpu"), jpipe(jnp.asarray(rows)), abs_ref)

    # run_pages: one request from shuffled pool pages, tail masked
    sizes = [900, 1000, 513]
    tables = [table(seed + 1 + i, n) for i, n in enumerate(sizes)]
    buf, lists = _pool(tables, seed=3)
    abs_buf = None if integer else jnp.asarray(_pool(
        [tol(t) for t in tables], seed=3)[0])
    tbuf, jbuf = torch.from_numpy(buf), jnp.asarray(buf)
    for nv in (900, 611):
        abs_ref = None if integer else jpipe.run_pages(
            abs_buf, lists[0], nv, n_rows=900, row_words=N_COLS)
        _same_result(pipe.run_pages(tbuf, lists[0], nv, n_rows=900,
                                    row_words=N_COLS),
                     jpipe.run_pages(jbuf, lists[0], nv, n_rows=900,
                                     row_words=N_COLS), abs_ref)

    # run_pages_batched: a stacked round at the 1024-row bucket, page lists
    # padded with the null page, ragged n_valid
    bucket = 1024
    pages = np.full((3, bucket * N_COLS // PAGE_WORDS), len(buf) - 1)
    for b, pg in enumerate(lists):
        pages[b, : len(pg)] = pg
    port = pipe.run_pages_batched(tbuf, pages, sizes, n_rows=bucket,
                                  row_words=N_COLS)
    ref = jpipe.run_pages_batched(jbuf, pages, np.asarray(sizes, np.int32),
                                  n_rows=bucket, row_words=N_COLS)
    abs_refs = ([None] * 3 if integer else jpipe.run_pages_batched(
        abs_buf, pages, np.asarray(sizes, np.int32), n_rows=bucket,
        row_words=N_COLS))
    assert len(port) == len(ref) == 3
    for p, r, a in zip(port, ref, abs_refs):
        _same_result(p, r, a)

    # the client-side merge of each result's buckets + collision rows
    for p, r in zip(port, ref):
        merged = merge_group_partials(schema, PIPELINES[name], [p]).groups
        jmerged = jax_merge(jschema, _to_jax(PIPELINES[name]), [r]).groups
        assert merged.keys() == jmerged.keys()
        for k in jmerged:
            assert merged[k][0] == jmerged[k][0]
            assert_exact(merged[k][2], np.asarray(jmerged[k][2]))
            assert_exact(merged[k][3], np.asarray(jmerged[k][3]))
            s, js = np.asarray(merged[k][1]), np.asarray(jmerged[k][1])
            assert np.array_equal(np.isnan(s), np.isnan(js))
            if integer:
                assert_exact(s, js)


def test_merge_of_several_partials_matches_jax():
    schema, jschema = _schemas()
    pipe = PIPELINES["select_groupby"]
    cp = CompiledPipeline(schema, pipe)
    jcp = jax_compile(jschema, _to_jax(pipe))
    parts = [_rows(40 + i, n, integer=True) for i, n in enumerate(
        (200, 350, 1))]
    port = [cp(t, device="cpu") for t in parts]
    ref = [jcp(jnp.asarray(t)) for t in parts]
    merged = _merge(schema, pipe, port)
    jmerged = jax_merge(jschema, _to_jax(pipe), ref)
    assert merged.shipped_bytes == jmerged.shipped_bytes
    assert merged.read_bytes == jmerged.read_bytes
    assert merged.groups.keys() == jmerged.groups.keys()
    for k, (c, s, mn, mx) in jmerged.groups.items():
        assert merged.groups[k][0] == c
        for a, b in zip(merged.groups[k][1:], (s, mn, mx)):
            assert_exact(a, np.asarray(b))
    # no partials: the empty groups result; rows merges wait for slice 6
    assert _merge(schema, pipe, []).groups == {}
    rows_pipe = (op.Select((op.Predicate("c1", "<", 0.0),)),)
    with pytest.raises(NotImplementedError, match="slice 6"):
        _merge(schema, rows_pipe, [])
    with pytest.raises(NotImplementedError, match="slice 6"):
        _merge(schema, rows_pipe, [CompiledPipeline(schema, rows_pipe)(
            parts[0], device="cpu")])


def test_merge_groups_device_matches_jax():
    from repro.core.offload import merge_groups_device as jax_mgd
    rng = np.random.default_rng(9)
    groups = []
    for m in (16, 8):
        bk = rng.integers(0, 12, m).astype(np.int32)
        bk[0] = jref.KEY_SENTINEL
        bk[1] = _DROP_KEY
        ovf = rng.integers(0, 12, 5).astype(np.int32)
        ovf[0] = _DROP_KEY
        groups.append(dict(
            bucket_keys=bk, count=rng.integers(0, 5, m).astype(np.int32),
            sum=_values(rng, m, 2, True, specials=0.0),
            min=_values(rng, m, 2, False), max=_values(rng, m, 2, False),
            ovf_keys=ovf, ovf_vals=_values(rng, 5, 2, True)))
    got = merge_groups_device([{f: (_t(x) if f in ("bucket_keys", "count",
                                                   "sum", "min", "max")
                                    else x) for f, x in g.items()}
                               for g in groups], _DROP_KEY)
    exp = jax_mgd([{f: jnp.asarray(x) if f in ("bucket_keys", "count",
                                               "sum", "min", "max") else x
                    for f, x in g.items()} for g in groups], _DROP_KEY)
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k][0] == exp[k][0]
        for a, b in zip(got[k][1:], exp[k][1:]):
            assert_exact(a, np.asarray(b))


# ------------------------------------------------ the copied reference traps
def _group_one(pipeline, rows, n_valid=None):
    """One request through both pipelines' run_pages (n_valid masks)."""
    schema, jschema = _schemas()
    n = rows.shape[0]
    nv = n if n_valid is None else n_valid
    buf, lists = _pool([rows], seed=1)
    port = CompiledPipeline(schema, pipeline).run_pages(
        torch.from_numpy(buf), lists[0], nv, n_rows=n, row_words=N_COLS)
    ref = jax_compile(jschema, _to_jax(pipeline)).run_pages(
        jnp.asarray(buf), lists[0], nv, n_rows=n, row_words=N_COLS)
    return port, ref


def _trap_rows(n=64):
    t = np.zeros((n, N_COLS), np.float32)
    t[:, 0] = np.arange(n) % 4
    t[:, 1:] = 1.0
    return t


def test_trap_subnormals_flush_in_arithmetic():
    """1e-40 + 3e-40 -> 0.0; min(1e-40, 3e-40) -> 0.0; a group whose only
    value is -1e-40 reports +0.0 for sum, min and max."""
    t = _trap_rows()
    t[t[:, 0] == 0, 1] = np.float32(1e-40)
    t[(t[:, 0] == 0) & (np.arange(64) % 8 == 0), 1] = np.float32(3e-40)
    t[t[:, 0] == 1, 1] = np.float32(-1e-40)
    port, ref = _group_one((op.GroupBy("c0", ("c1",), n_buckets=8),), t)
    _same_result(port, ref)
    g = port.groups
    for key in (0, 1):
        b = int(np.flatnonzero(g["bucket_keys"].numpy() == key)[0])
        for f in ("sum", "min", "max"):
            assert g[f][b, 0].view(torch.int32) == 0     # +0.0


def test_trap_signed_zero_nan_and_inf():
    """{0.0, -0.0} -> min +0.0, max +0.0; {inf, -inf} -> sum NaN, min
    -inf, max inf; a NaN propagates through min and max."""
    t = _trap_rows()
    grp = t[:, 0]
    t[grp == 0, 1] = np.where(np.arange(16) % 2, -0.0, 0.0)
    t[grp == 1, 1] = np.where(np.arange(16) % 2, np.inf, -np.inf)
    t[grp == 2, 1] = np.where(np.arange(16) == 5, np.nan, 2.0)
    port, ref = _group_one((op.GroupBy("c0", ("c1",), n_buckets=8),), t)
    _same_result(port, ref)
    g = port.groups
    at = {int(k): i for i, k in enumerate(g["bucket_keys"].numpy())}
    assert g["min"][at[0], 0].view(torch.int32) == 0
    assert g["max"][at[0], 0].view(torch.int32) == 0
    assert torch.isnan(g["sum"][at[1], 0])
    assert g["min"][at[1], 0] == -np.inf and g["max"][at[1], 0] == np.inf
    assert torch.isnan(g["min"][at[2], 0]) and torch.isnan(g["max"][at[2], 0])


def test_trap_key_conversion_saturates():
    """rint(x) -> int32 as the reference converts: NaN -> 0, 1e10 and +inf
    -> INT32_MAX, -1e10 and -inf -> INT32_MIN, halves to even."""
    words = np.array([np.nan, 1e10, np.inf, -1e10, -np.inf, 2.5, 3.5, -0.5,
                      -2.5, 1e-40], np.float32)
    want = [0, 2**31 - 1, 2**31 - 1, -2**31, -2**31, 2, 4, 0, -2, 0]
    assert tref.rint_to_int32(_t(words)).tolist() == want
    t = _trap_rows(40)
    t[:, 0] = np.resize(words, 40)
    for pipe in ((op.GroupBy("c0", ("c1", "c2"), n_buckets=16),),
                 (op.Distinct(("c0",), n_buckets=4),)):
        port, ref = _group_one(pipe, t)
        _same_result(port, ref)
        keys = set(port.groups["bucket_keys"].tolist()) | set(
            port.groups["ovf_keys"].tolist())
        assert {2**31 - 1, 0} <= keys


def test_trap_dropped_rows_still_claim_buckets():
    """A row masked by the predicate or by n_valid carries _DROP_KEY; as
    the first row of its bucket it claims it and real keys there
    overflow."""
    nb = 8
    drop_bucket = int(tref.bucket_of(torch.tensor([_DROP_KEY]), nb))
    same = [k for k in range(200)
            if int(tref.bucket_of(torch.tensor([k]), nb)) == drop_bucket][:3]
    t = _trap_rows(32)
    t[:, 0] = same[0]
    t[1::2, 0] = same[1]
    t[0, 3] = 5.0                       # row 0 fails c3 < 1: dropped
    pipe = (op.Select((op.Predicate("c3", "<", 1.5),)),
            op.GroupBy("c0", ("c1",), n_buckets=nb))
    port, ref = _group_one(pipe, t)
    _same_result(port, ref)
    g = port.groups
    assert int(g["bucket_keys"][drop_bucket]) == _DROP_KEY
    assert len(g["ovf_keys"]) == 31     # every real row overflows
    # the n_valid tail claims too: rows past n_valid carry _DROP_KEY
    t[0, 3] = 1.0
    t[:8, 0] = same[2] + 1000           # other buckets for the head rows
    port, ref = _group_one(pipe[1:], t, n_valid=8)
    _same_result(port, ref)
    merged = merge_group_partials(_schemas()[0], pipe[1:], [port]).groups
    assert set(merged) == {same[2] + 1000}


def test_wrappers_refuse_bad_arguments():
    keys = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of 2"):
        thg.group_aggregate_plain(keys, torch.zeros((2, 4, 1)), 6)
    with pytest.raises(ValueError, match="values"):
        thg.group_aggregate_plain(keys, torch.zeros((2, 5, 1)), 8)
    with pytest.raises(ValueError, match="CUDA"):
        thg.group_aggregate(keys, torch.zeros((2, 4, 1)), 8)
    with pytest.raises(ValueError, match="CUDA"):
        thg.group_prep(torch.zeros((1, 4, 3)), 0, [1], np.zeros(3, np.int32),
                       np.zeros(3, np.float32),
                       torch.ones(1, dtype=torch.int32), _DROP_KEY)


@pytest.mark.parametrize("n_buckets,chunk", [(1, 16), (256, 16), (1024, 5),
                                             (2048, 2), (4096, 1),
                                             (8192, 0), (65536, 0)])
def test_direct_chunk_is_what_shared_memory_holds(n_buckets, chunk):
    """The direct path's value columns a pass: as many as a block's bucket
    tables hold in 227 KB of shared memory (12 bytes a bucket, 40 a bucket
    and column), at most 16; none past 4096 buckets (the sort path)."""
    assert thg.direct_chunk(n_buckets) == chunk
    if chunk:
        assert n_buckets * (12 + 40 * chunk) <= 232448
    if 0 < chunk < 16:
        assert n_buckets * (12 + 40 * (chunk + 1)) > 232448


@pytest.mark.parametrize("n_buckets", [1, 1024, 4096, 8192, 65536])
def test_group_aggregate_path_depends_on_n_buckets_alone(monkeypatch,
                                                         n_buckets):
    """The wrapper picks its path from the host integer n_buckets alone:
    the same path for any number of rows or value columns, any stack and
    any keys (one key, uniform, the drop key), with no look at a tensor's
    contents. Here on the CPU with the launch stubbed out."""
    calls = []
    monkeypatch.setattr(thg, "_check", lambda t, what: None)
    monkeypatch.setattr(thg._build, "lib", lambda src: None)
    for name in ("_direct", "_sorted"):
        monkeypatch.setattr(thg, name,
                            lambda lib, k, v, nb, ovf, name=name:
                            calls.append(name) or {})
    rng = np.random.default_rng(n_buckets)
    runs = 0
    for b, n, v in ((1, 1, 1), (3, 5000, 5), (2, 300, 6), (4, 70, 40)):
        for keys in (np.full((b, n), 7), rng.integers(0, 300, (b, n)),
                     np.full((b, n), _DROP_KEY)):
            thg.group_aggregate(_t(keys.astype(np.int32)),
                                _t(rng.normal(size=(b, n, v))
                                   .astype(np.float32)), n_buckets)
            runs += 1
    path = "_direct" if n_buckets <= 4096 else "_sorted"
    assert calls == [path] * runs
