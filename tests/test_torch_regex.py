"""The port's regex verb against the JAX package, on the CPU.

- `compile_regex`: the port's copy gives byte-identical tables and accept
  vectors, and the same errors, for a list of patterns and (with
  hypothesis) for patterns drawn from a small grammar;
- `ref.dfa_match` / `dfa_match_plain` / `ops.regex_match` of the port
  against the JAX `ref.dfa_match`, the Pallas kernel in interpret mode and
  Python's `re.search`, bit for bit, over lengths of 0, below 0 and above
  the width, and bytes 0 and >= 128;
- the node end to end: the JAX FViewNode and the port's
  `FViewNode(device="cpu")` on the same strings, solo and stacked rounds
  (one dispatch; mask, shipped = rows, read = rows x width), a post-Crypt
  (ignored by the regex branch in both), and a round mixed with a word
  verb;
- both pipelines' string entry points (row ids too), and the port's
  refusals.

The strings are made from numpy seeds; widths <= 128, <= 2048 strings.
"""
import re

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
from repro.core.regex import compile_regex as jcompile
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.core.table import string_table as jstring_table
from repro.kernels import ops as jops
from repro.kernels import ref as jref
import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.errors import FarviewError
from repro_torch.core.pipeline import CompiledPipeline, compile_pipeline
from repro_torch.core.regex import compile_regex
from repro_torch.kernels import dfa_match as tdfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

PATTERNS = ["err", "e(r|x)+[a-f]*r?", "abc", "ab+c", "a|b", "(ab)*c", "a.c",
            "[0-9]+", "[^a-y]z", r"\d\w\s", "a?b?c?d", "x(y|z)*q",
            "(a|e)....[xz]", "a....z", "", r"\.\*", r"[\]a]", "error"]
BAD_PATTERNS = ["(ab", "ab)", "a.....b", "[ab"]
# bytes the strings are drawn from: letters the patterns use, 0 and >= 128
ALPHABET = np.frombuffer(b"aeerrxzfbcq9 .*]\x00\x80\xff\xc3", np.uint8)
TOKENS = (b"err", b"exxfr", b"eaqrx", b"\x80z")
CAPACITY = 16 * 2**20
KEY_POST = ((0x12345678, 0x9ABCDEF0), 99)


def _strings(seed: int, n: int, w: int):
    """(n, w) bytes from ALPHABET with one of TOKENS planted in every other
    row (where it fits), lengths in [-3, w + 3] with 0, -1 and w + 3
    among them."""
    rng = np.random.default_rng(seed)
    mat = ALPHABET[rng.integers(0, ALPHABET.size, (n, w))]
    for i in range(0, n, 2):
        tok = TOKENS[rng.integers(0, len(TOKENS))]
        if len(tok) <= w:
            at = rng.integers(0, w - len(tok) + 1)
            mat[i, at: at + len(tok)] = np.frombuffer(tok, np.uint8)
    lens = rng.integers(-3, w + 4, n).astype(np.int32)
    lens[:3] = (0, -1, w + 3)[:n]
    return mat, lens


def _python(pattern: str, mat, lens) -> list[bool]:
    """The independent oracle: re.search over each row's consumed bytes."""
    pat = re.compile(pattern.encode(), re.DOTALL)
    w = mat.shape[1]
    return [bool(pat.search(bytes(row[: min(max(int(n), 0), w)])))
            for row, n in zip(mat, lens)]


# ------------------------------------------------------------ compile_regex
@pytest.mark.parametrize("pattern", PATTERNS)
def test_compile_regex_is_the_reference_copy(pattern):
    table, accept = compile_regex(pattern)
    jtable, jaccept = jcompile(pattern)
    assert table.dtype == jtable.dtype and accept.dtype == jaccept.dtype
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_array_equal(accept, jaccept)
    t2, a2 = compile_regex(pattern, search=False, max_states=200)
    j2, ja2 = jcompile(pattern, search=False, max_states=200)
    np.testing.assert_array_equal(t2, j2)
    np.testing.assert_array_equal(a2, ja2)


@pytest.mark.parametrize("pattern", BAD_PATTERNS)
def test_compile_regex_raises_as_the_reference(pattern):
    with pytest.raises(Exception) as jerr:
        jcompile(pattern)
    with pytest.raises(type(jerr.value)) as err:
        compile_regex(pattern)
    assert str(err.value) == str(jerr.value)
    if pattern == "a.....b":
        assert "DFA exceeds max_states=64" in str(err.value)


if HAVE_HYPOTHESIS:
    _ATOMS = st.sampled_from(["a", "b", "c", "x", ".", "[ab]", "[^c]",
                              r"\d"])
    _REGEX = st.recursive(_ATOMS, lambda inner: st.one_of(
        st.tuples(inner, inner).map("".join),
        st.tuples(inner, inner).map("|".join),
        inner.map(lambda r: f"({r})*"),
        inner.map(lambda r: f"({r})+"),
        inner.map(lambda r: f"({r})?")), max_leaves=6)

    @settings(deadline=None, max_examples=40)
    @given(pattern=_REGEX, seed=st.integers(0, 2**31 - 1))
    def test_compile_and_match_property(pattern, seed):
        """The copy compiles any pattern of the grammar to the reference's
        tables (or the same error), and its DFA matches as re.search."""
        try:
            jt, ja = jcompile(pattern)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                compile_regex(pattern)
            return
        t, a = compile_regex(pattern)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(a, ja)
        mat, lens = _strings(seed, 64, 12)
        got = tref.dfa_match(torch.from_numpy(mat), torch.from_numpy(lens),
                             torch.from_numpy(t), torch.from_numpy(a))
        assert got.tolist() == _python(pattern, mat, lens)
else:
    @pytest.mark.skip(reason="optional dep: pip install hypothesis")
    def test_compile_and_match_property():
        pass


# --------------------------------------------------------------- dfa_match
@pytest.mark.parametrize("pattern", ["err", "e(r|x)+[a-f]*r?",
                                     "(a|e)....[xz]", "[^a-y]z"])
@pytest.mark.parametrize("width", [1, 16, 17, 40, 128])
def test_dfa_match_against_jax_pallas_and_python(pattern, width):
    table, accept = compile_regex(pattern)
    mat, lens = _strings(width * 7 + len(pattern), 300, width)
    got = tref.dfa_match(torch.from_numpy(mat), torch.from_numpy(lens),
                         torch.from_numpy(table), torch.from_numpy(accept))
    args = (jnp.asarray(mat), jnp.asarray(lens), jnp.asarray(table),
            jnp.asarray(accept))
    jax_ref = np.asarray(jref.dfa_match(*args))
    pallas = np.asarray(jops.regex_match(*args, interpret=True))
    python = _python(pattern, mat, lens)
    assert got.dtype == torch.bool
    assert got.tolist() == jax_ref.tolist() == pallas.tolist() == python
    if width >= 16:
        assert 0 < sum(python) < len(python)
    # the port's op entry: host DFA in, the same mask out
    via_ops = tops.regex_match(torch.from_numpy(mat), torch.from_numpy(lens),
                               table, accept)
    assert via_ops.tolist() == python


@pytest.mark.parametrize("w", [16, 17, 128])
def test_stacked_plain_version_masks_past_n_valid(w):
    """dfa_match_plain over a (B, n, w) stack = each request's reference
    mask, False at and past n_valid[b] (0, ragged and more than n)."""
    table, accept = compile_regex("e(r|x)+[a-f]*r?")
    n = 257
    mats, lens = zip(*(_strings(i + w, n, w) for i in range(3)))
    strings = torch.from_numpy(np.stack(mats))
    lengths = torch.from_numpy(np.stack(lens))
    t, a = tdfa.prepare_dfa(table, accept, "cpu")
    for nv in ((n, 100, 0), (n + 5, n, 1)):
        n_valid = torch.tensor(nv, dtype=torch.int32)
        got = tdfa.dfa_match_plain(strings, lengths, n_valid, t, a)
        via_ops = tops.regex_match(strings, lengths, t, a, n_valid)
        assert torch.equal(got, via_ops)
        for b in range(3):
            exp = np.array(jref.dfa_match(
                jnp.asarray(mats[b]), jnp.asarray(lens[b]),
                jnp.asarray(table), jnp.asarray(accept)))
            exp[min(nv[b], n):] = False
            assert got[b].tolist() == exp.tolist()


def test_dfa_tables_are_checked_before_upload():
    table, accept = compile_regex("err")
    with pytest.raises(ValueError, match="outside"):
        tdfa.prepare_dfa(np.where(table == 3, 4, table), accept, "cpu")
    with pytest.raises(ValueError, match="256"):
        tdfa.prepare_dfa(table[:, :255], accept, "cpu")
    with pytest.raises(ValueError, match="accept"):
        tdfa.prepare_dfa(table, accept[:2], "cpu")
    t, a = tdfa.prepare_dfa(table, accept, "cpu")
    s = torch.zeros((1, 4, 8), dtype=torch.uint8)
    ln = torch.zeros((1, 4), dtype=torch.int32)
    nv = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tdfa.dfa_match_plain(s, ln.long(), nv, t, a)
    with pytest.raises(ValueError, match="uint8"):
        tdfa.dfa_match_plain(s.int(), ln, nv, t, a)
    with pytest.raises(ValueError, match="CUDA"):
        tdfa.dfa_match(s, ln, nv, t, a)


# ---------------------------------------------------------------- pipelines
def _schemas(width):
    return (fv.FTable("s", (fv.Column("bytes", "str"),), str_width=width),
            JFTable("s", (JColumn("bytes", "str"),), str_width=width))


@pytest.mark.parametrize("post", [False, True], ids=["regex", "regex_post"])
def test_pipeline_entry_points_match_jax(post):
    """__call__ and run_strings_batched of both pipelines on the same
    inputs: masks, shipped and read bytes (widths= keeps reads exact)."""
    schema, jschema = _schemas(40)
    pipe = (op.RegexMatch("e(r|x)+[a-f]*r?"),)
    jpipe = (jop.RegexMatch("e(r|x)+[a-f]*r?"),)
    if post:
        pipe += (op.Crypt(*KEY_POST, "post"),)
        jpipe += (jop.Crypt(*KEY_POST, "post"),)
    tp, jp = compile_pipeline(schema, pipe), jax_compile(jschema, jpipe)
    assert tp.kind == jp.kind == "mask"
    mat, lens = _strings(3, 500, 40)
    lens = np.minimum(lens, 40)
    got = tp(mat, lengths=lens, device="cpu").finalize()
    exp = jp(jnp.asarray(mat), jnp.asarray(lens)).finalize()
    assert got.mask.tolist() == np.asarray(exp.mask).tolist()
    assert (got.shipped_bytes, got.read_bytes) == (exp.shipped_bytes,
                                                   exp.read_bytes) == (500,
                                                                       20000)
    assert got.count is None and exp.count is None
    # a stacked round of three requests padded to (512, 40): own widths
    # 40, 33 and 21 (their tails zero), own rows 500, 300 and 17
    stacked = np.zeros((3, 512, 40), np.uint8)
    lengths = np.zeros((3, 512), np.int32)
    for b, (n, w) in enumerate([(500, 40), (300, 33), (17, 21)]):
        m, ln = _strings(10 + b, n, w)
        stacked[b, :n, :w] = m
        lengths[b, :n] = np.minimum(ln, w)
    nv, widths = [500, 300, 17], [40, 33, 21]
    got = tp.run_strings_batched(torch.from_numpy(stacked),
                                 torch.from_numpy(lengths), nv,
                                 widths=widths, device="cpu")
    exp = jp.run_strings_batched(stacked, lengths, nv, widths=widths)
    for g, e, n, w in zip(got, exp, nv, widths):
        g.finalize()
        assert g.mask.tolist() == np.asarray(e.mask).tolist()
        assert (g.shipped_bytes, g.read_bytes) == (e.shipped_bytes,
                                                   e.read_bytes) == (n, n * w)


def test_string_entry_points_refuse_what_is_not_ported():
    """Row ids on a string request run as in the JAX pipeline (they key
    only a pre-Crypt, so the mask is the one without them); a request
    without lengths, the pool entry points and a call without a card
    are refused."""
    schema, jschema = _schemas(16)
    pipe = CompiledPipeline(schema, (op.RegexMatch("err"),))
    mat, lens = _strings(0, 8, 16)
    got = pipe(mat, np.arange(8) * 3, lengths=lens, device="cpu").finalize()
    exp = jax_compile(jschema, (jop.RegexMatch("err"),))(
        jnp.asarray(mat), jnp.asarray(lens), row_ids=np.arange(8) * 3)
    assert got.mask.tolist() == np.asarray(exp.mask).tolist() == _python(
        "err", mat, lens)
    assert (got.shipped_bytes, got.read_bytes, got.sel_ids) == (
        exp.shipped_bytes, exp.read_bytes, None) == (8, 128, None)
    with pytest.raises(ValueError, match="lengths"):
        pipe(mat, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        pipe.run_pages(torch.zeros((2, 16)), [0], 8, n_rows=8, row_words=4)
    if not torch.cuda.is_available():
        with pytest.raises(FarviewError, match="CUDA"):
            pipe(mat, lengths=lens)


# --------------------------------------------------------------------- nodes
STRS = [b"error: disk full", b"all fine", b"ERROR", b"warn: error", b"errr",
        b"the error is late here", b"\xff\x00error\x80", b""]


def _requests(seed: int, n: int, w: int):
    rng = np.random.default_rng(seed)
    strs = [STRS[j] for j in rng.integers(0, len(STRS), n)]
    return jstring_table(f"s{seed}", strs, w), strs


def _run_both(rounds, pipe, jpipe, extra=None):
    """Each round is a list of (n, w) requests, one QPair each; both nodes
    flush once per round. Returns [(jax, port) result pairs], the
    dispatches of each node and the QPairs' byte counters."""
    jnode = jfv.FViewNode(CAPACITY, n_regions=4)
    tnode = fv.FViewNode(CAPACITY, n_regions=4, device="cpu")
    jqps = [jfv.open_connection(jnode) for _ in range(4)]
    tqps = [fv.open_connection(tnode) for _ in range(4)]
    out = []
    for r, reqs in enumerate(rounds):
        pend = []
        for i, (n, w) in enumerate(reqs):
            (jft, mat, lens), strs = _requests(r * 10 + i, n, w)
            tft = fv.FTable(jft.name, (fv.Column("bytes", "str"),),
                            n_rows=n, str_width=w)
            pend.append((
                jfv.submit_request(jqps[i], jft, jpipe, strings=mat,
                                   lengths=lens),
                fv.submit_request(tqps[i], tft, pipe, strings=mat,
                                  lengths=lens), strs, w))
        if extra is not None:
            pend.append(extra(jnode, tnode, jqps[3], tqps[3]))
        before = (jnode.dispatches, tnode.dispatches)
        jnode.flush()
        tnode.flush()
        out.append(([(j.wait(), t.wait(), strs, w)
                     for j, t, strs, w in pend],
                    jnode.dispatches - before[0],
                    tnode.dispatches - before[1]))
    counters = ([(q.bytes_read_pool, q.bytes_shipped) for q in jqps],
                [(q.bytes_read_pool, q.bytes_shipped) for q in tqps])
    return out, counters


@pytest.mark.parametrize("post", [False, True], ids=["regex", "regex_post"])
def test_node_rounds_match_the_jax_node(post):
    """Solo and stacked rounds (tests/test_bucket_batched.py's cases): one
    dispatch a round, the same masks as the JAX node and re.search, one
    shipped byte a row, read = rows x width. A post-Crypt is skipped by
    the regex branch in both packages."""
    pipe, jpipe = (op.RegexMatch("error"),), (jop.RegexMatch("error"),)
    if post:
        pipe += (op.Crypt(*KEY_POST, "post"),)
        jpipe += (jop.Crypt(*KEY_POST, "post"),)
    rounds = [[(100, 24)],                          # solo
              [(100, 24), (128, 32), (77, 17)],     # one 128 x 32 bucket
              [(2048, 128), (1500, 100), (1025, 65)]]
    out, counters = _run_both(rounds, pipe, jpipe)
    for results, jd, td in out:
        assert jd == td == 1
        for jres, tres, strs, w in results:
            expect = [bool(re.search(b"error", s[:w])) for s in strs]
            assert np.asarray(jres.mask).tolist() == expect
            assert tres.mask.tolist() == expect
            assert tres.count is None
            assert (tres.shipped_bytes, tres.read_bytes) == (
                jres.shipped_bytes, jres.read_bytes) == (len(strs),
                                                         len(strs) * w)
    assert counters[0] == counters[1]


def test_string_and_word_requests_share_a_flush():
    """A regex round and a word-table selection in one flush: two
    dispatches on both nodes, results equal."""
    words = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)

    def extra(jnode, tnode, jqp, tqp):
        cols = ("a", "b", "c")
        jft = jfv.alloc_table_mem(jqp, JFTable(
            "w", tuple(JColumn(c) for c in cols), n_rows=300))
        jfv.table_write(jqp, jft, words)
        tft = fv.alloc_table_mem(tqp, fv.FTable(
            "w", tuple(fv.Column(c) for c in cols), n_rows=300))
        fv.table_write(tqp, tft, words)
        sel = (op.Select((op.Predicate("b", "<", 0.0),)),)
        jsel = (jop.Select((jop.Predicate("b", "<", 0.0),)),)
        return (jfv.submit_request(jqp, jft, jsel),
                fv.submit_request(tqp, tft, sel), None, None)

    out, counters = _run_both([[(100, 24), (128, 32), (77, 17)]],
                              (op.RegexMatch("err"),),
                              (jop.RegexMatch("err"),), extra=extra)
    results, jd, td = out[0]
    assert jd == td == 2
    for jres, tres, strs, w in results:
        if strs is None:
            assert tres.count == jres.count > 0
            assert tres.shipped_bytes == jres.shipped_bytes
            assert torch.equal(tres.rows.view(torch.int32), torch.from_numpy(
                np.array(jres.rows).view(np.int32)))
        else:
            assert tres.mask.tolist() == np.asarray(jres.mask).tolist()
    assert counters[0] == counters[1]


def test_stacked_round_never_consumes_a_neighbours_padding():
    """A recorded divergence (ROADMAP.md queue 3): in a round whose width
    is padded, the JAX node lets a length above the request's own width
    consume the zero padding, so its stacked answer differs from its solo
    one; the port cuts the length to the request's width, and its stacked
    answer equals both packages' solo answer."""
    pipe, jpipe = (op.RegexMatch("a."),), (jop.RegexMatch("a."),)
    row = np.frombuffer(b"xxxxxxxxxxxa", np.uint8)[None].copy()  # width 12
    lens = np.array([14], np.int32)                             # > width
    other = np.zeros((1, 16), np.uint8)                         # width 16
    answers = {}
    for name, node, mod, p in (
            ("jax", jfv.FViewNode(CAPACITY, n_regions=2), jfv, jpipe),
            ("port", fv.FViewNode(CAPACITY, n_regions=2, device="cpu"), fv,
             pipe)):
        qps = [mod.open_connection(node) for _ in range(2)]
        ft = (JFTable if name == "jax" else fv.FTable)(
            "s", ((JColumn if name == "jax" else fv.Column)("bytes", "str"),),
            n_rows=1, str_width=12)
        solo = mod.farview_request(qps[0], ft, p, strings=row, lengths=lens)
        reqs = [mod.submit_request(qps[0], ft, p, strings=row, lengths=lens),
                mod.submit_request(qps[1], ft, p, strings=other,
                                   lengths=np.array([16], np.int32))]
        before = node.dispatches
        node.flush()
        assert node.dispatches == before + 1
        answers[name] = (bool(np.asarray(solo.mask)[0]),
                         bool(np.asarray(reqs[0].wait().mask)[0]))
    assert answers["jax"] == (False, True)
    assert answers["port"] == (False, False)


def test_submit_checks_the_string_sideband():
    """The sideband's checks, and the row ids and pre-Crypt it carries
    run as on the JAX node (same masks and bytes)."""
    node = fv.FViewNode(CAPACITY, n_regions=2, device="cpu")
    qp = fv.open_connection(node)
    jnode = jfv.FViewNode(CAPACITY, n_regions=2)
    jqp = jfv.open_connection(jnode)
    (jft, mat, lens), _ = _requests(0, 8, 16)
    sft = fv.FTable("s", (fv.Column("bytes", "str"),), 8, str_width=16)
    word = fv.alloc_table_mem(qp, fv.FTable("w", (fv.Column("a"),), 8))
    rx, jrx = (op.RegexMatch("err"),), (jop.RegexMatch("err"),)
    with pytest.raises(ValueError, match="word table"):
        fv.submit_request(qp, word, rx, strings=mat, lengths=lens)
    with pytest.raises(ValueError, match="strings= and lengths="):
        fv.submit_request(qp, sft, rx)
    with pytest.raises(ValueError, match="lengths"):
        fv.submit_request(qp, sft, rx, strings=mat, lengths=lens[:3])
    with pytest.raises(ValueError, match="one id a row"):
        fv.submit_request(qp, sft, rx, strings=mat, lengths=lens,
                          row_ids=np.arange(7))
    pend = fv.submit_request(qp, sft, rx, strings=mat, lengths=lens,
                             row_ids=np.arange(8) + 40)
    jpend = jfv.submit_request(jqp, jft, jrx, strings=mat, lengths=lens,
                               row_ids=np.arange(8) + 40)
    node.flush()
    jnode.flush()
    assert pend.wait().mask.tolist() == np.asarray(
        jpend.wait().mask).tolist() == _python("err", mat, lens)
    # the same bytes read as ciphertext under a pre-Crypt: both packages
    # decipher them alike
    pre = (op.Crypt((1, 2), 3, "pre"),) + rx
    res = fv.farview_request(qp, sft, pre, strings=mat, lengths=lens)
    jres = jfv.farview_request(jqp, jft, (jop.Crypt((1, 2), 3, "pre"),) + jrx,
                               strings=mat, lengths=lens)
    assert res.mask.tolist() == np.asarray(jres.mask).tolist()
    assert (res.shipped_bytes, res.read_bytes) == (
        jres.shipped_bytes, jres.read_bytes) == (8, 128)
    res = fv.farview_request(qp, sft, rx, strings=mat, lengths=lens)
    assert res.mask.tolist() == _python("err", mat, lens)
    assert (res.shipped_bytes, res.read_bytes) == (8, 128)
