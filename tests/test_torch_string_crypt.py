"""The byte cipher on string tables (a pre-Crypt before RegexMatch) and
partitioned string requests (row_ids), the port against the JAX package on
the CPU.

- the port's plain byte cipher (`ref.ctr_crypt_bytes`,
  `ctr_crypt.ctr_crypt_bytes_plain`, `ops.crypt_bytes`) against the JAX
  `ref.ctr_crypt` over the bytes widened to uint32 words, cut back to
  uint8: widths 1, 7, 16, 40 and 64, odd row counts, row ids whose
  row_id * w passes 2^31 and 2^32, and involution;
- `CompiledPipeline.__call__` and `run_strings_batched`, with and without
  row ids and a pre-Crypt, against the JAX `compile_pipeline`'s;
- node rounds against the JAX node: a solo request, three stacked
  requests of one width and mixed rows (one dispatch), widths 24 and 32
  (two dispatches: a pre-Crypt pins the width), one encrypted table split
  into 3 partitions by a seeded permutation and submitted with its row
  ids, with and without the pre-Crypt (each partition's mask the JAX
  node's, the masks scattered back by row id the unpartitioned solo
  mask), and a pre-Crypt string request flushed beside a word request.

Everything is integer, so masks and shipped and read bytes are compared
exactly. The strings, row ids and permutations come from numpy seeds.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jfv
from repro.core import operators as jop
from repro.core.pipeline import compile_pipeline as jax_compile
from repro.core.table import Column as JColumn
from repro.core.table import FTable as JFTable
from repro.core.table import string_table as jstring_table
from repro.kernels import ref as jref
import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.core.pipeline import compile_pipeline
from repro_torch.kernels import ctr_crypt as tctr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

KEY, NONCE = (0x0BADF00D, 0x5EED5EED), 1234
CAPACITY = 16 * 2**20
STRS = [b"error: disk full", b"all fine", b"ERROR", b"warn: error", b"errr",
        b"the error is late here", b"\xff\x00error\x80", b""]


def _jax_cipher(mat: np.ndarray, row_ids=None) -> np.ndarray:
    """The JAX package's pre-decrypt of one (n, w) request, and so (the
    cipher is involutive) its bytes as stored: the bytes widened to
    uint32, `ref.ctr_crypt` at positions i (or row_id * w + col in
    uint32), cut back to uint8."""
    n, w = mat.shape
    idx = None
    if row_ids is not None:
        idx = jnp.asarray((np.asarray(row_ids, np.int32).astype(np.uint32)
                           [:, None] * np.uint32(w)
                           + np.arange(w, dtype=np.uint32)).reshape(-1))
    out = jref.ctr_crypt(jnp.asarray(mat.reshape(-1).astype(np.uint32)),
                         jnp.asarray(np.asarray(KEY, np.uint32)), NONCE,
                         idx=idx)
    return np.asarray(out).astype(np.uint8).reshape(n, w)


def _wrapping_ids(rng, b: int, n: int, w: int) -> np.ndarray:
    """(b, n) int32 row ids whose row_id * w (uint32) lands just below and
    past 2^31 and, where w > 1, 2^32, with negative ids (uint32 values past
    2^31) among them."""
    near = [2**31 // w, min(2**32 // w, 2**31 - 1), 2**31 - 1]
    pool = np.concatenate([c + np.arange(-n, n) for c in near]
                          + [-1 - np.arange(n)])
    # one id of each kind first, so that even three rows cross both
    first = [2**31 // w - 1, min(2**32 // w + 1, 2**31 - 1), -1]
    ids = np.concatenate([first, rng.choice(pool, b * n)])[: b * n]
    return ids.reshape(b, n).astype(np.int64).astype(np.int32)


# ------------------------------------------------------------- byte cipher
@pytest.mark.parametrize("ids", ["stream", "row_ids", "wrapping_row_ids"])
@pytest.mark.parametrize("n", [1, 13, 101])
@pytest.mark.parametrize("w", [1, 7, 16, 40, 64])
def test_plain_byte_cipher_matches_jax(w, n, ids):
    rng = np.random.default_rng(w * 1000 + n)
    b = 3
    mat = rng.integers(0, 256, (b, n, w), dtype=np.uint8)
    row_ids = None
    if ids == "row_ids":
        row_ids = rng.permutation(4 * b * n)[: b * n].reshape(b, n)
    elif ids == "wrapping_row_ids":
        row_ids = _wrapping_ids(rng, b, n, w)
        pos = (row_ids.astype(np.uint32).astype(np.int64) * w)[..., None] \
            + np.arange(w)
        assert (pos >= 2**31).any() and (pos < 2**31).any()
        assert (pos >= 2**32).any() or w == 1
    data = torch.from_numpy(mat.reshape(b, n * w))
    tids = None if row_ids is None else torch.from_numpy(
        row_ids.astype(np.int32))
    got = tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, tids, w)
    assert got.dtype == torch.uint8 and got.shape == data.shape
    for i in range(b):
        exp = _jax_cipher(mat[i], None if row_ids is None else row_ids[i])
        np.testing.assert_array_equal(got[i].numpy().reshape(n, w), exp)
    # the op entry on the CPU is the plain version; the cipher is involutive
    assert torch.equal(tops.crypt_bytes(data, KEY, NONCE, tids, w), got)
    assert torch.equal(tctr.ctr_crypt_bytes_plain(got, KEY, NONCE, tids, w),
                       data)
    assert not torch.equal(got, data)


def test_ref_byte_cipher_is_the_low_byte_of_the_word_cipher():
    """ref.ctr_crypt_bytes at explicit positions (past 2^32 too: taken
    mod 2^32) = the low byte of ref.ctr_crypt over the widened bytes, and
    of the JAX ref."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 999, dtype=np.uint8)
    pos = rng.integers(0, 2**34, 999)
    got = tref.ctr_crypt_bytes(torch.from_numpy(data), KEY, NONCE,
                               idx=torch.from_numpy(pos))
    words = tref.ctr_crypt(torch.from_numpy(data.astype(np.int32)), KEY,
                           NONCE, idx=torch.from_numpy(pos))
    assert torch.equal(got, (words & 0xFF).to(torch.uint8))
    exp = jref.ctr_crypt(jnp.asarray(data.astype(np.uint32)),
                         jnp.asarray(np.asarray(KEY, np.uint32)), NONCE,
                         idx=jnp.asarray((pos % 2**32).astype(np.uint32)))
    assert got.numpy().tolist() == np.asarray(exp).astype(np.uint8).tolist()


def test_byte_cipher_checks_its_arguments():
    data = torch.zeros((2, 12), dtype=torch.uint8)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        tctr.ctr_crypt_bytes_plain(data.int(), KEY, NONCE)
    with pytest.raises(ValueError, match="uint8"):
        tctr.ctr_crypt_bytes_plain(data[0], KEY, NONCE)
    with pytest.raises(ValueError, match="width"):
        tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, ids)
    with pytest.raises(ValueError, match="width"):
        tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, ids, 5)
    with pytest.raises(ValueError, match="one id a row"):
        tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, ids, 6)
    with pytest.raises(ValueError, match="one id a row"):
        tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, ids.long(), 4)
    assert tctr.ctr_crypt_bytes_plain(data, KEY, NONCE, ids,
                                      4).shape == (2, 12)
    # the launching wrappers take CUDA tensors only, and share the check
    with pytest.raises(ValueError, match="CUDA"):
        tctr.ctr_crypt_bytes(data, KEY, NONCE)
    with pytest.raises(ValueError, match="CUDA"):
        tctr.ctr_crypt(data.int(), KEY, NONCE)


# ---------------------------------------------------------------- pipelines
def _schemas(width):
    return (fv.FTable("s", (fv.Column("bytes", "str"),), str_width=width),
            JFTable("s", (JColumn("bytes", "str"),), str_width=width))


def _pipes(pre: bool):
    pipe, jpipe = (op.RegexMatch("error"),), (jop.RegexMatch("error"),)
    if pre:
        pipe = (op.Crypt(KEY, NONCE, "pre"),) + pipe
        jpipe = (jop.Crypt(KEY, NONCE, "pre"),) + jpipe
    return pipe, jpipe


def _strings(seed: int, n: int, w: int):
    """(n, w) bytes of STRS rows (cut to w) and their lengths."""
    rng = np.random.default_rng(seed)
    strs = [STRS[j] for j in rng.integers(0, len(STRS), n)]
    _, mat, lens = jstring_table(f"s{seed}", strs, w)
    return np.asarray(mat, np.uint8), np.asarray(lens, np.int32), strs


@pytest.mark.parametrize("ids", [False, True], ids=["solo", "row_ids"])
@pytest.mark.parametrize("pre", [False, True], ids=["clear", "pre_crypt"])
def test_pipeline_entry_points_match_jax(pre, ids):
    """__call__ and run_strings_batched of both pipelines on the same
    encrypted (or clear) bytes and row ids: masks, shipped and read
    bytes."""
    w = 40
    schema, jschema = _schemas(w)
    pipe, jpipe = _pipes(pre)
    tp, jp = compile_pipeline(schema, pipe), jax_compile(jschema, jpipe)
    assert tp.kind == jp.kind == "mask"
    rng = np.random.default_rng(5)
    mat, lens, strs = _strings(3, 301, w)
    row_ids = rng.permutation(4000)[:301] if ids else None
    data = _jax_cipher(mat, row_ids) if pre else mat
    got = tp(data, row_ids, lengths=lens, device="cpu").finalize()
    exp = jp(jnp.asarray(data), jnp.asarray(lens), row_ids=row_ids).finalize()
    expect = [bool(re.search(b"error", s[:w])) for s in strs]
    assert got.mask.tolist() == np.asarray(exp.mask).tolist() == expect
    assert (got.shipped_bytes, got.read_bytes) == (
        exp.shipped_bytes, exp.read_bytes) == (301, 301 * w)
    assert got.count is None and got.sel_ids is None
    # a stacked round of three requests of width 40 padded to 512 rows:
    # own rows 500, 300 and 17, row ids zero in the padding
    nv = [500, 300, 17]
    stacked = np.zeros((3, 512, w), np.uint8)
    lengths = np.zeros((3, 512), np.int32)
    stack_ids = np.zeros((3, 512), np.int32) if ids else None
    expects = []
    for b, n in enumerate(nv):
        m, ln, s = _strings(10 + b, n, w)
        rid = rng.permutation(2**20)[:n] if ids else None
        stacked[b, :n] = _jax_cipher(m, rid) if pre else m
        lengths[b, :n] = ln
        if ids:
            stack_ids[b, :n] = rid
        expects.append([bool(re.search(b"error", x[:w])) for x in s])
    got = tp.run_strings_batched(torch.from_numpy(stacked),
                                 torch.from_numpy(lengths), nv,
                                 row_ids=stack_ids, device="cpu")
    exp = jp.run_strings_batched(stacked, lengths, nv, row_ids=stack_ids)
    for g, e, n, x in zip(got, exp, nv, expects):
        g.finalize()
        assert g.mask.tolist() == np.asarray(e.mask).tolist() == x
        assert (g.shipped_bytes, g.read_bytes) == (
            e.shipped_bytes, e.read_bytes) == (n, n * w)


def test_pipeline_leaves_the_callers_bytes_and_checks_row_ids():
    """The pre-decrypt writes a new stack (the caller's tensor keeps its
    ciphertext); row ids must be one a row; under a pre-Crypt a stacked
    request narrower than the stack is refused (its padded columns would
    shift the keystream)."""
    schema, _ = _schemas(16)
    pipe = compile_pipeline(schema, _pipes(True)[0])
    mat, lens, _ = _strings(0, 9, 16)
    enc = torch.from_numpy(_jax_cipher(mat))
    before = enc.clone()
    assert pipe(enc, lengths=lens, device="cpu").mask.any()
    assert torch.equal(enc, before)
    with pytest.raises(ValueError, match="one id a row"):
        pipe(enc, np.arange(8), lengths=lens, device="cpu")
    stack = enc[None].expand(2, 9, 16).contiguous()
    lengths = torch.from_numpy(np.stack([lens, lens]))
    with pytest.raises(ValueError, match="one id a row"):
        pipe.run_strings_batched(stack, lengths, [9, 9],
                                 row_ids=np.zeros((2, 8)), device="cpu")
    with pytest.raises(ValueError, match="exact"):
        pipe.run_strings_batched(stack, lengths, [9, 9], widths=[16, 12],
                                 device="cpu")


# --------------------------------------------------------------------- nodes
def _both_nodes(n_regions=4):
    jnode = jfv.FViewNode(CAPACITY, n_regions=n_regions)
    tnode = fv.FViewNode(CAPACITY, n_regions=n_regions, device="cpu")
    return ((jnode, [jfv.open_connection(jnode) for _ in range(n_regions)]),
            (tnode, [fv.open_connection(tnode) for _ in range(n_regions)]))


def _tables(name, n, w):
    return (JFTable(name, (JColumn("bytes", "str"),), n_rows=n, str_width=w),
            fv.FTable(name, (fv.Column("bytes", "str"),), n_rows=n,
                      str_width=w))


def _round(reqs, pipe, jpipe, extra=None):
    """Submit each (name, strings, lengths, row_ids) request on its own
    QPair of both nodes, flush once; returns [(jax, port) results], the
    dispatches of each node and the QPairs' byte counters."""
    (jnode, jqps), (tnode, tqps) = _both_nodes()
    pend = []
    for i, (name, mat, lens, rid) in enumerate(reqs):
        jft, tft = _tables(name, *mat.shape)
        pend.append((jfv.submit_request(jqps[i], jft, jpipe, strings=mat,
                                        lengths=lens, row_ids=rid),
                     fv.submit_request(tqps[i], tft, pipe, strings=mat,
                                       lengths=lens, row_ids=rid)))
    if extra is not None:
        pend.append(extra(jqps[3], tqps[3]))
    jnode.flush()
    tnode.flush()
    results = [(j.wait(), t.wait()) for j, t in pend]
    counters = ([(q.bytes_read_pool, q.bytes_shipped) for q in jqps],
                [(q.bytes_read_pool, q.bytes_shipped) for q in tqps])
    return results, (jnode.dispatches, tnode.dispatches), counters


def _same(jres, tres, n, w):
    assert tres.mask.tolist() == np.asarray(jres.mask).tolist()
    assert (tres.shipped_bytes, tres.read_bytes) == (
        jres.shipped_bytes, jres.read_bytes) == (n, n * w)


@pytest.mark.parametrize("sizes,dispatches", [
    ([(100, 24)], 1),                       # solo
    ([(60, 32), (64, 32), (41, 32)], 1),    # one width, mixed rows: stacked
    ([(50, 24), (50, 32)], 2),              # one width bucket: pinned apart
], ids=["solo", "stacked", "widths_24_32"])
def test_pre_crypt_rounds_match_the_jax_node(sizes, dispatches):
    pipe, jpipe = _pipes(True)
    reqs, expects = [], []
    for i, (n, w) in enumerate(sizes):
        mat, lens, strs = _strings(20 + i, n, w)
        reqs.append((f"s{i}", _jax_cipher(mat), lens, None))
        expects.append([bool(re.search(b"error", s[:w])) for s in strs])
    results, disp, counters = _round(reqs, pipe, jpipe)
    assert disp == (dispatches, dispatches)
    for (jres, tres), (_, mat, _, _), expect in zip(results, reqs, expects):
        _same(jres, tres, *mat.shape)
        assert tres.mask.tolist() == expect and any(expect)
    assert counters[0] == counters[1]


@pytest.mark.parametrize("pre", [False, True], ids=["clear", "pre_crypt"])
def test_partitions_with_row_ids_match_the_jax_node_and_the_table(pre):
    """One (encrypted) table of 203 strings split into 3 partitions by a
    seeded permutation, each submitted with its row ids: one stacked
    dispatch on each node, each partition's mask the JAX node's, and the
    masks scattered back by row id the unpartitioned solo mask."""
    pipe, jpipe = _pipes(pre)
    n, w = 203, 24
    mat, lens, strs = _strings(30, n, w)
    table = _jax_cipher(mat) if pre else mat
    (jnode, jqps), (tnode, tqps) = _both_nodes()
    jft, tft = _tables("t", n, w)
    solo_j = jfv.farview_request(jqps[0], jft, jpipe, strings=table,
                                 lengths=lens)
    solo_t = fv.farview_request(tqps[0], tft, pipe, strings=table,
                                lengths=lens)
    _same(solo_j, solo_t, n, w)
    expect = [bool(re.search(b"error", s[:w])) for s in strs]
    assert solo_t.mask.tolist() == expect
    parts = np.array_split(np.random.default_rng(31).permutation(n), 3)
    reqs = [(f"p{i}", table[p], lens[p], p) for i, p in enumerate(parts)]
    results, disp, counters = _round(reqs, pipe, jpipe)
    assert disp == (1, 1)
    scattered = np.zeros(n, bool)
    for (jres, tres), p in zip(results, parts):
        _same(jres, tres, len(p), w)
        scattered[p] = tres.mask.numpy()
    assert scattered.tolist() == expect
    assert counters[0] == counters[1]
    # the solo request of one partition runs through __call__'s row ids
    (jnode, jqps), (tnode, tqps) = _both_nodes()
    jft, tft = _tables("p0", len(parts[0]), w)
    solo_j = jfv.farview_request(jqps[0], jft, jpipe, strings=table[parts[0]],
                                 lengths=lens[parts[0]], row_ids=parts[0])
    solo_t = fv.farview_request(tqps[0], tft, pipe, strings=table[parts[0]],
                                lengths=lens[parts[0]], row_ids=parts[0])
    _same(solo_j, solo_t, len(parts[0]), w)
    assert solo_t.mask.tolist() == [expect[i] for i in parts[0]]


def test_pre_crypt_string_request_beside_a_word_request():
    """A pre-Crypt regex round (two stacked string requests) and a
    word-table selection in one flush: two dispatches on both nodes,
    results equal."""
    words = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)

    def extra(jqp, tqp):
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
                fv.submit_request(tqp, tft, sel))

    pipe, jpipe = _pipes(True)
    reqs = []
    for i, n in enumerate((100, 77)):
        mat, lens, _ = _strings(40 + i, n, 32)
        reqs.append((f"s{i}", _jax_cipher(mat), lens, None))
    results, disp, counters = _round(reqs, pipe, jpipe, extra=extra)
    assert disp == (2, 2)
    for (jres, tres), (_, mat, _, _) in zip(results[:2], reqs):
        _same(jres, tres, *mat.shape)
    jres, tres = results[2]
    assert tres.count == jres.count > 0
    assert tres.shipped_bytes == jres.shipped_bytes
    assert torch.equal(tres.rows.view(torch.int32), torch.from_numpy(
        np.array(jres.rows).view(np.int32)))
    assert counters[0] == counters[1]
