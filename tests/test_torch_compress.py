"""The port's page codecs (`repro_torch.distributed.compress`) against the
JAX package's (`repro.distributed.compress`), on the CPU.

Word pages of every personality the reference's property tests draw
(dictionary-friendly, narrow delta spans, noise, floats with NaN and inf,
constants, mixed columns; empty and single-word pages; phases and column
counts 1..12): the port's PagePlan (descriptors, stream, CRC) is bitwise
the reference's, each package decodes the other's encoding to the same
words, and a frame-bounded encode of noise falls back to raw (None) in
both. Corrupt streams and descriptors raise the port's `PageCodecError`.
The block codec (string extents): bitwise equal encodings, cross-decode
both ways, and any flipped bit or truncation raises `PageCodecError`.
Inputs are drawn from seeded numpy generators, so nothing is written to a
test database.
"""
import numpy as np
import pytest

from repro.distributed import compress as jpc
from repro_torch.core.errors import FarviewError, PageCodecError
from repro_torch.distributed import compress as pc

KINDS = ("dict", "delta", "noise", "floats", "const", "mixed")
PLAN_FIELDS = ("n_words", "phase", "modes", "widths", "base", "dictoff",
               "bitoff", "dictlen", "stream", "crc")


def _page(kind: str, seed: int, n: int | None = None):
    """One logical page of u32 words with a chosen personality (the
    reference's property-test generator, drawn from numpy)."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 13))
    n = int(rng.integers(0, 4097)) if n is None else n
    phase = int(rng.integers(0, C))
    if kind == "dict":
        vocab = rng.integers(0, 2**32, int(rng.integers(1, 65)),
                             dtype=np.uint64).astype(np.uint32)
        words = vocab[rng.integers(0, vocab.size, n)]
    elif kind == "delta":
        lo = rng.integers(0, 2**31, dtype=np.uint64)
        span = int(rng.choice([1, 2, 255, 65536]))
        words = (lo + rng.integers(0, span, n, dtype=np.uint64)
                 ).astype(np.uint32)
    elif kind == "noise":
        words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    elif kind == "floats":
        f = rng.normal(size=n).astype(np.float32)
        if n:
            f[rng.integers(0, 2, n).astype(bool)] = np.float32(np.nan)
            f[0] = np.float32(np.inf)
        words = f.view(np.uint32)
    elif kind == "const":
        words = np.full((n,), rng.integers(0, 2**32, dtype=np.uint64),
                        np.uint32)
    else:       # mixed: per-column personalities
        words = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        cols = (phase + np.arange(n)) % C
        for c in range(C):
            m = cols == c
            if rng.integers(0, 2):
                words[m] = rng.integers(0, 7, int(m.sum()),
                                        dtype=np.uint64).astype(np.uint32)
    return words, C, phase


def _same_plan(plan, jplan):
    for f in PLAN_FIELDS:
        a, b = getattr(plan, f), getattr(jplan, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _to_ref(plan):
    return jpc.PagePlan(**{f: getattr(plan, f) for f in PLAN_FIELDS})


def _to_port(jplan):
    return pc.PagePlan(**{f: getattr(jplan, f) for f in PLAN_FIELDS})


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", KINDS)
def test_word_page_bitwise_and_cross_decode(kind, seed):
    words, C, phase = _page(kind, 1000 * KINDS.index(kind) + seed)
    plan = pc.encode_word_page(words, C, phase=phase)
    jplan = jpc.encode_word_page(words, C, phase=phase)
    _same_plan(plan, jplan)
    np.testing.assert_array_equal(pc.decode_word_page(plan, C), words)
    np.testing.assert_array_equal(pc.decode_word_page(_to_port(jplan), C),
                                  words)
    np.testing.assert_array_equal(jpc.decode_word_page(_to_ref(plan), C),
                                  words)


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_empty_and_single_word_pages(n, C):
    words = np.random.default_rng(C).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    plan = pc.encode_word_page(words, C)
    _same_plan(plan, jpc.encode_word_page(words, C))
    assert plan.n_words == n
    np.testing.assert_array_equal(pc.decode_word_page(plan, C), words)
    np.testing.assert_array_equal(jpc.decode_word_page(_to_ref(plan), C),
                                  words)


@pytest.mark.parametrize("C", [1, 5, 8])
def test_incompressible_page_falls_back_to_raw(C):
    rng = np.random.default_rng(C)
    words = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    assert pc.encode_word_page(words, C, page_words=2048) is None
    assert jpc.encode_word_page(words, C, page_words=2048) is None
    # the unbounded encode still roundtrips (width-32 verbatim planes)
    plan = pc.encode_word_page(words, C)
    _same_plan(plan, jpc.encode_word_page(words, C))
    np.testing.assert_array_equal(pc.decode_word_page(plan, C), words)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ("dict", "delta", "floats", "mixed"))
def test_corrupt_stream_raises_typed_error(kind, seed):
    words, C, phase = _page(kind, 77 + seed, n=600)
    plan = pc.encode_word_page(words, C, phase=phase)
    rng = np.random.default_rng(seed)
    plan.stream = plan.stream.copy()
    plan.stream[int(rng.integers(0, plan.stream.shape[0]))] ^= np.uint32(
        1 << int(rng.integers(0, 32)))
    with pytest.raises(PageCodecError):
        pc.decode_word_page(plan, C)
    assert issubclass(PageCodecError, FarviewError)


@pytest.mark.parametrize("field", ["widths", "bitoff", "base", "modes",
                                   "n_words"])
def test_corrupt_descriptor_raises_typed_error(field):
    words, C, phase = _page("mixed", 5, n=900)
    plan = pc.encode_word_page(words, C, phase=phase)
    if field == "n_words":
        plan.n_words += 1
    else:
        arr = getattr(plan, field).copy()
        arr[0] += 1
        setattr(plan, field, arr)
    with pytest.raises(PageCodecError):
        pc.decode_word_page(plan, C)


def _blob(kind: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, int(rng.integers(0, 5000)),
                            dtype=np.uint8).tobytes()
    if kind == "padded":            # text + zero tails: zero-strip regime
        n, w = int(rng.integers(1, 65)), int(rng.integers(2, 65))
        text = rng.integers(97, 123, (n, w // 2), dtype=np.uint8)
        return np.concatenate([text, np.zeros((n, w - w // 2), np.uint8)],
                              axis=1).tobytes()
    if kind == "runs":              # long runs: RLE regime
        unit = rng.integers(0, 256, int(rng.integers(1, 9)),
                            dtype=np.uint8).tobytes()
        return unit * int(rng.integers(1, 3000))
    return b""


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ("random", "padded", "runs", "empty"))
def test_block_codec_bitwise_and_cross_decode(kind, seed):
    data = _blob(kind, seed)
    enc = pc.encode_blocks(data)
    assert enc == jpc.encode_blocks(data)
    assert pc.decode_blocks(enc) == data
    assert pc.decode_blocks(jpc.encode_blocks(data)) == data
    assert jpc.decode_blocks(enc) == data


@pytest.mark.parametrize("seed", range(4))
def test_block_codec_corruption_raises(seed):
    rng = np.random.default_rng(seed)
    data = _blob(("random", "padded", "runs", "random")[seed], seed + 10)
    data = data or b"x"
    enc = bytearray(pc.encode_blocks(data))
    enc[int(rng.integers(0, len(enc)))] ^= 1 << int(rng.integers(0, 8))
    with pytest.raises(PageCodecError):
        pc.decode_blocks(bytes(enc))


@pytest.mark.parametrize("cut", [1, 4, 17, 100])
def test_block_codec_truncation_raises(cut):
    enc = pc.encode_blocks(_blob("padded", cut))
    with pytest.raises(PageCodecError):
        pc.decode_blocks(enc[:max(0, len(enc) - cut)])
