"""Logical operator IR for Farview pipelines (paper §3.1, §5).

A copy of `repro/core/operators.py`: the descriptors are frozen
dataclasses, so the port's pipelines hash and compare exactly as the
reference's do, field for field.

A pipeline is an ordered list of operator descriptors, validated against the
canonical stage order of Fig. 4:

    [Crypt(decrypt)] -> Project|SmartAddress -> [Select|RegexMatch]
        -> [Distinct|GroupBy] -> [Crypt(encrypt)] -> Pack (implicit)

Descriptors are hashable; their tuple is the pipeline *signature* — the key
of the compiled-executable cache in pipeline.py, which plays the role of the
paper's precompiled partial bitstreams for the dynamic regions.
"""
from __future__ import annotations

from dataclasses import dataclass

# comparison ops (shared codes with kernels/ref.py)
OPS = {"<": 1, "<=": 2, ">": 3, ">=": 4, "==": 5, "!=": 6}


@dataclass(frozen=True)
class Project:
    """Return a subset of columns (paper §5.2 'Projection')."""
    cols: tuple[str, ...]


@dataclass(frozen=True)
class SmartAddress:
    """Column-granular reads from the pool (paper §5.2 'Smart addressing').

    Instead of streaming whole rows and projecting in the pipeline, issue
    per-column reads. Beneficial when row_words >> len(cols) (Fig. 7)."""
    cols: tuple[str, ...]


@dataclass(frozen=True)
class Predicate:
    col: str
    op: str        # one of OPS
    value: float


@dataclass(frozen=True)
class Select:
    """AND of per-column predicates (paper §5.3 'Predicate selection')."""
    predicates: tuple[Predicate, ...]


@dataclass(frozen=True)
class RegexMatch:
    """Filter byte-string rows by a regex (paper §5.3)."""
    pattern: str


@dataclass(frozen=True)
class JoinSmall:
    """Inner join against a SMALL pool-resident build table (the paper's
    stated future work, §Conclusions): the memory node reads the build
    table into on-chip memory once and matches the probe stream against
    it. Build keys must be unique. Matched probe rows survive; the build's
    value columns are appended to the response."""
    probe_key: str
    build_table: str               # name of the build FTable in the pool
    build_key: str
    build_cols: tuple              # value columns appended on match


@dataclass(frozen=True)
class Distinct:
    """DISTINCT over key column(s) (paper §5.4)."""
    cols: tuple[str, ...]
    n_buckets: int = 1024


@dataclass(frozen=True)
class GroupBy:
    """GROUP BY key with aggregates over value columns (paper §5.4)."""
    key: str
    values: tuple[str, ...]
    aggs: tuple[str, ...] = ("count", "sum")   # of count/sum/min/max/avg
    n_buckets: int = 1024


@dataclass(frozen=True)
class Crypt:
    """CTR-mode stream cipher on the data path (paper §5.5)."""
    key: tuple[int, int]
    nonce: int
    when: str = "pre"   # "pre" = decrypt data read from pool; "post" = encrypt response


@dataclass(frozen=True)
class Pack:
    """Length-prefixed response packing (paper §5.5) — implicit, kept for
    signature completeness when explicitly requested."""


STAGE_ORDER = {
    Crypt: 0,          # pre-crypt
    SmartAddress: 1,
    Project: 1,
    Select: 2,
    RegexMatch: 2,
    JoinSmall: 2,      # joins compose with selection, before grouping
    Distinct: 3,
    GroupBy: 3,
    Pack: 5,
}


def validate_pipeline(pipeline: tuple) -> tuple:
    """Check stage ordering; returns the pipeline unchanged."""
    last = -1
    n_reads = 0
    for op in pipeline:
        stage = STAGE_ORDER[type(op)]
        if isinstance(op, Crypt):
            stage = 0 if op.when == "pre" else 4
        if stage < last:
            raise ValueError(
                f"operator {op} out of pipeline order (stage {stage} after "
                f"{last}) — canonical order is decrypt->project->select->"
                f"group->encrypt->pack")
        last = stage
        if isinstance(op, (Project, SmartAddress)):
            n_reads += 1
    if n_reads > 1:
        raise ValueError("at most one Project/SmartAddress per pipeline")
    return pipeline


def signature(pipeline: tuple) -> tuple:
    """Hashable pipeline identity (the 'bitstream id' of a dynamic region)."""
    return tuple(pipeline)


# ------------------------------------------------------- scheduler helpers
def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1): the shape bucket a request lands
    in. Bucketing trades <2x padded work for executable reuse — every
    request in a bucket runs at the bucket's shape, so K different-sized
    tables cost ONE trace instead of K."""
    return 1 << max(0, int(n) - 1).bit_length()


def shape_bucket(n: int) -> int:
    """Quarter-octave pad target: smallest m * 2^e >= n with m in 5..8
    (powers of two below 8 for tiny n). Four steps per octave caps the
    padded-work overhead at 1.25x where pow2 rounding pays up to 2x —
    hash partitions land at n/k + eps rows and a pow2 target rounds
    nearly half the dispatch back to waste.

    This is the PAD target only, never the COALESCING key: requests
    still group by `pow2_bucket` (one batch per octave) and the batch
    pads to the quarter-octave rung of its largest member, so a bucket
    costs at most four traced shapes instead of one — a bounded retrace
    price for an unbounded per-dispatch row saving."""
    n = max(1, int(n))
    if n <= 8:
        return pow2_bucket(n)       # the ladder degenerates below m=5
    step = 1 << ((n - 1).bit_length() - 3)      # octave top is 8 * step
    return -(-n // step) * step


def has_crypt_pre(pipeline: tuple) -> bool:
    """True if the pipeline decrypts the read stream. The CTR keystream is
    positional over the row-major flattening, so width padding would shift
    byte positions — string requests with a pre-crypt bucket on exact
    width (row padding appends whole rows and is keystream-safe)."""
    return any(isinstance(o, Crypt) and o.when == "pre" for o in pipeline)


def join_small_of(pipeline: tuple) -> JoinSmall | None:
    """The pipeline's join descriptor, if any. The cluster's scatter needs
    it up front: a partitioned probe may only dispatch when every owning
    node can resolve the named build table locally (replicated copy or
    co-partitioned shard)."""
    for o in pipeline:
        if isinstance(o, JoinSmall):
            return o
    return None


def crypt_post_of(pipeline: tuple) -> Crypt | None:
    """The response-encryption descriptor, if any. The cluster merge needs
    it: per-node responses are each encrypted with a keystream starting at
    position 0, so a byte-identical merged response is rebuilt client-side
    (decrypt partials, splice, re-encrypt at merged positions)."""
    for o in pipeline:
        if isinstance(o, Crypt) and o.when == "post":
            return o
    return None
