"""Base error types shared across layers (port of `repro/core/errors.py`).

The JAX package defines `NodeDeadError` and `DeadlineExceededError` in
`core/client.py`; the port keeps every typed error here, below the pool,
and `core.client` re-exports them. `PageCodecError` is raised by the
tiering codec (`distributed.compress`) and the pool.
"""
from __future__ import annotations


class FarviewError(RuntimeError):
    """Base class for every typed Farview failure."""


class PageCodecError(FarviewError):
    """A compressed page failed validation (corrupt stream, bad checksum,
    impossible descriptor). Raised INSTEAD of returning wrong bytes — a
    cold page that cannot be decoded exactly is a loud error, never a
    silently-wrong result."""


class NodeDeadError(FarviewError):
    """The node is gone (killed host, dead NIC): every verb against it
    fails until it is replaced. Carries the node identity."""

    def __init__(self, node_id: int, *, op: str = "dispatch"):
        super().__init__(f"node {node_id} is dead (failed {op})")
        self.node_id = node_id
        self.op = op


class DeadlineExceededError(FarviewError):
    """The request's deadline budget ran out before it was served, so it
    was SHED — never half-run. Sheds happen at `FViewNode.submit` (a
    budget of <= 0) or at `FViewNode.flush` pick time."""

    def __init__(self, node_id: int | None = None, *,
                 op: str = "dispatch",
                 detail: str = "deadline budget exhausted"):
        where = "cluster" if node_id is None else f"node {node_id}"
        super().__init__(f"{where}: {detail} (request shed before {op})")
        self.node_id = node_id
        self.op = op
        self.detail = detail
