"""Plain torch oracles for the port's kernels (port of `repro/kernels/ref.py`).

Each function is the semantic ground truth of one CUDA kernel in this
package, written in plain torch ops so it runs on the CPU and on the card
alike. Only the four functions the rows-kind slice needs are here:
`eval_predicate`, `select_project`, `threefry2x32` and `ctr_crypt`.

Cipher words are uint32 in the reference. torch on the CPU has no add,
shift or compare for `torch.uint32`, so the cipher carries its words in
int64 masked to 32 bits, and data words cross in and out as int32 bit
patterns. Float words are reinterpreted with `.view(torch.int32)`, never
converted, so NaN payloads and -0.0 survive bit for bit.
"""
from __future__ import annotations

import torch

# Predicate op codes shared with the kernels (paper §5.3 predicate selection).
OP_SKIP, OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE = range(7)

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# select_project
# ---------------------------------------------------------------------------
def eval_predicate(table: torch.Tensor, sel_ops: torch.Tensor,
                   sel_vals: torch.Tensor) -> torch.Tensor:
    """AND of per-column comparisons: table (..., N, A) f32, sel_ops (A,)
    int32 op codes (OP_SKIP, or any other code, passes), sel_vals (A,) f32.
    Returns the (..., N) bool mask.

    IEEE f32 compares (NaN fails every op but `!=`) with subnormal
    operands read as zero, on both sides: the reference compares that way
    on the TPU (no f32 subnormals) and under XLA on the CPU (flush-to-zero
    compares), so a subnormal word selects as 0.0 does."""
    val = flush_subnormals(sel_vals.to(table.device, torch.float32))
    ops = sel_ops.to(table.device, torch.int32)
    table = flush_subnormals(table)
    per_col = torch.ones(table.shape, dtype=torch.bool, device=table.device)
    for code, cmp in ((OP_LT, torch.lt), (OP_LE, torch.le), (OP_GT, torch.gt),
                      (OP_GE, torch.ge), (OP_EQ, torch.eq),
                      (OP_NE, torch.ne)):
        per_col = torch.where(ops == code, cmp(table, val), per_col)
    return per_col.all(dim=-1)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """f32 values with a zero exponent field (zeros and subnormals) -> 0.0;
    for compares only, never for the words a response carries."""
    exponent = x.view(torch.int32) & 0x7F800000
    return torch.where(exponent == 0, 0.0, x)


def select_project(table: torch.Tensor, sel_ops: torch.Tensor,
                   sel_vals: torch.Tensor, proj_mask: torch.Tensor,
                   valid: torch.Tensor | None = None):
    """Filter rows by predicate (and `valid`), zero dropped columns, compact.

    table (..., N, A) f32; valid (..., N) bool or None. Returns (packed
    (..., N, A) f32 with survivors moved to the front in original order,
    projected words copied bitwise, dropped columns and the tail zero;
    count (...) int32). The contract of `repro.kernels.ops.
    select_project_xla`, over any number of leading stack axes.
    """
    mask = eval_predicate(table, sel_ops, sel_vals)
    if valid is not None:
        mask = mask & valid
    keep = proj_mask.to(table.device).bool()
    bits = torch.where(keep, table.view(torch.int32), 0)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    packed = torch.where(mask.gather(-1, order)[..., None],
                         bits.gather(-2, order[..., None].expand_as(bits)),
                         0)
    return packed.view(torch.float32), mask.sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# ctr_crypt (ARX counter-mode cipher, Threefry-2x32 schedule)
# ---------------------------------------------------------------------------
_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(key: tuple[int, int], c0: torch.Tensor, c1: torch.Tensor):
    """Threefry-2x32, 20 rounds. key: two uint32 ints; c0/c1: int64 tensors
    holding uint32 values. Returns two int64 tensors of uint32 values."""
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _MASK32
    x1 = (c1 + ks[1]) & _MASK32
    for block in range(5):
        for r in range(4):
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, _ROTS[(4 * block + r) % 8])
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK32
    return x0, x1


def ctr_crypt(data: torch.Tensor, key: tuple[int, int], nonce: int,
              idx: torch.Tensor | None = None) -> torch.Tensor:
    """XOR data (N,) int32 words with the Threefry CTR keystream. Involutive.

    Word i is XORed with lane `p & 1` of threefry(key, p >> 1, nonce) at
    stream position p = idx[i] (default i). Positions are taken mod 2^32,
    as the reference's uint32 arithmetic takes them."""
    n = data.shape[0]
    pos = (torch.arange(n, dtype=torch.int64, device=data.device)
           if idx is None else idx.to(torch.int64) & _MASK32)
    s0, s1 = threefry2x32(key, pos >> 1,
                          torch.full_like(pos, int(nonce) & _MASK32))
    stream = torch.where((pos & 1) == 0, s0, s1)
    out = (data.to(torch.int64) & _MASK32) ^ stream
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)
