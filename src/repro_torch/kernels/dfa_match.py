"""Regular-expression matching: one DFA run per string, over a stack of
requests.

Replaces the Pallas kernel `src/repro/kernels/dfa_match.py:76`
(`dfa_match`, `_kernel` at :31) and its wrapper `repro.kernels.ops.
regex_match`. The CUDA kernel is `csrc/dfa_match.cu`; its header states
the contract and the design (the transition table in shared memory, a
byte per entry; tiles of rows staged in shared memory with coalesced
loads; a thread per string, walking its bytes).

What bounds it on the card: bytes. The function reads each string byte
and length once and writes one mask byte a row; its work is one table
lookup per consumed byte, from shared memory.

Contract, per request b of a (B, N, w) uint8 stack (that of `repro.
kernels.ref.dfa_match` with valid = row < n_valid[b]): row r consumes its
first clamp(lengths[b, r], 0, w) bytes from state 0 through the (S, 256)
table; it matches when it lies below n_valid[b] and its final state
accepts. The DFA comes from `repro_torch.core.regex.compile_regex`;
`prepare_dfa` checks a host DFA and uploads it once.

`dfa_match` launches the kernel and takes CUDA tensors only (S up to
the 256 states a byte holds; a larger table raises);
`dfa_match_plain` is the same function in plain torch, which the CPU
path and the on-card comparison use. `dfa_match.launches` counts the
kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


def prepare_dfa(table, accept, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A host DFA -> (table (S, 256) int32, accept (S,) bool) on `device`,
    uploaded without a sync. Raises ValueError unless table is (S, 256)
    with S >= 1 and every entry a state in [0, S), and accept is (S,)."""
    table = np.asarray(table)
    accept = np.asarray(accept)
    if (table.ndim != 2 or table.shape[1] != 256 or table.shape[0] < 1
            or accept.shape != (table.shape[0],)):
        raise ValueError(f"a DFA is a (S, 256) table and an (S,) accept "
                         f"vector, got {table.shape} and {accept.shape}")
    if table.min() < 0 or table.max() >= table.shape[0]:
        raise ValueError("the DFA table names a state outside [0, S)")
    return (_build.upload(table, torch.int32, device),
            _build.upload(accept, torch.bool, device))


def _check_args(strings, lengths, n_valid, table, accept) -> None:
    if strings.dim() != 3 or strings.dtype != torch.uint8:
        raise ValueError(f"strings must be a (B, N, w) uint8 stack, got "
                         f"{tuple(strings.shape)} {strings.dtype}")
    b, n, _ = strings.shape
    if (lengths.dtype != torch.int32 or tuple(lengths.shape) != (b, n)
            or lengths.device != strings.device):
        raise ValueError("lengths must be a (B, N) int32 tensor on the "
                         "strings' device")
    if (n_valid.dtype != torch.int32 or tuple(n_valid.shape) != (b,)
            or n_valid.device != strings.device):
        raise ValueError("n_valid must be a (B,) int32 tensor on the "
                         "strings' device")
    if (table.dim() != 2 or table.shape[1] != 256 or table.shape[0] < 1
            or table.dtype != torch.int32 or accept.dtype != torch.bool
            or tuple(accept.shape) != (table.shape[0],)
            or table.device != strings.device
            or accept.device != strings.device):
        raise ValueError("the DFA must be a (S, 256) int32 table and an "
                         "(S,) bool accept vector on the strings' device")


def dfa_match(strings: torch.Tensor, lengths: torch.Tensor,
              n_valid: torch.Tensor, table: torch.Tensor,
              accept: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. strings (B, N, w) uint8, lengths (B, N) int32,
    n_valid (B,) int32, table (S, 256) int32 (entries in [0, S), as
    `prepare_dfa` checks) and accept (S,) bool, all on the card. Returns
    the (B, N) bool match mask on the card, unsynchronised."""
    if strings.device.type != "cuda":
        raise ValueError("dfa_match launches a CUDA kernel: its inputs must "
                         "be CUDA tensors")
    _check_args(strings, lengths, n_valid, table, accept)
    b, n, w = strings.shape
    mask = torch.empty((b, n), dtype=torch.bool, device=strings.device)
    if b == 0 or n == 0:
        return mask
    lib = _build.lib("dfa_match.cu")
    s = table.shape[0]
    if s > lib.dfa_max_states():
        raise ValueError(f"the DFA has {s} states; the kernel's table holds "
                         f"{lib.dfa_max_states()} (a state is one byte)")
    if w > lib.dfa_max_width():
        raise ValueError(f"strings of {w} bytes are wider than the kernel's "
                         f"{lib.dfa_max_width()}-byte tile")
    if b > 65535:
        raise ValueError("dfa_match takes at most 65535 requests a stack")
    strings, lengths = strings.contiguous(), lengths.contiguous()
    n_valid = n_valid.contiguous()
    table, accept = table.contiguous(), accept.contiguous()
    with torch.cuda.device(strings.device):
        _build.check(lib.dfa_match(
            strings.data_ptr(), lengths.data_ptr(), n_valid.data_ptr(),
            table.data_ptr(), accept.data_ptr(), s, mask.data_ptr(), n, w,
            b, torch.cuda.current_stream().cuda_stream),
            lib.dfa_error_string, "dfa_match")
    dfa_match.launches += 1
    return mask


dfa_match.launches = 0


def dfa_match_plain(strings: torch.Tensor, lengths: torch.Tensor,
                    n_valid: torch.Tensor, table: torch.Tensor,
                    accept: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, on the strings' device: same
    arguments and result as `dfa_match`."""
    _check_args(strings, lengths, n_valid, table, accept)
    rows = torch.arange(strings.shape[1], device=strings.device)
    valid = rows[None, :] < n_valid[:, None]
    return ref.dfa_match(strings, lengths, table, accept) & valid
