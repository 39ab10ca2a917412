"""The kernel entry points the pipeline calls (port of `repro/kernels/ops.py`).

Each function dispatches on the device of the tensor it is given: a CUDA
tensor launches the hand-written kernel (and raises if it cannot), a CPU
tensor runs the kernel's plain torch version. There is no other switch and
no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ctr_crypt as _ctr
from repro_torch.kernels import select_project as _sp


def _pick(t: torch.Tensor, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {t.device}")


def select_project(table: torch.Tensor, sel_ops, sel_vals, proj_mask,
                   n_valid: torch.Tensor):
    """table (B, N, C) f32; sel_ops (C,) int32, sel_vals (C,) f32 and
    proj_mask (C,) host arrays; n_valid (B,) int32 on table's device.

    The contract of `repro.kernels.ops.select_project_xla` with valid =
    row < n_valid[b], for each request b of the stack. Returns (packed
    (B, N, C) f32, count (B,) int32), on table's device."""
    fn = _pick(table, _sp.select_project, _sp.select_project_plain)
    return fn(table, sel_ops, sel_vals, proj_mask, n_valid)


def crypt(data: torch.Tensor, key, nonce: int,
          idx: torch.Tensor | None = None) -> torch.Tensor:
    """data (B, L) int32 words; key two uint32 ints; optional (B, L) int32
    stream positions. The involutive CTR cipher of `repro.kernels.ref.
    ctr_crypt`, each request's stream starting at position 0 unless idx
    is given."""
    fn = _pick(data, _ctr.ctr_crypt, _ctr.ctr_crypt_plain)
    return fn(data, key, nonce, idx)
