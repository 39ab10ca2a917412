"""Fused selection + projection + packing over a stack of requests.

Replaces the Pallas kernel `repro/kernels/select_project.py::select_project`
and its block stitch in `repro/kernels/ops.py::select_project`. The CUDA
kernel is `csrc/select_project.cu`; its header says how it is built and
what bounds it (bytes: each row read twice, each output word written once).

Contract, per request b of the stack (that of `repro.kernels.ops.
select_project_xla` with valid = row < n_valid[b]): rows that pass the
predicate and lie below n_valid[b] are stably compacted to the front,
projected words copied bitwise, dropped columns and the tail zero; the
survivor count stays on the device as int32.

`select_project` launches the kernel and takes CUDA tensors only;
`select_project_plain` is the same function in plain torch, which the CPU
path and the on-card comparison use. `select_project.launches` counts the
kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


def _plan(sel_ops, sel_vals, proj_mask, n_cols: int):
    ops = np.ascontiguousarray(np.asarray(sel_ops, np.int32).reshape(-1))
    vals = np.ascontiguousarray(np.asarray(sel_vals, np.float32).reshape(-1))
    keep = np.ascontiguousarray(
        (np.asarray(proj_mask).reshape(-1) != 0).astype(np.int32))
    if not ops.shape == vals.shape == keep.shape == (n_cols,):
        raise ValueError(f"plan arrays must have {n_cols} entries, got "
                         f"{ops.shape}, {vals.shape}, {keep.shape}")
    return ops, vals, keep


def predicate_words(ops: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """The predicate as the kernels read it (`csrc/predicate.cuh`): the
    columns that carry a compare (op codes OP_LT..OP_NE; OP_SKIP and
    unknown codes pass, so they drop out), then their op codes, then
    their operands as f32 bits. int32, 3 * n_pred words."""
    cols = np.flatnonzero((ops >= ref.OP_LT) & (ops <= ref.OP_NE))
    return np.concatenate([cols.astype(np.int32), ops[cols],
                           vals[cols].view(np.int32)])


def select_project(table: torch.Tensor, sel_ops, sel_vals, proj_mask,
                   n_valid: torch.Tensor):
    """Launch the CUDA kernel. table (B, N, C) f32 on the card, any
    C >= 1; sel_ops (C,) int32, sel_vals (C,) f32 and proj_mask (C,) host
    arrays (the static plan, uploaded without a sync); n_valid (B,) int32
    on the card. Returns (packed
    (B, N, C) f32, count (B,) int32), both on the card, unsynchronised."""
    if table.device.type != "cuda":
        raise ValueError("select_project launches a CUDA kernel: table must "
                         "be a CUDA tensor")
    if table.dtype != torch.float32 or table.dim() != 3:
        raise ValueError(f"table must be (B, N, C) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b, n, c = table.shape
    if (n_valid.device != table.device or n_valid.dtype != torch.int32
            or tuple(n_valid.shape) != (b,)):
        raise ValueError("n_valid must be a (B,) int32 tensor on the "
                         "table's device")
    if c < 1:
        raise ValueError("select_project takes at least one column")
    if n >= 2**31:
        raise ValueError("select_project takes fewer than 2^31 rows a request")
    ops, vals, keep = _plan(sel_ops, sel_vals, proj_mask, c)
    pred = predicate_words(ops, vals)
    lib = _build.lib("select_project.cu")
    table = table.contiguous()
    n_valid = n_valid.contiguous()
    packed = torch.empty_like(table)
    if n == 0:
        return packed, torch.zeros((b,), dtype=torch.int32,
                                   device=table.device)
    n_blocks = -(-n // lib.sp_rows_per_block())
    counts = torch.empty((b, n_blocks), dtype=torch.int32,
                         device=table.device)
    # the plan: the compacted predicate, then the keep mask (0 / all ones)
    plan = _build.upload(np.concatenate([pred, -keep]), torch.int32,
                         table.device)
    n_pred = len(pred) // 3
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.sp_count(
            table.data_ptr(), plan.data_ptr(), n_pred, n_valid.data_ptr(),
            counts.data_ptr(), n, c, b, stream),
            lib.sp_error_string, "select_project count pass")
        # the exclusive scan over the small (B, n_blocks) counts array
        inclusive = torch.cumsum(counts, dim=1, dtype=torch.int32)
        offsets = (inclusive - counts).contiguous()
        totals = inclusive[:, -1].contiguous()
        _build.check(lib.sp_pack(
            table.data_ptr(), plan.data_ptr(), n_pred, n_valid.data_ptr(),
            offsets.data_ptr(), totals.data_ptr(), packed.data_ptr(), n, c,
            b, stream),
            lib.sp_error_string, "select_project pack pass")
    select_project.launches += 1
    return packed, totals


select_project.launches = 0


def select_project_plain(table: torch.Tensor, sel_ops, sel_vals, proj_mask,
                         n_valid: torch.Tensor):
    """The kernel's function in plain torch, on the table's device: same
    arguments and results as `select_project`."""
    b, n, c = table.shape
    ops, vals, keep = _plan(sel_ops, sel_vals, proj_mask, c)
    rows = torch.arange(n, dtype=torch.int32, device=table.device)
    valid = rows[None, :] < n_valid.to(table.device)[:, None]
    return ref.select_project(table, torch.from_numpy(ops),
                              torch.from_numpy(vals), torch.from_numpy(keep),
                              valid)
