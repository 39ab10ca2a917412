"""Small-table inner join probe over a stack of requests.

Replaces the Pallas kernel `src/repro/kernels/hash_join.py:62`
(`hash_join`) and the probe-key conversion of the JAX pipeline's join
branch. The CUDA kernel is `csrc/hash_join.cu`; its header states the
contract and the design (build keys sorted once per call, in shared
memory when they fit, a thread per probe row at a time, matched words
copied bitwise).

What bounds it on the card: bytes. The function reads each probe row
and the build once, and writes w + V + 1 words a row. Ordering the K
build keys is one
`torch.sort` a call on the card (K is small: the paper's join is against
a small table); the probe itself is the hand-written kernel.

Contract, per request b of a (B, N, w) probe stack (that of
`repro.kernels.ops.hash_join_xla` with valid = row < n_valid[b]): the key
of a row is column kcol, an f32 word converted as `rint` to int32 with
saturation (`ref.rint_to_int32`) or an int32 key taken as it is; a row
that lies below n_valid[b] and whose key is a build key gets that build
row's V words, bitwise, and hit 1.0; every other row gets V zeros and
0.0. Build keys must be unique: callers run the eager host check
`check_unique` first, as the reference's wrappers do, and the probe does
not look again. K = 0 (an empty build) matches nothing and launches
nothing.

The probe writes the widened rows the pipeline's select_project reads:
each probe row's w words (copied bitwise), then its V matched words and
its hit flag, then zeros to the width of the output (where the pipeline
writes partitioned dispatch's id column afterwards), so the pipeline
copies the stack only once.

`hash_join` launches the kernel and takes CUDA tensors only;
`hash_join_plain` is the same function in plain torch, which the CPU
path and the on-card comparison use. `hash_join.launches` counts the
kernel's launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref


def check_unique(build_keys) -> None:
    """The join's contract, checked on the host: raises ValueError when
    two build keys are equal. Copies the keys to the host, so on the card
    it waits for them; callers run it once per build, before launch."""
    keys = (build_keys.cpu().numpy() if isinstance(build_keys, torch.Tensor)
            else np.asarray(build_keys))
    if len(np.unique(keys)) != len(keys):
        raise ValueError("build keys must be unique for a small-table join")


def _check_args(probe, kcol, build_keys, build_vals, n_valid, out):
    """Validate the arguments; returns the output tensor (allocated as
    (B, N, w + V + 1) f32 when `out` is None)."""
    if probe.dim() != 3 or probe.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"probe must be a (B, N, w) float32 or int32 "
                         f"stack, got {tuple(probe.shape)} {probe.dtype}")
    b, n, w = probe.shape
    if not 0 <= kcol < w:
        raise ValueError(f"probe key column {kcol} out of range for {w} "
                         "columns")
    if (build_keys.dim() != 1 or build_keys.dtype != torch.int32
            or build_vals.dim() != 2 or build_vals.dtype != torch.float32
            or build_vals.shape[0] != build_keys.shape[0]
            or build_keys.device != probe.device
            or build_vals.device != probe.device):
        raise ValueError("build must be (K,) int32 keys and (K, V) float32 "
                         "values on the probe's device")
    if (n_valid.device != probe.device or n_valid.dtype != torch.int32
            or tuple(n_valid.shape) != (b,)):
        raise ValueError("n_valid must be a (B,) int32 tensor on the "
                         "probe's device")
    v = build_vals.shape[1]
    if out is None:
        return torch.empty((b, n, w + v + 1), dtype=torch.float32,
                           device=probe.device)
    if (out.dtype != torch.float32 or out.dim() != 3
            or tuple(out.shape[:2]) != (b, n) or not out.is_contiguous()
            or out.device != probe.device or out.shape[2] < w + v + 1):
        raise ValueError(f"out must be a contiguous (B, N, >= w + V + 1) "
                         f"float32 tensor on the probe's device, got "
                         f"{tuple(out.shape)} {out.dtype}")
    return out


def hash_join(probe: torch.Tensor, kcol: int, build_keys: torch.Tensor,
              build_vals: torch.Tensor, n_valid: torch.Tensor, *,
              out: torch.Tensor | None = None):
    """Launch the probe kernel. probe (B, N, w) float32 words or int32
    keys on the card, key column kcol (a view with any stride between
    requests is read in place); build_keys (K,) int32, unique (see
    `check_unique`), and build_vals (K, V) float32 on the card; n_valid
    (B,) int32 on the card. Fills `out` (B, N, >= w + V + 1; a new
    (B, N, w + V + 1) tensor when None) with each probe row, its V matched
    build words, its hit flag and zeros, and returns it, unsynchronised."""
    if probe.device.type != "cuda":
        raise ValueError("hash_join launches a CUDA kernel: its inputs must "
                         "be CUDA tensors")
    out = _check_args(probe, kcol, build_keys, build_vals, n_valid, out)
    b, n, w = probe.shape
    k, v = build_vals.shape
    if n >= 2**31:
        raise ValueError("hash_join takes fewer than 2^31 rows a request")
    if n == 0 or b == 0:
        return out
    if k == 0:                      # an empty build: nothing matches
        out.view(torch.int32)[..., :w] = probe.view(torch.int32)
        out[..., w:] = 0.0
        return out
    keys, order = torch.sort(build_keys)
    vals = build_vals.view(torch.int32).index_select(0, order).contiguous()
    if probe.stride()[1:] != (w, 1):
        probe = probe.contiguous()
    n_valid = n_valid.contiguous()
    lib = _build.lib("hash_join.cu")
    with torch.cuda.device(probe.device):
        _build.check(lib.hj_probe(
            probe.data_ptr(), probe.stride(0), w, kcol,
            int(probe.dtype == torch.float32), keys.data_ptr(),
            vals.data_ptr(), k, v, n_valid.data_ptr(), out.data_ptr(),
            out.shape[2], n, b, torch.cuda.current_stream().cuda_stream),
            lib.hj_error_string, "hash_join")
    hash_join.launches += 1
    return out


hash_join.launches = 0


def hash_join_plain(probe: torch.Tensor, kcol: int, build_keys: torch.Tensor,
                    build_vals: torch.Tensor, n_valid: torch.Tensor, *,
                    out: torch.Tensor | None = None):
    """The kernel's function in plain torch, on the probe's device: same
    arguments and result as `hash_join`."""
    out = _check_args(probe, kcol, build_keys, build_vals, n_valid, out)
    n, w = probe.shape[1:]
    v = build_vals.shape[1]
    keys = probe[..., kcol]
    if keys.dtype == torch.float32:
        keys = ref.rint_to_int32(keys)
    joined, hit = ref.hash_join(keys, build_keys, build_vals)
    rows = torch.arange(n, dtype=torch.int32, device=probe.device)
    hit = hit & (rows[None, :] < n_valid[:, None])
    bits = out.view(torch.int32)
    bits[..., :w] = probe.view(torch.int32)
    bits[..., w: w + v] = torch.where(hit[..., None],
                                      joined.view(torch.int32), 0)
    out[..., w + v] = hit.to(torch.float32)
    out[..., w + v + 1:] = 0.0
    return out
