"""Counter-mode Threefry-2x32 stream cipher over a stack of word streams.

Replaces the Pallas kernel `repro/kernels/ctr_crypt.py::ctr_crypt`. The
CUDA kernel is `csrc/ctr_crypt.cu`; its header says what bounds it (bytes:
8 a word against about 60 integer operations a word) and how its design
keeps the round schedule in registers.

Contract (`repro.kernels.ref.ctr_crypt`, row by row): word i of request b
is XORed with the keystream at position i — each request's stream starts
at 0 — or at idx[b, i] when explicit positions are given (partitioned
dispatch keys the keystream by original-table offsets). Involutive.

`ctr_crypt` launches the kernel and takes CUDA tensors only;
`ctr_crypt_plain` is the same function in plain torch. `ctr_crypt.launches`
counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_MASK32 = 0xFFFFFFFF
# words per plain-version chunk: bounds its int64 temporaries to a few
# hundred MiB at the main path's 2^28-word streams
_PLAIN_CHUNK = 1 << 24


def _check_args(data: torch.Tensor, idx: torch.Tensor | None) -> None:
    if data.dtype != torch.int32 or data.dim() != 2:
        raise ValueError(f"data must be (B, L) int32 words, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if idx is not None and (idx.shape != data.shape
                            or idx.dtype != torch.int32
                            or idx.device != data.device):
        raise ValueError("idx must be an int32 tensor shaped like data, on "
                         "data's device")


def ctr_crypt(data: torch.Tensor, key, nonce: int,
              idx: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. data (B, L) int32 words on the card (float
    words reinterpreted with `.view(torch.int32)`); key two uint32 ints;
    idx None or (B, L) int32 stream positions (uint32 bit patterns).
    Returns the (B, L) int32 result on the card, unsynchronised."""
    if data.device.type != "cuda":
        raise ValueError("ctr_crypt launches a CUDA kernel: data must be a "
                         "CUDA tensor")
    _check_args(data, idx)
    b, n = data.shape
    out = torch.empty_like(data)
    if n == 0 or b == 0:
        return out
    data = data.contiguous()
    idx = None if idx is None else idx.contiguous()
    lib = _build.lib("ctr_crypt.cu")
    with torch.cuda.device(data.device):
        _build.check(lib.ctr_crypt(
            data.data_ptr(), None if idx is None else idx.data_ptr(),
            out.data_ptr(), n, b, int(key[0]) & _MASK32,
            int(key[1]) & _MASK32, int(nonce) & _MASK32,
            torch.cuda.current_stream().cuda_stream),
            lib.ctr_error_string, "ctr_crypt")
    ctr_crypt.launches += 1
    return out


ctr_crypt.launches = 0


def ctr_crypt_plain(data: torch.Tensor, key, nonce: int,
                    idx: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain torch, on data's device: same
    arguments and result as `ctr_crypt`."""
    _check_args(data, idx)
    n = data.shape[1]
    flat = data.reshape(-1)
    flat_idx = None if idx is None else idx.reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, flat.shape[0])
        pos = (torch.arange(s, e, dtype=torch.int64, device=data.device) % n
               if flat_idx is None else flat_idx[s:e])
        out[s:e] = ref.ctr_crypt(flat[s:e], key, nonce, idx=pos)
    return out.reshape(data.shape)
