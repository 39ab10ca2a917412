"""Counter-mode Threefry-2x32 stream cipher over a stack of word streams,
and over a stack of byte streams (a string table's pre-decrypt).

Replaces the Pallas kernel `repro/kernels/ctr_crypt.py::ctr_crypt`. The
CUDA kernels are in `csrc/ctr_crypt.cu`; its header says what bounds
them (words: bytes, 8 a word against about 37 integer operations a word;
bytes: integer operations, about 37 a byte against 2 bytes moved) and how
their design keeps the round schedule in registers.

Contract (`repro.kernels.ref.ctr_crypt`, row by row): word i of request b
is XORed with the keystream at position i — each request's stream starts
at 0 — or at idx[b, i] when explicit positions are given (partitioned
dispatch keys the keystream by original-table offsets). Involutive.

The byte contract is the reference pipeline's pre-decrypt of a string
table (`repro/core/pipeline.py::_body`): each byte is widened to a word,
ciphered at its position, and cut back to its low byte, so byte i becomes
b[i] ^ (ks(p) & 0xFF). Without row ids p is i within its request; with
(B, n) row ids and the row width w, the byte at (row, col) takes p =
row_id * w + col in uint32 arithmetic, its offset in the original table's
row-major flattening. The byte kernel computes p itself: no widened copy
and no position tensor.

`ctr_crypt` and `ctr_crypt_bytes` launch the kernels and take CUDA
tensors only; `ctr_crypt_plain` and `ctr_crypt_bytes_plain` are the same
functions in plain torch. Each launching wrapper's `.launches` counts its
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_MASK32 = 0xFFFFFFFF
# elements per plain-version chunk: bounds its int64 temporaries to a few
# hundred MiB at the main path's 2^28-word and 2^30-byte rounds
_PLAIN_CHUNK = 1 << 24


def _launch_args(data: torch.Tensor, key, nonce: int,
                 what: str) -> tuple[int, int, int]:
    """The device check of a launching wrapper, and the key's two words
    and the nonce as the uint32 values the kernels take."""
    if data.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel: data must be a "
                         "CUDA tensor")
    return (int(key[0]) & _MASK32, int(key[1]) & _MASK32,
            int(nonce) & _MASK32)


def _check_args(data: torch.Tensor, idx: torch.Tensor | None) -> None:
    if data.dtype != torch.int32 or data.dim() != 2:
        raise ValueError(f"data must be (B, L) int32 words, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if idx is not None and (idx.shape != data.shape
                            or idx.dtype != torch.int32
                            or idx.device != data.device):
        raise ValueError("idx must be an int32 tensor shaped like data, on "
                         "data's device")


def _check_bytes_args(data: torch.Tensor, row_ids: torch.Tensor | None,
                      width: int | None) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be (B, L) uint8 bytes, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if row_ids is None:
        return
    b, length = data.shape
    if width is None or width < 1 or length % width:
        raise ValueError(f"row_ids need the row width: a width >= 1 that "
                         f"divides L = {length}, got {width}")
    if (tuple(row_ids.shape) != (b, length // width)
            or row_ids.dtype != torch.int32
            or row_ids.device != data.device):
        raise ValueError(f"row_ids must be a ({b}, {length // width}) int32 "
                         "tensor on data's device: one id a row")


def ctr_crypt(data: torch.Tensor, key, nonce: int,
              idx: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. data (B, L) int32 words on the card (float
    words reinterpreted with `.view(torch.int32)`); key two uint32 ints;
    idx None or (B, L) int32 stream positions (uint32 bit patterns).
    Returns the (B, L) int32 result on the card, unsynchronised."""
    k0, k1, nonce = _launch_args(data, key, nonce, "ctr_crypt")
    _check_args(data, idx)
    b, n = data.shape
    data = data.contiguous()
    out = torch.empty_like(data)
    if n == 0 or b == 0:
        return out
    idx = None if idx is None else idx.contiguous()
    lib = _build.lib("ctr_crypt.cu")
    with torch.cuda.device(data.device):
        _build.check(lib.ctr_crypt(
            data.data_ptr(), None if idx is None else idx.data_ptr(),
            out.data_ptr(), n, b, k0, k1, nonce,
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


def ctr_crypt_bytes(data: torch.Tensor, key, nonce: int,
                    row_ids: torch.Tensor | None = None,
                    width: int | None = None) -> torch.Tensor:
    """Launch the byte-stream kernel. data (B, L) uint8 bytes on the card
    (a (B, n, w) string stack flattened per request, L = n * w); key two
    uint32 ints; row_ids None or (B, n) int32 original-table row ids
    (uint32 bit patterns) with `width` = w. Returns a new (B, L) uint8
    tensor on the card, unsynchronised; data is not written."""
    k0, k1, nonce = _launch_args(data, key, nonce, "ctr_crypt_bytes")
    _check_bytes_args(data, row_ids, width)
    b, length = data.shape
    data = data.contiguous()
    out = torch.empty_like(data)
    if length == 0 or b == 0:
        return out
    ids = None if row_ids is None else row_ids.contiguous()
    lib = _build.lib("ctr_crypt.cu")
    with torch.cuda.device(data.device):
        _build.check(lib.ctr_crypt_bytes(
            data.data_ptr(), None if ids is None else ids.data_ptr(),
            out.data_ptr(), length, 0 if ids is None else int(width), b,
            k0, k1, nonce, torch.cuda.current_stream().cuda_stream),
            lib.ctr_error_string, "ctr_crypt_bytes")
    ctr_crypt_bytes.launches += 1
    return out


ctr_crypt_bytes.launches = 0


def ctr_crypt_bytes_plain(data: torch.Tensor, key, nonce: int,
                          row_ids: torch.Tensor | None = None,
                          width: int | None = None) -> torch.Tensor:
    """The byte kernel's function in plain torch, on data's device: same
    arguments and result as `ctr_crypt_bytes`."""
    _check_bytes_args(data, row_ids, width)
    length = data.shape[1]
    flat = data.reshape(-1)
    flat_ids = None if row_ids is None else row_ids.reshape(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, flat.shape[0])
        f = torch.arange(s, e, dtype=torch.int64, device=data.device)
        i = f % length                  # the byte's index in its request
        if flat_ids is None:
            pos = i
        else:
            # the row's id times w plus the column, masked to 32 bits by
            # ref (the reference's uint32 arithmetic)
            rid = flat_ids[(f // length) * (length // width) + i // width]
            pos = rid.to(torch.int64) * width + i % width
        out[s:e] = ref.ctr_crypt_bytes(flat[s:e], key, nonce, idx=pos)
    return out.reshape(data.shape)
