"""Far-KV decode attention: flash-decoding partials over a stack of KV
shards.

Replaces the Pallas kernel `src/repro/kernels/decode_attention.py:88`
(`decode_attention`, `_kernel` at :31) and its wrapper `repro.kernels.ops.
decode_attention`, which pads G to 8, D to 128 and S to 256 for the TPU's
matrix unit; this kernel needs no padding. The CUDA kernel is
`csrc/decode_attention.cu`; its header states the contract and the design
(split over KV; in each block four warps stream their own stages of K and
V rows through a ring in shared memory with `cp.async`, each element read
from shared memory once; bf16 caches at D = 64 or 128 with G <= 4 take the
tensor cores with q and p split exactly into three bf16 parts, the rest f32
FMAs; a running max and rescale as the TPU kernel keeps; the warps folded
in warp order, the splits in split order by a second kernel).

What bounds it on the card: bytes. The function reads each valid K and V
row once; its 4 * Hq * D flops a row are under one flop a byte for a bf16
cache.

Contract, per shard p and sequence b (that of `repro_torch.kernels.ref.
decode_attention`): q (P, B, Hq, D) any float type (the kernel reads f32
and bf16 as they are, with any strides over P and B, such as a query
expanded over the shards; other types are converted to f32 first); k and v
(P, B, S, Hkv, D), both f32 or both bf16; lengths (P, B) int32, the
shard's valid rows; Hq a multiple of Hkv (any group G >= 1), D up to 256.
Returns o (P, B, Hq, D) f32 unnormalised, m and l (P, B, Hq) f32; an empty
(p, b) gets o = 0, m = -1e30, l = 0; a query row whose largest score is
+inf or NaN takes 0 as its softmax base (m = 0, p = exp(s)), as ref does.
Rows at or past the length are never read: a non-finite V row there does
not reach o, where the plain version multiplies p = 0 into it (ROADMAP.md
queue 3).

`decode_attention` launches the kernel and takes CUDA tensors only;
`decode_attention_plain` is the same function in plain torch, which the
CPU path and the on-card comparison use. `decode_attention.launches`
counts the kernel's launches (one a call, whatever the splits).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

MAX_DIM = 256                    # the kernel's kMaxDim: its largest D
_WAVES = 2                       # the grid fills the card's blocks this often
                                 # (1 and 2 measured best on the H100)


def _check_args(q, k, v, lengths) -> None:
    if q.dim() != 4 or not q.dtype.is_floating_point:
        raise ValueError(f"q must be a (P, B, Hq, D) float tensor, got "
                         f"{tuple(q.shape)} {q.dtype}")
    p, b, hq, d = q.shape
    if k.dim() != 5 or k.shape[:2] != (p, b) or k.shape[4] != d:
        raise ValueError(f"k must be (P, B, S, Hkv, D) = ({p}, {b}, S, Hkv, "
                         f"{d}), got {tuple(k.shape)}")
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"v must match k: {tuple(k.shape)} {k.dtype}, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the cache must be float32 or bfloat16, got "
                         f"{k.dtype}")
    hkv = k.shape[3]
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"Hq = {hq} must be a multiple of Hkv = {hkv}")
    if d < 1 or d > MAX_DIM:
        raise ValueError(f"head dimension D = {d} is outside the kernel's "
                         f"1..{MAX_DIM}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (p, b):
        raise ValueError(f"lengths must be a (P, B) = ({p}, {b}) int32 "
                         f"tensor, got {tuple(lengths.shape)} {lengths.dtype}")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("q, k, v and lengths must lie on one device")


@functools.cache
def _slots(device: torch.device, d: int, g: int, bf16: int) -> int:
    """Blocks of the kernel that takes (d, g, cache type) resident on the
    whole card at once."""
    lib = _build.lib("decode_attention.cu")
    with torch.cuda.device(device):
        per_sm = lib.da_blocks_per_sm(d, g, bf16)
    if per_sm <= 0:
        _build.check(-per_sm, lib.da_error_string, "decode_attention "
                     "(occupancy)")
        raise RuntimeError(f"decode_attention: no block of D = {d}, G = {g} "
                           f"fits on an SM")
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * per_sm


def _split_plan(pb: int, hkv: int, g: int, s: int, d: int, bf16: int,
                slots: int, lib) -> tuple[int, int]:
    """(splits, rows a split) of each (shard, sequence, KV head): enough
    blocks to fill the card's `slots` resident blocks about `_WAVES`
    times. Where the rows are split at all, a split takes 3/4 of an even
    share, so that a last split of small blocks, which the grid runs last,
    fills the final wave (blocks of one size leave SMs idle at the end).
    A split is a whole number of the kernel's split unit (a round of a
    block's warps over their stages); none is empty at full length."""
    blocks = pb * hkv * -(-g // lib.da_group_chunk())
    unit = lib.da_split_rows(d, g, bf16)
    units = max(1, -(-s // unit))
    want = max(1, min(-(-_WAVES * slots // blocks), units, 65535))
    per = units if want == 1 else -(-3 * units // (4 * want))
    return -(-units // per), per * unit


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: float):
    """Launch the kernel on a stack of shards (see the module's contract),
    all on the card. Returns (o, m, l) on the card, unsynchronised."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention launches a CUDA kernel: its "
                         "inputs must be CUDA tensors")
    _check_args(q, k, v, lengths)
    p, b, hq, d = q.shape
    s, hkv = k.shape[2], k.shape[3]
    g = hq // hkv
    dev = q.device
    o = torch.empty((p, b, hq, d), dtype=torch.float32, device=dev)
    m = torch.empty((p, b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((p, b, hq), dtype=torch.float32, device=dev)
    pb = p * b
    if pb == 0 or hq == 0:
        return o, m, l
    lib = _build.lib("decode_attention.cu")
    chunks = -(-g // lib.da_group_chunk())
    if pb * hkv * chunks > 2**31 - 1:
        raise ValueError(f"P x B x Hkv x ceil(G / {lib.da_group_chunk()}) "
                         f"= {pb * hkv * chunks} is past the grid's 2^31 - 1")
    bf16 = int(k.dtype == torch.bfloat16)
    splits, rows = _split_plan(pb, hkv, g, s, d, bf16,
                               _slots(dev, d, g, bf16), lib)
    # q is read in place: its type if f32 or bf16, any strides over (P, B)
    if q.dtype not in (torch.float32, torch.bfloat16):
        q = q.float()
    if (d > 1 and q.stride(3) != 1) or (hq > 1 and q.stride(2) != d):
        q = q.contiguous()
    q_args = (q.data_ptr(), q.stride(0), q.stride(1),
              int(q.dtype == torch.bfloat16))
    k, v, lengths = k.contiguous(), v.contiguous(), lengths.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if splits == 1:   # the split's partials are the shard's
            _build.check(lib.da_partial(
                *q_args, k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), m.data_ptr(), l.data_ptr(), pb, b, s, hkv, g,
                d, 1, rows, float(scale), bf16, stream),
                lib.da_error_string, "decode_attention")
        else:
            o_s = torch.empty((pb, hkv, splits, g, d), dtype=torch.float32,
                              device=dev)
            m_s = torch.empty((pb, hkv, splits, g), dtype=torch.float32,
                              device=dev)
            l_s = torch.empty_like(m_s)
            _build.check(lib.da_partial(
                *q_args, k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o_s.data_ptr(), m_s.data_ptr(), l_s.data_ptr(), pb, b, s,
                hkv, g, d, splits, rows, float(scale), bf16, stream),
                lib.da_error_string, "decode_attention")
            _build.check(lib.da_combine(
                o_s.data_ptr(), m_s.data_ptr(), l_s.data_ptr(), o.data_ptr(),
                m.data_ptr(), l.data_ptr(), pb, hkv, g, d, splits, stream),
                lib.da_error_string, "decode_attention (combine)")
    decode_attention.launches += 1
    return o, m, l


decode_attention.launches = 0


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, scale: float):
    """The kernel's function in plain torch, on the inputs' device: same
    arguments and result as `decode_attention`."""
    _check_args(q, k, v, lengths)
    return ref.decode_attention(q, k, v, lengths, scale)
