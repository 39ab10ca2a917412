"""Fused in-dispatch page decompression (port of `repro/kernels/tier.py`).

`FarPool` keeps COLD pages compressed in place (`distributed/compress.py`
encodes each column plane bit-packed delta/dict into a shared "cold
frame"). These gathers are the device-side inverse: functions of
`(buf, descriptors)` that rebuild the LOGICAL words of a mixed
raw/compressed page list as part of the request's dispatch, so an
offloaded verb over cold data runs its body over the decoded words with
no host-side inflate.

Descriptor layout (one row per logical page, built by `FarPool.tier_desc`;
a stack of requests adds a leading B axis to every field):

  phys    (P,)   int32   raw page id, or the cold frame holding the stream
  mode    (P,C)  int32   per column plane: MODE_RAW | MODE_DELTA | MODE_DICT
  width   (P,C)  int32   packed bits per value (1..32)
  base    (P,C)  int32   delta base, the uint32 value's bit pattern
  dictoff (P,C)  int32   dictionary word offset, FRAME-relative
  bitoff  (P,C)  int32   packed plane bit offset, FRAME-relative

A fully-raw page is one descriptor row of MODE_RAW planes whose `phys` is
the original page, the scheduler's null-page padding included (mode RAW
over the null page reads zeros, masked by n_valid as before).

The reference decodes in XLA, which fuses its ~20 elementwise steps into
the jitted gather. In torch each step would be a full-size int64 tensor
(8 GiB each at a stacked 1 GiB round), so on the card the decode is one
hand-written kernel, `csrc/tier_gather.cu`, which reads the descriptors
and the packed planes and writes each logical word once. `tier_gather`
launches it and takes CUDA tensors only (`tier_gather.launches` counts
its launches); `tier_gather_plain` is the same function in plain torch,
which carries the u32 words in int64 masked to 32 bits (torch on the
CPU has no uint32 add, shift or compare). `gather_rows_tiered` and
`gather_columns_tiered` dispatch on the buffer's device: a CUDA tensor
launches the kernel, a CPU tensor runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.compress import MODE_DICT, MODE_RAW
from repro_torch.kernels import _build

# descriptor tuple order — every producer/consumer goes through these names
TIER_FIELDS = ("phys", "mode", "width", "base", "dictoff", "bitoff")

_MASK32 = 0xFFFFFFFF
# lanes per plain-version chunk: bounds its int64 temporaries to a few
# hundred MiB at the main path's stacked 2^30-word rounds
_PLAIN_CHUNK = 1 << 22


def null_descriptor(n_pages: int, n_cols: int, null_page: int):
    """An all-raw descriptor bundle pointing every page at `null_page` —
    what batched dispatch uses to pad a round's descriptor stack (host
    arrays; `base` uint32 as the reference keeps it)."""
    return (np.full((n_pages,), null_page, np.int32),
            np.full((n_pages, n_cols), MODE_RAW, np.int32),
            np.ones((n_pages, n_cols), np.int32),
            np.zeros((n_pages, n_cols), np.uint32),
            np.zeros((n_pages, n_cols), np.int32),
            np.zeros((n_pages, n_cols), np.int32))


def tier_tensors(desc, device) -> tuple:
    """A host descriptor tuple (numpy, `base` uint32) as int32 tensors on
    `device`, `base` as its bit patterns; uploaded without a host sync."""
    out = []
    for name, a in zip(TIER_FIELDS, desc):
        a = np.asarray(a)
        if name == "base":
            a = a.astype(np.uint32).view(np.int32)
        out.append(_build.upload(np.ascontiguousarray(a, np.int32),
                                 torch.int32, device))
    return tuple(out)


def _stacked(buf: torch.Tensor, tier, n_rows: int, row_words: int,
             page_words: int) -> tuple:
    """Check the operands; returns (tier with a leading B axis, single)."""
    if len(tier) != len(TIER_FIELDS):
        raise ValueError(f"tier is the tuple {TIER_FIELDS}")
    phys = tier[0]
    single = phys.dim() == 1
    if single:
        tier = tuple(t[None] for t in tier)
        phys = tier[0]
    if phys.dim() != 2:
        raise ValueError(f"phys must be (P,) or (B, P), got "
                         f"{tuple(phys.shape)}")
    b, p = phys.shape
    for name, t in zip(TIER_FIELDS[1:], tier[1:]):
        if tuple(t.shape) != (b, p, row_words):
            raise ValueError(f"{name} must be {(b, p, row_words)}, got "
                             f"{tuple(t.shape)}")
    for name, t in zip(TIER_FIELDS, tier):
        if t.device != buf.device or t.dtype not in (torch.int32,
                                                     torch.int64):
            raise ValueError(f"{name} must be an integer tensor on the "
                             f"buffer's device {buf.device}")
    if buf.dtype != torch.float32 or buf.dim() != 2 or (
            buf.shape[1] != page_words):
        raise ValueError(f"buf must be (pages, {page_words}) float32, got "
                         f"{tuple(buf.shape)} {buf.dtype}")
    if page_words < 2:
        raise ValueError("page_words must be at least 2 (straddle read)")
    if n_rows * row_words > p * page_words:
        raise ValueError(f"{n_rows} rows of {row_words} words overrun the "
                         f"{p} pages of the descriptors")
    return tier, single


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value the reference's wrapping int32 arithmetic
    gives, kept in int64."""
    return ((x + 2**31) & _MASK32) - 2**31


def _decode_flat(ubuf: torch.Tensor, tier, b: torch.Tensor, g: torch.Tensor,
                 page_words: int, n_cols: int) -> torch.Tensor:
    """Logical words at flat indices `g` of requests `b` (int64 tensors of
    one shape) -> int64 tensor of u32 values. `ubuf` is the buffer's
    (pages * page_words,) int32 view; the `tier` fields have a leading B
    axis. The reference's steps, with its clamps, and its int32 wrap
    where it computes in int32 (the bit offset, the dictionary index)."""
    phys, mode, width, base, dictoff, bitoff = tier
    pw, C = page_words, n_cols
    p = g // pw                                  # logical page
    k = g % pw                                   # word within page
    c = g % C                                    # column plane
    frame = phys[b, p].to(torch.int64)
    m = mode[b, p, c].to(torch.int64)
    w = width[b, p, c].to(torch.int64)

    def word(idx):
        return ubuf[frame * pw + idx].to(torch.int64) & _MASK32

    # raw candidate: the word itself, straight from the (possibly null) page
    raw = word(k)
    # packed candidate: rank j of this word within its (page, column) plane
    phase = (p * pw) % C                         # column of page's word 0
    j = (k - (c - phase) % C) // C
    bit = _wrap32(bitoff[b, p, c].to(torch.int64) + j * w)
    wi = torch.clamp(bit >> 5, 0, pw - 2)        # clamp: raw lanes don't read
    sh = bit & 31
    lo = word(wi)
    hi = word(wi + 1)
    straddle = torch.where(sh == 0, torch.zeros_like(hi),
                           (hi << (32 - sh).clamp(max=31)) & _MASK32)
    packed = (lo >> sh) | straddle
    # XLA's logical shift by 32 or more gives 0: widths outside 1..32 mask
    # every bit
    inside = (w >= 1) & (w <= 32)
    packed = packed & torch.where(
        inside, torch.full_like(w, _MASK32) >> (32 - w).clamp(0, 31),
        torch.zeros_like(w))
    # delta candidate: wrap-around add of the plane base (exact inverse)
    delta_val = (packed + (base[b, p, c].to(torch.int64) & _MASK32)) & _MASK32
    # dict candidate: frame-relative dictionary lookup (index clamped so
    # non-dict lanes stay in-bounds; their value is masked out by `m`)
    didx = torch.clamp(_wrap32(dictoff[b, p, c].to(torch.int64) + packed),
                       0, pw - 1)
    dict_val = word(didx)
    return torch.where(m == MODE_RAW, raw,
                       torch.where(m == MODE_DICT, dict_val, delta_val))


def _col_list(cols, row_words: int) -> list[int]:
    cols = list(range(row_words)) if cols is None else [int(c) for c in cols]
    if not cols or min(cols) < 0 or max(cols) >= row_words:
        raise ValueError(f"columns {cols} outside a {row_words}-word row")
    return cols


def tier_gather_plain(buf: torch.Tensor, tier, n_rows: int, row_words: int,
                      cols, page_words: int) -> torch.Tensor:
    """The kernel's function in plain torch, on buf's device: same
    arguments and result as `tier_gather`. Rows go in chunks of a bounded
    number of lanes."""
    tier, single = _stacked(buf, tier, n_rows, row_words, page_words)
    cols = _col_list(cols, row_words)
    b_n = tier[0].shape[0]
    dev = buf.device
    ubuf = buf.contiguous().view(torch.int32).reshape(-1)
    col_t = torch.tensor(cols, dtype=torch.int64, device=dev)
    out = torch.empty((b_n, n_rows, len(cols)), dtype=torch.int32,
                      device=dev)
    step = max(1, _PLAIN_CHUNK // len(cols))
    for b in range(b_n):
        for s in range(0, n_rows, step):
            e = min(n_rows, s + step)
            rows = torch.arange(s, e, dtype=torch.int64, device=dev)
            g = rows[:, None] * row_words + col_t[None, :]
            u = _decode_flat(ubuf, tier, torch.full_like(g, b), g,
                             page_words, row_words)
            out[b, s:e] = torch.where(u >= 2**31, u - 2**32,
                                      u).to(torch.int32)
    out = out.view(torch.float32)
    return out[0] if single else out


def tier_gather(buf: torch.Tensor, tier, n_rows: int, row_words: int,
                cols, page_words: int) -> torch.Tensor:
    """Launch the CUDA kernel. buf (pages, page_words) f32 on the card;
    tier the descriptor tuple of int32 tensors on the card, (P,) / (P, C)
    for one request or (B, P) / (B, P, C) for a stack; cols None (every
    column) or a host list of column ids. Returns (n_rows, k) or (B,
    n_rows, k) f32 words on the card, bitwise the logical words,
    unsynchronised."""
    if buf.device.type != "cuda":
        raise ValueError("tier_gather launches a CUDA kernel: buf must be a "
                         "CUDA tensor")
    tier, single = _stacked(buf, tier, n_rows, row_words, page_words)
    cols = _col_list(cols, row_words)
    tier = tuple(t.to(torch.int32).contiguous() for t in tier)
    b_n, p_n = tier[0].shape
    out = torch.empty((b_n, n_rows, len(cols)), dtype=torch.float32,
                      device=buf.device)
    if n_rows == 0 or b_n == 0:
        return out[0] if single else out
    col_t = (None if cols == list(range(row_words))
             else _build.upload(cols, torch.int32, buf.device))
    buf = buf.contiguous()
    lib = _build.lib("tier_gather.cu")
    with torch.cuda.device(buf.device):
        _build.check(lib.tier_gather(
            buf.data_ptr(), buf.shape[0], page_words,
            *(t.data_ptr() for t in tier), p_n, row_words,
            None if col_t is None else col_t.data_ptr(), len(cols), n_rows,
            b_n, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
            lib.tg_error_string, "tier_gather")
    tier_gather.launches += 1
    return out[0] if single else out


tier_gather.launches = 0


def _gather(buf, tier, n_rows, row_words, cols, page_words):
    if buf.device.type == "cuda":
        return tier_gather(buf, tier, n_rows, row_words, cols, page_words)
    if buf.device.type == "cpu":
        return tier_gather_plain(buf, tier, n_rows, row_words, cols,
                                 page_words)
    raise ValueError(f"no kernel for device {buf.device}")


def gather_rows_tiered(buf: torch.Tensor, tier, n_rows: int, row_words: int,
                       page_words: int) -> torch.Tensor:
    """Tiered analogue of `pool.gather_rows` -> (n_rows, row_words) f32, or
    (B, n_rows, row_words) for a stacked descriptor tuple. Byte-identical
    to gathering the raw pages: cold planes decode to the exact stored bit
    patterns (the codec works on u32 bitcasts, so NaN payloads survive)."""
    return _gather(buf, tier, n_rows, row_words, None, page_words)


def gather_columns_tiered(buf: torch.Tensor, tier, n_rows: int,
                          row_words: int, col_idx, page_words: int
                          ) -> torch.Tensor:
    """Tiered smart addressing -> (n_rows, k) f32 (or (B, n_rows, k)):
    only the projected columns' planes are unpacked (a cold plane's packed
    words are the only memory the column touches — the accounting in
    `FarPool.tier_read_bytes` matches)."""
    return _gather(buf, tier, n_rows, row_words, col_idx, page_words)
