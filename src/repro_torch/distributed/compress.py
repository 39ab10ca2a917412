"""Pool-level page codecs for memory tiering (port of the page-codec half
of `repro/distributed/compress.py`).

LOSSLESS, byte-exact codecs the `FarPool` applies to COLD pages in place:

* `encode_word_page` / `decode_word_page`: fixed-width word pages. Each
  column plane of a page is stored either bit-packed **int-delta** (u32
  wrap-around deltas from a per-(page, column) base, `width` bits each)
  or bit-packed **dictionary** (indices into an inline u32 dictionary),
  whichever costs fewer bits; a plane that compresses to >= 32 bits a
  value falls back to verbatim 32-bit packing, and a PAGE whose stream
  would not fit a frame returns None (the tier bit says "raw").
  Everything operates on the u32 BITCAST of the stored f32 words, never
  on float values, so the roundtrip is exact for any bit pattern (NaNs
  included).

* `encode_blocks` / `decode_blocks`: length-prefixed block codec for
  byte streams (string extents): per-block `[raw_len][enc_len][mode]`
  headers with RLE, zero-strip or stored payloads and a whole-stream CRC.

Both verify a CRC on decode and raise the typed `PageCodecError` (a
`FarviewError`) instead of ever returning wrong bytes. Streams,
descriptors and CRCs are bitwise those of the reference codec. This is
numpy host code: demote and promote are background paths; the device
side of a cold read is `kernels/tier.py`. The reference module's int8
gradient codec comes with the LM substrate (ROADMAP.md queue 1, slice 9).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.errors import PageCodecError

# ------------------------------------------------------------ word-page codec
# per-(page, column) plane modes. MODE_RAW marks a whole RAW page in the
# pool's tier descriptors (never appears inside a PagePlan: a plane that
# doesn't compress is stored as width-32 delta, which decodes verbatim).
MODE_RAW = 0
MODE_DELTA = 1
MODE_DICT = 2

_DICT_MAX = 4096        # dictionary entries per plane (keeps dicts tiny)
_U32 = np.uint64(0xFFFFFFFF)


@dataclass
class PagePlan:
    """One compressed logical page: descriptor arrays + the bit stream.

    The descriptors are exactly what the fused device decoder
    (`kernels/tier.py`) consumes as operands; `bitoff`/`dictoff` are
    STREAM-relative here — the pool rebases them to frame-absolute when
    it places the stream inside a cold frame. `crc` covers the stream
    AND the descriptors, so host decode catches any corruption before
    bytes reach a caller."""
    n_words: int            # logical words this page carries
    phase: int              # (page_index * page_words) % n_cols
    modes: np.ndarray       # (C,) int32: MODE_DELTA | MODE_DICT
    widths: np.ndarray      # (C,) int32: bits per packed value (1..32)
    base: np.ndarray        # (C,) uint32: delta base (0 for dict planes)
    dictoff: np.ndarray     # (C,) int32: dict word offset in stream (-1: none)
    bitoff: np.ndarray      # (C,) int32: packed plane's bit offset in stream
    dictlen: np.ndarray     # (C,) int32: dict words per plane (0: no dict)
    stream: np.ndarray      # (m,) uint32: dicts + packed planes (+1 slack)
    crc: int = 0

    @property
    def stream_words(self) -> int:
        return int(self.stream.shape[0])

    def plane_counts(self, n_cols: int) -> np.ndarray:
        """(C,) values per column plane (how many words of each column
        this page holds, given its phase)."""
        k = np.arange(self.n_words, dtype=np.int64)
        cols = (self.phase + k) % n_cols
        return np.bincount(cols, minlength=n_cols).astype(np.int64)

    def descriptor_crc_payload(self) -> bytes:
        return b"".join([
            struct.pack("<iiii", self.n_words, self.phase, 0, 0),
            self.modes.astype(np.int32).tobytes(),
            self.widths.astype(np.int32).tobytes(),
            self.base.astype(np.uint32).tobytes(),
            self.dictoff.astype(np.int32).tobytes(),
            self.bitoff.astype(np.int32).tobytes(),
            self.dictlen.astype(np.int32).tobytes()])

    def seal(self) -> "PagePlan":
        self.crc = zlib.crc32(self.descriptor_crc_payload()
                              + self.stream.tobytes()) & 0xFFFFFFFF
        return self


def _pack_bits(stream: np.ndarray, vals: np.ndarray, width: int,
               bit0: int) -> None:
    """OR `vals` (u32, `width` bits each) into `stream` starting at bit
    `bit0`. Contributions are bit-disjoint, so bitwise_or.at accumulates
    exactly even when adjacent values share a word."""
    if vals.size == 0:
        return
    pos = bit0 + np.arange(vals.size, dtype=np.int64) * width
    wi = pos >> 5
    sh = (pos & 31).astype(np.uint64)
    big = vals.astype(np.uint64) << sh
    np.bitwise_or.at(stream, wi, (big & _U32).astype(np.uint32))
    np.bitwise_or.at(stream, wi + 1, (big >> np.uint64(32)).astype(np.uint32))


def _unpack_bits(stream: np.ndarray, n: int, width: int,
                 bit0: int) -> np.ndarray:
    """Inverse of `_pack_bits`: n values of `width` bits from `bit0`."""
    if n == 0:
        return np.zeros((0,), np.uint32)
    pos = bit0 + np.arange(n, dtype=np.int64) * width
    wi = pos >> 5
    if int(wi[-1]) + 1 >= stream.shape[0]:
        raise PageCodecError("compressed plane overruns its stream")
    sh = (pos & 31).astype(np.uint64)
    pair = stream[wi].astype(np.uint64) | (
        stream[wi + 1].astype(np.uint64) << np.uint64(32))
    mask = np.uint64((1 << width) - 1) if width < 64 else ~np.uint64(0)
    return ((pair >> sh) & mask).astype(np.uint32)


def encode_word_page(words: np.ndarray, n_cols: int, *, phase: int = 0,
                     page_words: int | None = None) -> "PagePlan | None":
    """Compress one logical page of u32 words (column-plane bit packing).

    `words`: the page's words as uint32 (bitcast of the pool's f32 —
    callers do `f32.view(np.uint32)`). `phase` is the column of the
    page's FIRST word, `(page_index * page_words) % n_cols`, because a
    row may straddle a page boundary when n_cols doesn't divide the
    page size. Returns None when the page is incompressible — the
    stream (plus one slack word for the decoder's 2-word straddle read)
    would not fit inside `page_words` — in which case the pool keeps
    the page raw and its tier bit says so.
    """
    words = np.ascontiguousarray(words, np.uint32)
    n = int(words.shape[0])
    C = int(n_cols)
    modes = np.zeros((C,), np.int32)
    widths = np.ones((C,), np.int32)
    base = np.zeros((C,), np.uint32)
    dictoff = np.full((C,), -1, np.int32)
    bitoff = np.zeros((C,), np.int32)
    dictlen = np.zeros((C,), np.int32)
    cols = (phase + np.arange(n, dtype=np.int64)) % C

    plane_vals: list = []
    plane_dicts: list = []
    for c in range(C):
        v = words[cols == c]
        if v.size == 0:
            modes[c] = MODE_DELTA
            widths[c] = 1
            plane_vals.append(v)
            plane_dicts.append(None)
            continue
        lo = np.uint64(v.min())
        span = int(np.uint64(v.max()) - lo)
        w_delta = max(1, span.bit_length())
        cost_delta = v.size * min(w_delta, 32)
        uniq = np.unique(v)
        k = int(uniq.size)
        w_dict = max(1, (k - 1).bit_length())
        cost_dict = (k * 32 + v.size * w_dict if k <= _DICT_MAX
                     else cost_delta + 1)
        if cost_dict < cost_delta and cost_dict < v.size * 32:
            modes[c] = MODE_DICT
            widths[c] = w_dict
            idx = np.searchsorted(uniq, v).astype(np.uint32)
            plane_vals.append(idx)
            plane_dicts.append(uniq.astype(np.uint32))
        elif w_delta < 32:
            modes[c] = MODE_DELTA
            widths[c] = w_delta
            base[c] = np.uint32(lo)
            plane_vals.append((v.astype(np.uint64)
                               - lo).astype(np.uint32))
            plane_dicts.append(None)
        else:
            # incompressible plane: verbatim 32-bit packing (still exact)
            modes[c] = MODE_DELTA
            widths[c] = 32
            plane_vals.append(v)
            plane_dicts.append(None)

    dict_words = sum(0 if d is None else d.size for d in plane_dicts)
    bits = 0
    for c in range(C):
        bitoff[c] = dict_words * 32 + bits
        bits += plane_vals[c].size * int(widths[c])
    total_words = dict_words + (bits + 31) // 32 + 1     # +1 slack word
    if page_words is not None and total_words >= page_words:
        return None                             # raw fallback (tier bit)

    stream = np.zeros((total_words,), np.uint32)
    off = 0
    for c in range(C):
        d = plane_dicts[c]
        if d is not None:
            dictoff[c] = off
            dictlen[c] = d.size
            stream[off:off + d.size] = d
            off += d.size
    for c in range(C):
        _pack_bits(stream, plane_vals[c], int(widths[c]), int(bitoff[c]))
    return PagePlan(n, int(phase), modes, widths, base, dictoff, bitoff,
                    dictlen, stream).seal()


def decode_word_page(plan: PagePlan, n_cols: int) -> np.ndarray:
    """Exact inverse of `encode_word_page` -> (n_words,) uint32.

    Verifies the CRC over descriptors + stream first and validates every
    descriptor range, raising `PageCodecError` on any mismatch — a
    corrupted cold page is a typed failure, never wrong bytes."""
    crc = zlib.crc32(plan.descriptor_crc_payload()
                     + np.ascontiguousarray(plan.stream).tobytes()
                     ) & 0xFFFFFFFF
    if crc != plan.crc:
        raise PageCodecError(
            f"compressed page failed CRC (stored {plan.crc:#x}, "
            f"computed {crc:#x})")
    C = int(n_cols)
    counts = plan.plane_counts(C)
    out = np.zeros((plan.n_words,), np.uint32)
    cols = (plan.phase + np.arange(plan.n_words, dtype=np.int64)) % C
    for c in range(C):
        n = int(counts[c])
        w = int(plan.widths[c])
        if not 1 <= w <= 32:
            raise PageCodecError(f"plane {c}: invalid width {w}")
        packed = _unpack_bits(plan.stream, n, w, int(plan.bitoff[c]))
        if plan.modes[c] == MODE_DICT:
            d0 = int(plan.dictoff[c])
            if d0 < 0 or d0 >= plan.stream.shape[0]:
                raise PageCodecError(f"plane {c}: dict offset {d0} "
                                     "outside stream")
            top = int(packed.max()) if n else 0
            if d0 + top >= plan.stream.shape[0]:
                raise PageCodecError(f"plane {c}: dict index {top} "
                                     "outside stream")
            vals = plan.stream[d0 + packed.astype(np.int64)]
        elif plan.modes[c] == MODE_DELTA:
            vals = (packed.astype(np.uint64)
                    + np.uint64(plan.base[c])).astype(np.uint32)
        else:
            raise PageCodecError(f"plane {c}: unknown mode "
                                 f"{int(plan.modes[c])}")
        out[cols == c] = vals
    return out


# ------------------------------------------------------- byte-block codec
_BLOCK_MAGIC = b"FVB1"
_BLOCK = 4096           # raw bytes per block (fits the u16 length prefix)


def _run_lengths(chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    edges = np.flatnonzero(chunk[1:] != chunk[:-1]) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [chunk.size]])
    return starts, ends - starts


def _rle_size(chunk: np.ndarray) -> int:
    """Exact encoded size of `_rle_encode(chunk)` WITHOUT materializing it
    (vectorized) — so incompressible blocks never pay the encode loop."""
    if chunk.size == 0:
        return 0
    _, runs = _run_lengths(chunk)
    return int(2 * (runs.size + np.sum((runs - 1) // 255)))


def _rle_encode(chunk: np.ndarray) -> bytes:
    """(count u8, byte) run pairs; runs longer than 255 split."""
    if chunk.size == 0:
        return b""
    starts, runs = _run_lengths(chunk)
    out = bytearray()
    for s, run in zip(starts, runs):
        b = int(chunk[s])
        run = int(run)
        while run > 0:
            take = min(run, 255)
            out.append(take)
            out.append(b)
            run -= take
    return bytes(out)


def _rle_decode(payload: bytes, raw_len: int) -> bytes:
    if len(payload) % 2:
        raise PageCodecError("RLE payload has a dangling half-pair")
    out = bytearray()
    for i in range(0, len(payload), 2):
        out.extend(payload[i + 1:i + 2] * payload[i])
    if len(out) != raw_len:
        raise PageCodecError(
            f"RLE block decoded to {len(out)} bytes, header says {raw_len}")
    return bytes(out)


def _zstrip_encode(chunk: np.ndarray) -> bytes:
    """Zero-strip: a presence bitmap + the nonzero bytes. Targets exactly
    the shape of padded string pages (text runs + zero padding), and both
    directions are fully vectorized."""
    nz = chunk != 0
    return np.packbits(nz).tobytes() + chunk[nz].tobytes()


def _zstrip_decode(payload: bytes, raw_len: int) -> bytes:
    head = (raw_len + 7) // 8
    if len(payload) < head:
        raise PageCodecError("zero-strip block shorter than its bitmap")
    mask = np.unpackbits(
        np.frombuffer(payload[:head], np.uint8))[:raw_len].astype(bool)
    vals = np.frombuffer(payload[head:], np.uint8)
    if vals.size != int(mask.sum()):
        raise PageCodecError(
            f"zero-strip block carries {vals.size} bytes, bitmap wants "
            f"{int(mask.sum())}")
    out = np.zeros((raw_len,), np.uint8)
    out[mask] = vals
    return out.tobytes()


def encode_blocks(data: bytes, *, block: int = _BLOCK) -> bytes:
    """Length-prefixed block codec for byte pages (string tables, padded
    string matrices on the wire): per block `[raw_len u16][enc_len u16]
    [mode u8]` + payload — mode 1 = RLE run pairs, mode 2 = zero-strip
    (presence bitmap + nonzero bytes), mode 0 = stored, whichever is
    smallest — framed by a magic + total length header and a whole-stream
    CRC trailer."""
    if not 1 <= block <= 0xFFFF:
        raise ValueError("block size must fit the u16 length prefix")
    arr = np.frombuffer(bytes(data), np.uint8)
    out = [_BLOCK_MAGIC, struct.pack("<I", arr.size)]
    for s in range(0, arr.size, block):
        chunk = arr[s:s + block]
        rle_n = _rle_size(chunk)
        zs_n = (chunk.size + 7) // 8 + int(np.count_nonzero(chunk))
        best = min(chunk.size, rle_n, zs_n)
        if best == rle_n and rle_n < chunk.size:
            out.append(struct.pack("<HHB", chunk.size, rle_n, 1))
            out.append(_rle_encode(chunk))
        elif best == zs_n and zs_n < chunk.size:
            payload = _zstrip_encode(chunk)
            out.append(struct.pack("<HHB", chunk.size, len(payload), 2))
            out.append(payload)
        else:
            out.append(struct.pack("<HHB", chunk.size, chunk.size, 0))
            out.append(chunk.tobytes())
    out.append(struct.pack("<I", zlib.crc32(bytes(data)) & 0xFFFFFFFF))
    return b"".join(out)


def decode_blocks(buf: bytes) -> bytes:
    """Exact inverse of `encode_blocks`; `PageCodecError` on any framing
    or checksum mismatch."""
    buf = bytes(buf)
    if len(buf) < 12 or buf[:4] != _BLOCK_MAGIC:
        raise PageCodecError("block stream: bad magic")
    (total,) = struct.unpack_from("<I", buf, 4)
    pos, out = 8, bytearray()
    while len(out) < total:
        if pos + 5 > len(buf) - 4:
            raise PageCodecError("block stream truncated mid-header")
        raw_len, enc_len, mode = struct.unpack_from("<HHB", buf, pos)
        pos += 5
        payload = buf[pos:pos + enc_len]
        if len(payload) != enc_len:
            raise PageCodecError("block stream truncated mid-payload")
        pos += enc_len
        if mode == 1:
            out.extend(_rle_decode(payload, raw_len))
        elif mode == 2:
            out.extend(_zstrip_decode(payload, raw_len))
        elif mode == 0:
            if raw_len != enc_len:
                raise PageCodecError("stored block length mismatch")
            out.extend(payload)
        else:
            raise PageCodecError(f"unknown block mode {mode}")
    if len(out) != total:
        raise PageCodecError(
            f"block stream decoded to {len(out)} bytes, header says {total}")
    if pos + 4 > len(buf):
        raise PageCodecError("block stream truncated before CRC trailer")
    (crc,) = struct.unpack_from("<I", buf, pos)
    if zlib.crc32(bytes(out)) & 0xFFFFFFFF != crc:
        raise PageCodecError("block stream failed CRC")
    return bytes(out)
