#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit (`nvidia-smi`);
2. build the CUDA kernels from `src/repro_torch/kernels/csrc/` (`nvcc`,
   one process per source, in parallel);
3. each kernel against its plain torch version on the card, at the main
   path's shapes (B=4 stacked requests of 2^25 rows x 8 f32 columns; the
   cipher over 4 streams of 2^28 words; the grouping over 4 x 2^25 rows
   with 2 value columns at 1024 and at 256 buckets): bitwise equal
   outputs, equal counts, inputs with inf/NaN/-0.0/subnormal words, every
   opcode, OP_SKIP columns, n_valid tails, explicit cipher positions,
   group keys from NaN/inf/+-1e10 words and drop-key rows; group sums
   bitwise on integer values and within 1e-5 of the bucket's sum of |v|
   on N(0,1) values; two grouping launches bitwise equal; the grouping's
   direct path (no sort) and its sort path against the plain version at
   1024 and 256 buckets over uniform and Zipf-skewed keys, both timed
   there and on the drop-key-heavy keys; select_project at 33, 64 and 128
   columns and the grouping at 64 columns with 20 value columns (past the
   caps the port had before); the join probe over B=4
   x 2^26 rows of 3 words (probe keys with NaN/inf/+-2^31/halves, build
   values with inf/NaN payloads/-0.0/subnormals) for builds of 512, 64,
   2^16 and 0 keys, widened as the pipeline calls it, bitwise; the byte
   cipher (`ctr_crypt_bytes`, a string table's pre-decrypt) over B=4 x
   2^22 strings of 64 bytes (1 GiB), exactly, without row ids and with
   shuffled row ids whose row_id * 64 passes 2^31 and 2^32, its own
   inverse, timed beside its plain version, its bound given with the
   operations counted and the SM clock `nvidia-smi` reports.
   Times each (CUDA events, median of 10 after warm-up) beside its plain
   version, a library yardstick where one exists, and its bound; the
   grouping's sort path and its bucket sort are timed on their own;
4. the rows path: `FViewNode(4 GiB)` holding a 2^25-row x 8-column table
   (1 GiB, 512 pool pages; the 8-column schema of
   benchmarks/bench_selection.py) and an encrypted copy, four connections
   each submitting selection (~10%), projection, smart addressing,
   selection + post-encrypt and pre-decrypt + selection in one round;
   flush (with torch's sync debug mode set to raise: nothing before
   finalize may wait for the card), finalize, check every result bitwise
   against the plain path on the same data, check the kernels' launch
   counters moved during the run and that same-signature requests
   stacked; then per-verb p50 and one `torch.profiler` trace of a round
   of each verb (device time by kernel, the device's busy share);
5. the group path, in the same node: a third 1 GiB table `grp` (c0 an i32
   key uniform in [0, 256), the cardinality of benchmarks/
   bench_grouping.py; c1..c7 N(0,1)), four connections each submitting
   GroupBy (1024 buckets), Select + GroupBy and Distinct (256 buckets) in
   one round (connection i reads the table's first 2^25 - i * 2^21 rows,
   so the stacked requests differ), counted and checked the same way:
   each groups payload (sums within 1e-5 of the bucket's sum of |v|) and
   its shipped bytes against the plain path, the four partials merged
   (`merge_group_partials`) against per-key counts and float64 sums;
   then per-verb p50 and a traced round of each verb;
6. the join path, in the same node: a probe table of 2^26 rows (k an
   i32 key uniform in [0, 1024), a and b U[0, 1): the schema of
   benchmarks/bench_join.py, 768 MiB, 384 pool pages) and its two builds
   of 512 and 64 unique keys (50% and 6% of probe rows match); four
   connections (connection i reads the first 2^26 - i * 2^22 rows) each
   submitting join on build512, join on build64, Select(a < 0.5) + join
   and join + post-encrypt in one round. A first round checks each
   build's keys on the host; the counted round after it is flushed under
   sync debug mode "error", counted (one hash_join and one select_project
   launch a dispatch) and checked against the plain path on each
   connection's prefix (count, rows and shipped bytes bitwise); then
   per-verb p50 and a traced round of each verb;
7. the wide path: a 128-column table (Fig. 7's widest tuple) of 2^18
   rows, four connections each submitting Project and SmartAddress of 3
   columns, counted and checked the same way;
8. the dfa_match kernel against its plain version, exactly: widths 16,
   32, 64 and 128 (Fig. 10, benchmarks/bench_regex.py) and the unaligned
   17 and 40, lengths below 0, 0 and past the width, bytes 0 and >= 128,
   ragged n_valid, a stack starting off a 16-byte boundary, patterns of 4
   and 64 DFA states; then B=4 x 2^22 strings of 64 bytes made as
   bench_regex.py makes them (~50% match "err"), timed beside the plain
   version, with its bound;
9. the regex path, in the same node: four string tables of 2^22 strings
   at width 64 (256 MiB of bytes each, made from --seed with numpy as
   bench_regex.py makes them, ~50% matches), four connections each
   submitting RegexMatch and RegexMatch + post-Crypt in one round (2
   dispatches; the post-Crypt ships 1 byte a row and launches no cipher),
   then a round of mixed widths (48 and 64) and row counts that stacks
   into one dispatch, then a pre-decrypt round (Crypt(pre) + RegexMatch
   over the four tables encrypted from --seed: one dispatch, one byte
   cipher launch, one dfa_match launch, and the clear round's masks and
   bytes), then one table in 4 partitions by a seeded permutation, each
   request with its row ids, clear and encrypted (one dispatch each, the
   masks scattered back by row id equal to the whole table's), all
   flushed under sync debug mode "error", counted and checked against the
   plain path (masks, shipped and read bytes by the JAX rules); the
   sideband's stacking (clear and encrypted tables) and upload timed
   alone; per-verb p50 under sync debug mode "error", with the host's
   part of a round beside it, and a traced round splitting device time into the upload of the byte
   sideband, dfa_match and the rest;
10. the decode_attention kernel against its plain version on the card at
   the far-KV path's shape (granite-3-8b's attention block, Hq=32, Hkv=8,
   D=128, over a pool of P=16 shards x B=8 sequences x 2048 rows), bf16
   and f32 caches, lengths 0, 1, ragged and 2048; G=1, G=8, D=64 and
   D=256; l and m within 1e-5 (m exactly -1e30 where a length is 0), o
   within 1e-5 of its sum of |p v| (f32 sums in another order than
   cuBLAS's), both measured against an f64 computation too; +-inf and NaN
   in K and V inside the length and past it (bf16 and f32 caches), held
   to the plain version over V with the rows past the length zeroed (NaN
   and inf in the same places, m = 0 where a score is +inf or NaN, two
   launches bitwise equal); timed beside the plain version and, as a
   yardstick that gives only the merged output,
   `scaled_dot_product_attention(enable_gqa=True)` with the length mask
   over the unsharded cache, with its bound, its share of the bound, its
   GB/s, its ratio to SDPA's time of the same run (printed, not asserted),
   each timed both over 20 launches a run and one launch a run, the blocks
   an SM and the split plan; then the same source built with its
   tensor-core kernel compiled out (-DDA_FMA_ONLY), checked, and its FMA
   kernel timed against the tensor-core kernel at the far-KV path's shapes
   (far full and ragged, naive, local);
11. the far-KV path: granite-3-8b's attention block at full width
   (d_model 4096, bf16 weights and cache, random from --seed), B=8
   sequences of ragged lengths 1..32752 over a pool of 16 shards x 2048
   rows (benchmarks/bench_far_kv.py's shape; a 1 GiB cache per layer,
   depth cut to one block), 16 decode steps through `far_kv.attend_block`
   in each of far, naive and local mode (each sequence appending at its
   own end; the far steps under sync debug mode "error"), every step's
   output held against the other modes and against a plain step over the
   unsharded cache (full attention in plain torch); counted (one
   decode_attention launch a step); p50 per mode, a traced step per mode
   and the modelled shipped bytes per layer;
12. the tier_gather kernel against its plain version, bitwise: random
   descriptors (widths 0..33, bit and dictionary offsets off both ends of
   the frame) at 3, 5, 7 and 8 columns, B = 1 and 4; a small pool's real
   cold frames (every other page cold, delta and dictionary planes of
   widths 1..32, pages starting mid-row, NaN and subnormal payloads,
   null-descriptor padding), one request alone against the same request
   stacked; then the tiered path: a new `FViewNode(3 GiB)` (promotion
   off, as benchmarks/bench_tiering.py sets it) holding a 2^25-row x
   8-word table (1 GiB, bench_selection.py's schema) of bench_tiering.py's
   analytics data (c0 uniform in [0, 64), c1..c7 integer-valued in [0,
   128)), all 512 pages demoted (timed on the host) and `tier_summary`'s
   effective capacity checked >= 1.5, then a hot copy; tier_gather at the
   path's shapes (B=4 stacked requests, every column and 3 columns)
   against the plain version and the written words, timed beside its
   bound and the flat page gather; four connections each submitting
   selection (bench_tiering.py's PIPE), projection, SmartAddress of 3
   columns, GroupBy (c0, 2 value columns, 64 buckets) and selection +
   post-encrypt, each cold round flushed under sync debug mode "error"
   and held bitwise to the same round over the hot copy (rows, counts,
   groups, shipped bytes), its read bytes equal to `tier_read_bytes` and
   below the hot read; counted (one tier_gather launch a cold round);
   per-verb p50 cold and hot and a traced cold round of each verb;
   promote_table of 64 pages timed and held bitwise to the hot copy's
   pages, then every other page cold and each verb's mixed-tier round
   held bitwise to the hot round;
13. a JSON line with every kernel's numbers, and the last line
   `{"ok": true, "device": {...}}`.

Exits 2 without a result where torch sees no CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM: 80 GB HBM3 at 3.35 TB/s
# H100 SXM float32 peak outside the tensor cores (67 TFLOP/s, NVIDIA's data
# sheet: 132 SMs x 128 lanes x 2 flops per FMA x 1.98 GHz), for the
# selection's float compares
FP32_OPS_PER_S = 67e12
# 32-bit integer instructions: the SM issues one warp instruction a clock
# on each of its 4 schedulers, 128 lanes a clock, as many as its FP32
# lanes. The whitepaper's 64 INT32 lanes are one pipe of two: nvcc issues
# integer adds and shifts as IMAD on the FMA pipe beside it (398 of the
# byte kernel's 1,744 SASS instructions, `cuobjdump -sass` of the sm_90a
# build; H100 80GB HBM3, 700.00 W), and the byte cipher ran
# faster (1.985 ms) than 64 lanes allow for its work (2.375 ms; H100 80GB
# HBM3, 700.00 W), so 64 lanes is no bound.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# shared memory: 32 banks of 4 bytes per SM a cycle (NVIDIA's H100
# whitepaper); one DFA transition is one byte lookup, one bank slot
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
# The cipher's instructions per word, counted in the kernel's SASS
# (`cuobjdump -sass` of the sm_90a build): per counter block 2 initial key
# adds, 20 rounds of add + funnel-shift rotate + xor, 5 key injections of
# 2 adds (the round constant folds into a three-input add) = 72; one block
# serves two words, each XORed with its data word once. Index arithmetic
# the kernel also issues is its own overhead, not the function's work.
CIPHER_OPS_PER_WORD = 72 / 2 + 1
# The byte cipher's work, counted the same way: 72 instructions a counter
# block (one block serves two positions) and one XOR a byte. The count of
# blocks is what the data needs: ceil(L / 2) a request without row ids,
# ceil(w / 2) a row with them (a row of odd width needs as many blocks
# whether it starts on an even or an odd position).
CIPHER_OPS_PER_BLOCK = 72
ROWS_LOG2 = 25                # 2^25 rows x 8 f32 words = a 1 GiB table
KEY_PRE, NONCE_PRE = (0x0BADF00D, 0x5EED5EED), 1234
KEY_POST, NONCE_POST = (0x12345678, 0x9ABCDEF0), 99
SEL_THRESHOLD = -1.2815516            # P(N(0,1) < t) = 0.10
N_CONNECTIONS = 4
DROP_KEY = -2**31 + 1                 # the pipeline's masked-row group key
GROUP_KEYS = 256                      # distinct keys of the grp table
GROUP_REL_TOL = 1e-5                  # |sum error| <= tol * sum |v| (bucket)
JOIN_ROWS_LOG2 = 26                   # the probe table: 2^26 rows x 3 words
JOIN_KEYS = 1024                      # probe keys uniform in [0, 1024)
JOIN_BUILDS = (512, 64)               # benchmarks/bench_join.py's builds
WIDE_COLS = (33, 64, 128)             # widths past the old 32-column cap
REGEX_ROWS_LOG2 = 22                  # 2^22 strings x 64 bytes = 256 MiB
REGEX_WIDTH = 64
# 4, 4 and 64 DFA states (compile_regex's default cap is 64)
REGEX_PATTERNS = ("err", "e(r|x)+[a-f]*r?", "(a|e)....[xz]")
DFA_WIDTHS = (16, 32, 64, 128, 17, 40)   # Fig. 10's widths + two unaligned
# far-KV: granite-3-8b's attention block (src/repro/configs/granite_3_8b.py:
# d_model 4096, 32 heads, 8 KV heads, head_dim 128) over benchmarks/
# bench_far_kv.py's pool: B=8 sequences, 16 shards of 2048 rows each
KV_D_MODEL, KV_HQ, KV_HKV, KV_DH = 4096, 32, 8, 128
KV_BATCH, KV_SHARDS, KV_SHARD_ROWS = 8, 16, 2048
KV_STEPS = 16
KV_MODES = ("far", "naive", "local")
# bf16 weights, activations and cache: a step's outputs agree within 2e-2 of
# the largest |output| (bf16 keeps 8 bits; the modes round in other places)
KV_BF16_TOL = 2e-2
# decode_attention vs its plain version: l and m allclose (rtol = atol =
# DA_TOL); o, a sum of up to 2048 signed terms added in another order than
# cuBLAS's, within DA_TOL of its sum of |terms| (the rule of group sums)
DA_TOL = 1e-5
DA_BATCH = 20   # decode_attention and SDPA: launches a timed run
# the tiered path: benchmarks/bench_tiering.py's analytics data over
# bench_selection.py's schema, 2^25 rows x 8 words (1 GiB, 512 pages)
TIER_ROWS_LOG2 = 25
TIER_SMART_IDX = [1, 4, 6]             # SmartAddress's 3 columns
TIER_PROMOTE = 64                      # pages in the timed promotion


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def cuda_ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median of `reps` timed runs (CUDA events) of `batch` back-to-back
    calls, per call, after `warmup` calls. With batch > 1 the host's launch
    time hides behind the device's: the way to time a sub-millisecond
    kernel whose wrapper runs Python."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return statistics.median(times)


def word_err(a, b) -> int:
    """Largest difference between two tensors' 32-bit words read as
    integers: 0 iff bitwise equal."""
    ai = a.contiguous().view(torch.int32)
    bi = b.contiguous().view(torch.int32)
    if torch.equal(ai, bi):
        return 0
    return int((ai.to(torch.int64) - bi.to(torch.int64)).abs().max())


def special_table(gen, shape):
    """N(0,1) words with inf, -inf, NaN (two payloads), -0.0, subnormals
    and exact zeros scattered in, made on the card from `gen`."""
    t = torch.randn(shape, generator=gen, device="cuda")
    bits = t.view(torch.int32).view(-1)
    specials = (0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC0BEEF, 0x80000000,
                0x00000005, 0x807FFFFF, 0x00000000)
    for v in specials:
        where = torch.randint(0, bits.numel(), (bits.numel() // 1000,),
                              generator=gen, device="cuda")
        bits[where] = v - 2**32 if v >= 2**31 else v
    return t


def check_select_project(sp, gen, b, n, report):
    """Kernel vs plain version at the main path's shapes; times the
    selection plan. Returns the kernel's entry of the JSON line."""
    table = special_table(gen, (b, n, 8))
    n_valid = torch.tensor([n, n - 12345, n // 2 + 7, 0][:b],
                           dtype=torch.int32, device="cuda")
    full = torch.full((b,), n, dtype=torch.int32, device="cuda")
    sel = (np.array([0, 1, 0, 0, 0, 0, 0, 0], np.int32),
           np.array([0, SEL_THRESHOLD, 0, 0, 0, 0, 0, 0], np.float32),
           np.ones(8, np.float32))
    plans = {
        "selection": sel,
        "all_ops": (np.array([1, 2, 3, 4, 6, 6, 0, 9], np.int32),
                    np.array([1.5, 1.8, -1.5, -1.8, 0.0, 0.25, 0, 0],
                             np.float32),
                    np.array([1, 0, 1, 1, 0, 1, 0, 1], np.float32)),
        "eq_zero": (np.array([5, 0, 0, 0, 0, 0, 0, 0], np.int32),
                    np.zeros(8, np.float32), np.ones(8, np.float32)),
        "projection": (np.zeros(8, np.int32), np.zeros(8, np.float32),
                       np.array([1, 0, 0, 1, 0, 1, 0, 0], np.float32)),
    }
    err = 0
    for name, plan in plans.items():
        for nv in (full, n_valid):
            got, cnt = sp.select_project(table, *plan, nv)
            exp, ecnt = sp.select_project_plain(table, *plan, nv)
            e = word_err(got, exp)
            if e or not torch.equal(cnt, ecnt):
                raise AssertionError(f"select_project {name}: kernel and "
                                     f"plain differ (word err {e}, counts "
                                     f"{cnt.tolist()} vs {ecnt.tolist()})")
            err = max(err, e)
            report(f"select_project {name} n_valid={nv.tolist()}: counts "
                   f"{cnt.tolist()} bitwise equal")
    # smart addressing gives the kernel two columns
    narrow = table[:, :, [2, 6]].contiguous()
    smart = (np.array([3, 0], np.int32), np.array([-1.0, 0], np.float32),
             np.ones(2, np.float32))
    got, cnt = sp.select_project(narrow, *smart, n_valid)
    exp, ecnt = sp.select_project_plain(narrow, *smart, n_valid)
    if word_err(got, exp) or not torch.equal(cnt, ecnt):
        raise AssertionError("select_project smart: kernel and plain differ")
    report(f"select_project smart (C=2): counts {cnt.tolist()} bitwise equal")
    del narrow, got, exp

    ms = cuda_ms(lambda: sp.select_project(table, *sel, full))
    plain_ms = cuda_ms(lambda: sp.select_project_plain(
        table, *sel, full))
    flat = table.view(b * n, 8)
    mask = flat[:, 1] < SEL_THRESHOLD
    library_ms = cuda_ms(lambda: flat[mask])
    moved = 2 * table.numel() * 4 + b * 4           # rows in, rows + counts out
    compares = b * n                                # one predicate column
    bound = max(moved / HBM_BYTES_PER_S, compares / FP32_OPS_PER_S) * 1e3
    del table, flat, mask
    wide_ms = check_select_project_wide(sp, gen, b, report)
    return {"name": "select_project", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/select_project.cu",
            "replaces": "src/repro/kernels/select_project.py:78",
            "launches": None, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                         >= compares / FP32_OPS_PER_S else "operations"),
            "library_ms": library_ms,
            "shape": [b, n, 8],
            "wide_ms": wide_ms}


def check_select_project_wide(sp, gen, b, report):
    """Kernel vs plain past the old 32-column cap (WIDE_COLS), each stack
    about 1 GiB: a predicate on three columns (the last among them), half
    the columns projected. Returns {columns: kernel ms}."""
    out = {}
    for c in WIDE_COLS:
        n = (1 << 26) // c
        table = special_table(gen, (b, n, c))
        ops = np.zeros(c, np.int32)
        vals = np.zeros(c, np.float32)
        ops[[1, c // 2, c - 1]] = (sp.ref.OP_LT, sp.ref.OP_GE,
                                   sp.ref.OP_NE)
        vals[[1, c // 2, c - 1]] = (0.5, -1.0, 0.0)
        proj = (np.arange(c) % 2 == 0).astype(np.float32)
        n_valid = torch.tensor([n, n - 777, n // 3, 5][:b], dtype=torch.int32,
                               device="cuda")
        got, cnt = sp.select_project(table, ops, vals, proj, n_valid)
        exp, ecnt = sp.select_project_plain(table, ops, vals, proj, n_valid)
        e = word_err(got, exp)
        if e or not torch.equal(cnt, ecnt):
            raise AssertionError(f"select_project at {c} columns: kernel and "
                                 f"plain differ (word err {e})")
        del got, exp
        out[c] = cuda_ms(lambda: sp.select_project(table, ops, vals, proj,
                                                   n_valid))
        report(f"select_project {c} columns, {b}x{n} rows: counts "
               f"{cnt.tolist()} bitwise equal, {out[c]:.3f} ms")
        del table
    return out


def check_ctr_crypt(ctr, gen, b, n_words, report):
    data = torch.randint(-2**31, 2**31 - 1, (b, n_words), generator=gen,
                         device="cuda", dtype=torch.int32)
    # partition-style positions: shuffled row ids * 8 + column, offset so
    # that some pass 2^31 (the uint32 wraparound of the reference)
    rows = torch.randperm(n_words // 8 * b, generator=gen, device="cuda")
    pos = (rows.view(b, -1, 1) * 8 + torch.arange(8, device="cuda")
           + (2**31 - n_words)).view(b, n_words)
    idx = torch.where(pos >= 2**31, pos - 2**32, pos).to(torch.int32)
    del rows, pos
    err = 0
    for name, i in (("stream", None), ("explicit idx", idx)):
        got = ctr.ctr_crypt(data, KEY_POST, NONCE_POST, idx=i)
        exp = ctr.ctr_crypt_plain(data, KEY_POST, NONCE_POST, idx=i)
        e = word_err(got, exp)
        if e:
            raise AssertionError(f"ctr_crypt {name}: kernel and plain differ "
                                 f"(word err {e})")
        err = max(err, e)
        back = ctr.ctr_crypt(got, KEY_POST, NONCE_POST, idx=i)
        if not torch.equal(back, data):
            raise AssertionError(f"ctr_crypt {name}: not its own inverse")
        report(f"ctr_crypt {name}: {b}x{n_words} words bitwise equal, "
               f"involutive")
        del got, exp, back
    del idx
    ms = cuda_ms(lambda: ctr.ctr_crypt(data, KEY_POST, NONCE_POST))
    plain_ms = cuda_ms(lambda: ctr.ctr_crypt_plain(
        data, KEY_POST, NONCE_POST), reps=10, warmup=1)
    words = data.numel()
    t_bytes = 2 * words * 4 / HBM_BYTES_PER_S
    t_ops = words * CIPHER_OPS_PER_WORD / INT32_OPS_PER_S
    return {"name": "ctr_crypt", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ctr_crypt.cu",
            "replaces": "src/repro/kernels/ctr_crypt.py:76",
            "launches": None, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": [b, n_words]}


def sm_clocks():
    """The SM clock now and its maximum, as `nvidia-smi` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check_ctr_crypt_bytes(ctr, gen, b, report):
    """The byte cipher (a string table's pre-decrypt) against its plain
    version at the regex round's shape, B x 2^22 strings of 64 bytes,
    without and with row ids; timed beside the plain version. Returns the
    JSON entry."""
    n, w = 1 << REGEX_ROWS_LOG2, REGEX_WIDTH
    data = torch.randint(0, 256, (b, n * w), generator=gen, device="cuda",
                         dtype=torch.uint8)
    # partition-style row ids: a shuffle of b * n rows, the even ones
    # offset around 2^31 / 64 and the odd ones around 2^32 / 64, so that
    # row_id * 64 passes 2^31 and 2^32 (the uint32 wrap of the reference)
    perm = torch.randperm(b * n, generator=gen, device="cuda")
    ids = (perm + torch.where(perm % 2 == 0, 2**25, 2**26)
           - b * n // 4).to(torch.int32).view(b, n)
    del perm
    for name, i in (("stream", None), ("row ids", ids)):
        got = ctr.ctr_crypt_bytes(data, KEY_PRE, NONCE_PRE, i, w)
        exp = ctr.ctr_crypt_bytes_plain(data, KEY_PRE, NONCE_PRE, i, w)
        if not torch.equal(got, exp):
            raise AssertionError(f"ctr_crypt_bytes {name}: "
                                 f"{int((got != exp).sum())} bytes differ "
                                 f"from the plain version")
        back = ctr.ctr_crypt_bytes(got, KEY_PRE, NONCE_PRE, i, w)
        if not torch.equal(back, data):
            raise AssertionError(f"ctr_crypt_bytes {name}: not its own "
                                 f"inverse")
        report(f"ctr_crypt_bytes {name}: {b}x{n}x{w} bytes equal to the "
               f"plain version, involutive")
        del got, exp, back
    ms = cuda_ms(lambda: ctr.ctr_crypt_bytes(data, KEY_PRE, NONCE_PRE))
    ms_ids = cuda_ms(lambda: ctr.ctr_crypt_bytes(data, KEY_PRE, NONCE_PRE,
                                                 ids, w))
    plain_ms = cuda_ms(lambda: ctr.ctr_crypt_bytes_plain(
        data, KEY_PRE, NONCE_PRE), reps=3, warmup=1)
    clocks = sm_clocks()
    n_bytes = data.numel()
    blocks = b * ((n * w + 1) // 2)
    ops = blocks * CIPHER_OPS_PER_BLOCK + n_bytes
    t_bytes = 2 * n_bytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    ids_ops = b * n * ((w + 1) // 2) * CIPHER_OPS_PER_BLOCK + n_bytes
    t_ids = max((2 * n_bytes + ids.numel() * 4) / HBM_BYTES_PER_S,
                ids_ops / INT32_OPS_PER_S)
    bound = max(t_bytes, t_ops)
    report(f"ctr_crypt_bytes {b}x{n}x{w} bytes: {ms:.3f} ms; with row ids "
           f"{ms_ids:.3f} ms (bound {t_ids * 1e3:.3f}); plain "
           f"{plain_ms:.3f} ms; bound {bound * 1e3:.3f} ms (bytes "
           f"{t_bytes * 1e3:.3f}, {ops} operations = {blocks} blocks x "
           f"{CIPHER_OPS_PER_BLOCK} + {n_bytes} XORs, "
           f"{t_ops * 1e3:.3f} at 128 lanes x 132 SMs x 1.98 GHz); "
           f"{100 * bound * 1e3 / ms:.1f}% of the bound; SM clock now, "
           f"max: {clocks}")
    return {"name": "ctr_crypt_bytes", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ctr_crypt.cu",
            "replaces": "src/repro/kernels/ctr_crypt.py:76",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": [b, n, w], "ms_row_ids": ms_ids,
            "bound_ms_row_ids": t_ids * 1e3, "operations": ops,
            "sm_clocks": clocks}


def f32_words(*pool):
    """uint32 bit patterns -> an f32 tensor on the card."""
    return torch.tensor([w - 2**32 if w >= 2**31 else w for w in pool],
                        dtype=torch.int32, device="cuda").view(torch.float32)


def group_table(gen, b, n):
    """(B, n, 8) f32 stack for the grouping checks: c0 integer keys in
    [0, 4096), c1..c7 N(0,1); one row in a thousand of each kind below
    gets special words: keys 5000-5009 with only zero and subnormal
    values, 6000-6009 with +-inf among them, 7000-7009 with NaNs, and key
    words NaN/+-inf/+-1e10/halves (the key conversion's saturation)."""
    t = torch.randn((b, n, 8), generator=gen, device="cuda")
    t[:, :, 0] = torch.randint(0, 4096, (b, n), generator=gen,
                               device="cuda").float()
    r = torch.arange(n, device="cuda")
    kind, sub = r % 1000, (r // 1000) % 10
    pools = {1: (5000, f32_words(0x0, 0x80000000, 0x5, 0x807FFFFF,
                                 0x80000005, 0x00400000)),
             2: (6000, f32_words(0x7F800000, 0xFF800000, 0x3F800000,
                                 0xBF800000, 0x80000000)),
             3: (7000, f32_words(0x7FC00000, 0x7FC0BEEF, 0xFFC00001,
                                 0x40000000))}
    for code, (base, pool) in pools.items():
        rows = r[kind == code]
        t[:, rows, 0] = (base + sub[rows]).float()
        for c in (1, 2):
            t[:, rows, c] = pool[(rows // 1000 + c) % pool.numel()]
    key_words = f32_words(0x7FC00000, 0x7F800000, 0xFF800000, 0x501502F9,
                          0xD01502F9, 0x40200000, 0xBF000000)
    rows = r[kind == 4]
    t[:, rows, 0] = key_words[(rows // 1000) % key_words.numel()]
    return t


def nan_words(t):
    """int32 words of t with every NaN made one NaN word (NaN compares as
    NaN whatever its payload)."""
    if t.dtype != torch.float32:
        return t
    return torch.where(torch.isnan(t), float("nan"), t).view(torch.int32)


def same_groups(got, exp, abs_sum, rule):
    """Kernel vs plain: exact fields bitwise (NaN as NaN); sums by `rule`.
    Returns the largest |sum difference| over finite sums."""
    for f in ("bucket_keys", "count", "min", "max", "overflow_mask"):
        if not torch.equal(nan_words(got[f]), nan_words(exp[f])):
            raise AssertionError(f"hash_group: {f} differs from the plain "
                                 f"version")
    return same_sums(got["sum"], exp["sum"], abs_sum, rule, "hash_group")


def same_sums(gs, es, abs_sum, rule, what):
    """Group sums: bitwise by rule "bitwise"; else non-finite sums bitwise
    and finite ones within GROUP_REL_TOL of the bucket's sum |v|. Returns
    the largest |difference| over finite sums."""
    if rule == "bitwise":
        if not torch.equal(nan_words(gs), nan_words(es)):
            raise AssertionError(f"{what}: integer sums not bitwise equal")
        return 0.0
    fin = torch.isfinite(es)
    if not torch.equal(nan_words(torch.where(fin, 0.0, gs)),
                       nan_words(torch.where(fin, 0.0, es))):
        raise AssertionError(f"{what}: non-finite sums differ")
    diff = torch.where(fin, (gs.double() - es.double()).abs(), 0.0)
    if bool((diff > GROUP_REL_TOL * abs_sum.double()).any()):
        raise AssertionError(f"{what}: a sum is off by more than "
                             f"{GROUP_REL_TOL} of its bucket's sum |v|")
    return float(diff.max())


def check_hash_group(hg, ref, gen, b, n, report):
    """group_prep and group_aggregate vs their plain versions at the main
    path's shapes, group_aggregate's direct path and its sort path both;
    times both kernels, the sort path, the bucket sort, the plain versions
    and a scatter_reduce yardstick. Returns the two kernels' JSON
    entries."""
    t = group_table(gen, b, n)
    n_valid = torch.tensor([n, n - 12345, n // 2 + 7, 0][:b],
                           dtype=torch.int32, device="cuda")
    ops = np.array([0, 0, 0, 1, 0, 0, 0, 0], np.int32)       # c3 < 1.5
    svals = np.array([0, 0, 0, 1.5, 0, 0, 0, 0], np.float32)
    args = (t, 0, [1, 2], ops, svals, n_valid, DROP_KEY)
    keys, vals = hg.group_prep(*args)
    ek, ev = hg.group_prep_plain(*args)
    if not (torch.equal(keys, ek) and word_err(vals, ev) == 0):
        raise AssertionError("group_prep: kernel and plain differ")
    report(f"group_prep: {b}x{n} rows, keys and values bitwise equal "
           f"({int((keys == DROP_KEY).sum())} drop-key rows)")
    del ek, ev
    prep_ms = cuda_ms(lambda: hg.group_prep(*args))
    prep_plain_ms = cuda_ms(lambda: hg.group_prep_plain(*args), reps=3,
                            warmup=1)
    # the rows below n_valid are read (a row of 8 words is one 32-byte
    # sector), keys and values are written for every row
    prep_bytes = (int(n_valid.sum()) * t.shape[2] * 4 + keys.numel() * 4
                  + vals.numel() * 4)
    prep_entry = {
        "name": "group_prep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hash_group.cu",
        "replaces": "src/repro/core/pipeline.py:706",
        "launches": None, "max_abs_err": 0.0, "ms": prep_ms,
        "plain_ms": prep_plain_ms,
        "bound_ms": prep_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "shape": [b, n, 8]}
    del t

    data = {
        "special": (vals, "tolerance"),
        "integer": (torch.where(torch.isfinite(vals), torch.round(vals * 8),
                                vals), "bitwise"),
        "normal": (torch.randn(vals.shape, generator=gen, device="cuda"),
                   "tolerance"),
    }
    err = 0.0
    times = {}
    for nb in (1024, 256):
        for name, (v, rule) in data.items():
            got = hg.group_aggregate(keys, v, nb)
            again = hg.group_aggregate(keys, v, nb)
            for f in got:
                if not torch.equal(got[f].view(torch.uint8),
                                   again[f].view(torch.uint8)):
                    raise AssertionError(f"hash_group: two launches differ "
                                         f"in {f}")
            del again
            exp = hg.group_aggregate_plain(keys, v, nb)
            abs_sum = (hg.group_aggregate_plain(keys, v.abs(), nb)["sum"]
                       if rule == "tolerance" else None)
            e = same_groups(got, exp, abs_sum, rule)
            err = max(err, e)
            claimed = int((got["bucket_keys"] != ref.KEY_SENTINEL).sum())
            report(f"hash_group {name} values, {nb} buckets: "
                   f"{int(got['overflow_mask'].sum())} overflow rows, "
                   f"{claimed} buckets claimed, exact fields bitwise equal, "
                   f"sums {rule} (max |diff| {e}), two launches bitwise "
                   f"equal")
            del exp, abs_sum
        del got
    lib = hg._build.lib("hash_group.cu")
    skew_ms = cuda_ms(lambda: hg.group_aggregate(keys, data["normal"][0],
                                                 1024))
    ovf = torch.empty((b, n), dtype=torch.bool, device="cuda")
    skew_sort_ms = cuda_ms(lambda: hg._sorted(lib, keys, data["normal"][0],
                                              1024, ovf))
    hot = int((keys == DROP_KEY).sum(dim=1).max())
    report(f"hash_group on these keys, 1024 buckets: {skew_ms:.3f} ms (one "
           f"request's drop-key bucket holds {hot} rows); the sort path "
           f"{skew_sort_ms:.3f} ms ({skew_sort_ms / skew_ms:.2f}x)")
    del data

    # the main path's keys (uniform over GROUP_KEYS) and Zipf-skewed ones,
    # at 1024 and 256 buckets: the direct path (group_aggregate's there)
    # and the sort path against the plain version (integer values
    # bitwise, N(0,1) within tolerance), each twice, bitwise equal, and
    # request 1 alone bitwise equal to it stacked; then both timed at the
    # same shape over N(0,1) values
    keys_by = {"uniform": torch.randint(0, GROUP_KEYS, (b, n), generator=gen,
                                        device="cuda", dtype=torch.int32),
               "skewed": zipf_keys(gen, b, n)}
    v = torch.randn((b, n, 2), generator=gen, device="cuda")
    vint = torch.round(v * 8)
    vw = vals.shape[-1]
    moved = (keys.numel() * (4 + 4 * vw) + keys.numel()
             + b * 1024 * (8 + 12 * vw))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    for kind, ks in keys_by.items():
        for nb in (1024, 256):
            if not hg.direct_chunk(nb):
                raise AssertionError(f"hash_group: {nb} buckets left the "
                                     f"direct path")
            for vals_, rule in ((vint, "bitwise"), (v, "tolerance")):
                exp = hg.group_aggregate_plain(ks, vals_, nb)
                abs_sum = (hg.group_aggregate_plain(ks, vals_.abs(), nb)
                           ["sum"] if rule == "tolerance" else None)
                for path in (hg._direct, hg._sorted):
                    got, again = (path(lib, ks, vals_, nb,
                                       torch.empty_like(ovf))
                                  for _ in range(2))
                    for f in got:
                        if not torch.equal(got[f].view(torch.uint8),
                                           again[f].view(torch.uint8)):
                            raise AssertionError(
                                f"hash_group {path.__name__} {kind}: two "
                                f"launches differ in {f}")
                    err = max(err, same_groups(got, exp, abs_sum, rule))
                    del got, again
                got = hg.group_aggregate(ks, vals_, nb)
                solo = hg.group_aggregate(ks[1:2].contiguous(),
                                          vals_[1:2].contiguous(), nb)
                for f in got:
                    if not torch.equal(got[f][1].view(torch.uint8),
                                       solo[f][0].view(torch.uint8)):
                        raise AssertionError(f"hash_group {kind}: a request "
                                             f"alone differs from it "
                                             f"stacked in {f}")
                del exp, abs_sum, solo
            top = int(torch.bincount(ks[0].long()).max())
            ms = cuda_ms(lambda: hg.group_aggregate(ks, v, nb))
            sort_path_ms = cuda_ms(lambda: hg._sorted(lib, ks, v, nb, ovf))
            times[(kind, nb)] = (ms, sort_path_ms)
            report(f"hash_group {nb} buckets, {kind} keys (the largest key "
                   f"holds {top} of a request's {n} rows): both paths equal "
                   f"to the plain version (exact fields and integer sums "
                   f"bitwise, N(0,1) sums within tolerance), two launches "
                   f"bitwise equal, request 1 alone bitwise equal to it "
                   f"stacked; direct path {ms:.3f} ms "
                   f"({100 * bound_ms / ms:.1f}% of the 1024-bucket "
                   f"bound), sort path {sort_path_ms:.3f} ms "
                   f"({100 * bound_ms / sort_path_ms:.1f}%, "
                   f"{sort_path_ms / ms:.2f}x)")
    del vint
    keys = keys_by["uniform"]
    del keys_by
    for nb in (1024, 256):
        got = hg.group_aggregate(keys, v, nb)
        bucket = ref.bucket_of(keys, nb)
        ms = times[("uniform", nb)][0]
        sort_ms = cuda_ms(lambda: torch.sort(bucket, dim=-1, stable=True))
        times[nb] = (ms, sort_ms)
        report(f"hash_group {nb} buckets, {GROUP_KEYS} uniform keys: kernel "
               f"{ms:.3f} ms; the bucket sort alone (the sort path's) "
               f"{sort_ms:.3f} ms")
        if nb == 1024:
            plain_ms = cuda_ms(lambda: hg.group_aggregate_plain(keys, v, nb),
                               reps=3, warmup=1)
            # yardstick: one scatter_reduce each for sum, min and max over
            # the owned rows (bucket ids and ownership given)
            owned = (~got["overflow_mask"])[..., None]
            idx = (bucket.long() + torch.arange(b, device="cuda")[:, None]
                   * nb).view(-1, 1).expand(-1, v.shape[-1]).contiguous()
            srcs = [torch.where(owned, v, x).view(-1, v.shape[-1])
                    for x in (0.0, float("inf"), -float("inf"))]
            outs = [torch.zeros((b * nb, v.shape[-1]), device="cuda")
                    for _ in range(3)]

            def library():
                for o, src, how in zip(outs, srcs, ("sum", "amin", "amax")):
                    o.scatter_reduce_(0, idx, src, how)
            library_ms = cuda_ms(library)
            del owned, idx, srcs, outs
        del got, bucket
    # past the direct path's limit the sort path is the only one: timed at
    # 8192 and 65536 buckets over keys uniform in [0, 65536), beside one
    # direct pass at 4096 buckets over one value column (claim included),
    # which a direct path over ranges of 4096 buckets would run
    # n_buckets / 4096 x V times
    many = torch.randint(0, 1 << 16, (b, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    v1 = v[..., :1].contiguous()
    one_pass_ms = cuda_ms(lambda: hg._direct(lib, many, v1, 4096, ovf))
    del v1
    for nb in (8192, 65536):
        if hg.direct_chunk(nb):
            raise AssertionError(f"hash_group: {nb} buckets took the direct "
                                 f"path")
        sort_far_ms = cuda_ms(lambda: hg._sorted(lib, many, v, nb, ovf))
        passes = nb // 4096 * v.shape[-1]
        times[("far", nb)] = sort_far_ms
        report(f"hash_group {nb} buckets, keys uniform in [0, 65536): the "
               f"sort path (the only one there) {sort_far_ms:.3f} ms; "
               f"{passes} direct passes over bucket ranges would take about "
               f"{passes * one_pass_ms:.3f} ms (one pass at 4096 buckets "
               f"and one value column {one_pass_ms:.3f} ms)")
    del many, ovf
    report(f"hash_group 1024 buckets, uniform keys: {times[1024][0]:.3f} ms "
           f"against a {bound_ms:.3f} ms bound "
           f"({100 * bound_ms / times[1024][0]:.1f}%); sort path "
           f"{times[('uniform', 1024)][1]:.3f} ms; scatter_reduce x3 "
           f"{library_ms:.3f} ms; plain {plain_ms:.3f} ms")
    entry = {"name": "hash_group", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/hash_group.cu",
             "replaces": "src/repro/kernels/hash_group.py:171",
             "launches": None, "max_abs_err": err, "ms": times[1024][0],
             "sort_ms": times[1024][1], "ms_256_buckets": times[256][0],
             "sort_ms_256_buckets": times[256][1], "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": library_ms, "shape": [b, n, vw, 1024],
             "sort_path_ms": times[("uniform", 1024)][1],
             "sort_path_ms_256_buckets": times[("uniform", 256)][1],
             "ms_skewed": times[("skewed", 1024)][0],
             "sort_path_ms_skewed": times[("skewed", 1024)][1],
             "ms_256_buckets_skewed": times[("skewed", 256)][0],
             "sort_path_ms_256_buckets_skewed": times[("skewed", 256)][1],
             "ms_drop_key_hot": skew_ms,
             "sort_path_ms_drop_key_hot": skew_sort_ms,
             "sort_path_ms_8192_buckets": times[("far", 8192)],
             "sort_path_ms_65536_buckets": times[("far", 65536)],
             "direct_one_pass_ms_4096_buckets": one_pass_ms}
    wide = check_group_wide(hg, gen, b, report)
    entry["ms_c64_v20"], prep_entry["ms_c64_v20"] = wide[:2]
    entry["sort_path_ms_c64_v20"] = wide[2]
    return [entry, prep_entry]


def zipf_keys(gen, b, n):
    """(b, n) int32 keys, Zipf(1.3) over [1, 2^20): key 1 holds ~19% of
    the rows, a long tail the rest (skewed group-by keys)."""
    u = torch.rand((b, n), generator=gen, device="cuda", dtype=torch.float64)
    k = torch.floor(u.clamp(min=1e-12) ** (-1 / 0.3))
    return k.clamp(max=2**20 - 1).to(torch.int32)


def check_group_wide(hg, gen, b, report):
    """group_prep and group_aggregate past the old caps: a 64-column stack
    of 2^20 rows a request, 20 value columns (four chunks of five on the
    direct path), 1024 buckets, vs the plain versions. Returns the two
    kernels' ms and the sort path's."""
    n, c = 1 << 20, 64
    t = special_table(gen, (b, n, c))
    t[:, :, 0] = torch.randint(0, 4096, (b, n), generator=gen,
                               device="cuda").float()
    ops = np.zeros(c, np.int32)
    svals = np.zeros(c, np.float32)
    ops[c - 1], svals[c - 1] = hg.ref.OP_LT, 1.0
    vcols = list(range(40, 60))
    n_valid = torch.tensor([n, n - 999, n // 2, 3][:b], dtype=torch.int32,
                           device="cuda")
    args = (t, 0, vcols, ops, svals, n_valid, DROP_KEY)
    keys, vals = hg.group_prep(*args)
    ek, ev = hg.group_prep_plain(*args)
    if not (torch.equal(keys, ek) and word_err(vals, ev) == 0):
        raise AssertionError("group_prep at 64 columns: kernel and plain "
                             "differ")
    del ek, ev
    got = hg.group_aggregate(keys, vals, 1024)
    exp = hg.group_aggregate_plain(keys, vals, 1024)
    abs_sum = hg.group_aggregate_plain(keys, vals.abs(), 1024)["sum"]
    e = same_groups(got, exp, abs_sum, "tolerance")
    del got, exp, abs_sum
    prep_ms = cuda_ms(lambda: hg.group_prep(*args))
    agg_ms = cuda_ms(lambda: hg.group_aggregate(keys, vals, 1024))
    ovf = torch.empty(keys.shape, dtype=torch.bool, device="cuda")
    sort_ms = cuda_ms(lambda: hg._sorted(hg._build.lib("hash_group.cu"),
                                         keys, vals, 1024, ovf))
    report(f"group_prep + hash_group at {c} columns, {len(vcols)} value "
           f"columns, {b}x{n} rows: keys and values bitwise equal, groups "
           f"equal (sums within {e:.3g}); group_prep {prep_ms:.3f} ms, "
           f"hash_group {agg_ms:.3f} ms ({hg.direct_chunk(1024)} value "
           f"columns a chunk), its sort path {sort_ms:.3f} ms")
    return agg_ms, prep_ms, sort_ms


def join_probe(gen, b, n):
    """(B, n, 3) f32 probe stack of the join path's schema: k integer keys
    uniform in [0, JOIN_KEYS), a and b U[0, 1); one row in a thousand has
    a special key word (NaN, +-inf, +-2^31, halves: the saturating
    conversion)."""
    probe = torch.rand((b, n, 3), generator=gen, device="cuda")
    probe[..., 0] = torch.randint(0, JOIN_KEYS, (b, n), generator=gen,
                                  device="cuda").float()
    words = f32_words(0x7FC00000, 0x7F800000, 0xFF800000, 0x4F000000,
                      0xCF000000, 0x40200000, 0xBF000000, 0x40600000,
                      0x3F000000)
    r = torch.arange(n, device="cuda")
    rows = r[r % 1000 == 7]
    probe[:, rows, 0] = words[(rows // 1000) % words.numel()]
    return probe


def join_build(gen, k):
    """k unique build keys (from [0, 2k) or [0, JOIN_KEYS), whichever is
    larger, with INT32_MAX and INT32_MIN among them so that saturated
    probe keys hit) and one value column with special words among U[0, 1)
    values: +-inf, NaN with two payloads, -0.0 and subnormals."""
    keys = torch.randperm(max(JOIN_KEYS, 2 * k), generator=gen,
                          device="cuda")[:k].to(torch.int32)
    if k >= 2:
        keys[0], keys[1] = 2**31 - 1, -2**31
    vals = torch.rand((k, 1), generator=gen, device="cuda")
    specials = f32_words(0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC0BEEF,
                         0x80000000, 0x00000005, 0x807FFFFF)
    m = min(k, specials.numel())
    vals[:m, 0] = specials[:m]
    return keys, vals


def check_hash_join(hj, ref, gen, b, n, report):
    """hash_join vs its plain version at the join path's shape: B=4 x 2^26
    probe rows of 3 words, key column 0, widened into (B, n, 5) rows as
    the pipeline calls it, for bench_join.py's builds of 512 and 64 keys,
    for 2^16 keys (past what shared memory holds) and for an empty build;
    bitwise. Times each build (CUDA events), the plain version and a
    library yardstick at 512 keys. Returns the JSON entry."""
    probe = join_probe(gen, b, n)
    n_valid = torch.tensor([n, n - 12345, n // 2 + 7, 0][:b],
                           dtype=torch.int32, device="cuda")
    full = torch.full((b,), n, dtype=torch.int32, device="cuda")
    builds = {k: join_build(gen, k) for k in (512, 64, 1 << 16, 0)}
    wide = torch.empty((b, n, 5), device="cuda")
    err = 0
    for k, (bk, bv) in builds.items():
        for nv in (full, n_valid):
            got = hj.hash_join(probe, 0, bk, bv, nv, out=wide)
            exp = hj.hash_join_plain(probe, 0, bk, bv, nv,
                                     out=torch.empty_like(wide))
            e = word_err(got, exp)
            del exp
            if e:
                raise AssertionError(f"hash_join K={k}: kernel and plain "
                                     f"differ (word err {e})")
            err = max(err, e)
            hits = got[..., 4].sum(dim=1).long().tolist()
            report(f"hash_join K={k} n_valid={nv.tolist()}: hits {hits}, "
                   f"widened rows bitwise equal")
    ms = {k: cuda_ms(lambda: hj.hash_join(probe, 0, *builds[k], full,
                                          out=wide))
          for k in (512, 64, 1 << 16)}
    bk, bv = builds[512]
    plain_ms = cuda_ms(lambda: hj.hash_join_plain(probe, 0, bk, bv, full,
                                                  out=wide),
                       reps=5, warmup=1)
    # yardstick: keys already converted, the build sorted once; one
    # searchsorted, a compare, a gather of the matched values and the
    # widened rows built with torch.cat
    ikeys = ref.rint_to_int32(probe[..., 0]).contiguous()
    sk, order = torch.sort(bk)
    sv = bv[order]

    def library():
        idx = torch.searchsorted(sk, ikeys).clamp_(max=sk.numel() - 1)
        hit = sk[idx] == ikeys
        return torch.cat([probe, torch.where(hit[..., None], sv[idx], 0.0),
                          hit[..., None].float()], 2)
    library_ms = cuda_ms(library)
    del ikeys, wide
    report(f"hash_join {b}x{n} rows widened to 5 words: K=512 "
           f"{ms[512]:.3f} ms, K=64 {ms[64]:.3f} ms, K=65536 "
           f"{ms[1 << 16]:.3f} ms; plain {plain_ms:.3f} ms, searchsorted + "
           f"gather + cat {library_ms:.3f} ms")
    w, v = probe.shape[2], bv.shape[1]
    moved = b * n * w * 4 + b * n * (w + v + 1) * 4 + 512 * (1 + v) * 4
    compares = b * n * 9                            # log2(512) a row
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = compares / INT32_OPS_PER_S
    return {"name": "hash_join", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hash_join.cu",
            "replaces": "src/repro/kernels/hash_join.py:62",
            "launches": None, "max_abs_err": float(err), "ms": ms[512],
            "ms_k64": ms[64], "ms_k65536": ms[1 << 16],
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": [b, n, w, 512]}


def rows_path(fv, op, sp, ctr, kernels, gen, node, qps, n_rows, report):
    """Drive the rows-kind verbs once through the node; returns the launch
    counts of the counted run and the per-verb p50s."""
    cols = tuple(fv.Column(f"c{i}") for i in range(8))
    ft = fv.alloc_table_mem(qps[0], fv.FTable("sel", cols, n_rows=n_rows))
    words = torch.randn((n_rows, 8), generator=gen, device="cuda")
    fv.table_write(qps[0], ft, words)
    ft_enc = fv.alloc_table_mem(qps[0],
                                fv.FTable("sel_enc", cols, n_rows=n_rows))
    enc = ctr.ctr_crypt(words.view(torch.int32).view(1, -1), KEY_PRE,
                        NONCE_PRE)
    fv.table_write(qps[0], ft_enc, enc.view(torch.float32).view(n_rows, 8))
    del enc
    report(f"pool: {node.pool.n_pages} pages, tables of "
           f"{len(ft.pages)} + {len(ft_enc.pages)} pages")

    sel = op.Select((op.Predicate("c1", "<", SEL_THRESHOLD),))
    verbs = {
        "selection": (ft, (sel,)),
        "projection": (ft, (op.Project(("c0", "c3", "c5")),)),
        "smart_addressing": (ft, (op.SmartAddress(("c2", "c6")),)),
        "selection_post_encrypt": (ft, (sel, op.Crypt(KEY_POST, NONCE_POST,
                                                      "post"))),
        "pre_decrypt_selection": (ft_enc, (op.Crypt(KEY_PRE, NONCE_PRE,
                                                    "pre"), sel)),
    }

    # ---- the counted run: every connection submits every verb, one flush
    reset_launches(kernels)
    d0 = node.dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the lazy contract: submit and flush never wait for the card (torch
    # raises on any synchronising call while the debug mode is "error")
    torch.cuda.set_sync_debug_mode("error")
    pending = {name: [fv.submit_request(qp, t, p) for qp in qps]
               for name, (t, p) in verbs.items()}
    node.flush()
    torch.cuda.set_sync_debug_mode("default")
    results = {name: [r.wait() for r in reqs]
               for name, reqs in pending.items()}
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    dispatches = node.dispatches - d0
    report(f"rows path: {N_CONNECTIONS * len(verbs)} requests in "
           f"{dispatches} dispatches, {run_ms:.3f} ms, launches {launches}, "
           f"no host sync before finalize")
    if dispatches != len(verbs):
        raise AssertionError(f"{dispatches} dispatches for {len(verbs)} "
                             f"distinct signatures: requests did not stack")
    for name in ("select_project", "ctr_crypt"):
        if launches[name] == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"rows path")

    # ---- every result against the plain path on the same data
    nv = torch.tensor([n_rows], dtype=torch.int32, device="cuda")
    ops_sel = np.zeros(8, np.int32)
    vals_sel = np.zeros(8, np.float32)
    ops_sel[1], vals_sel[1] = op.OPS["<"], SEL_THRESHOLD
    proj_all = np.ones(8, np.float32)
    proj3 = np.zeros(8, np.float32)
    proj3[[0, 3, 5]] = 1
    sel_rows, sel_cnt = sp.select_project_plain(words[None], ops_sel,
                                                vals_sel, proj_all, nv)
    post = ctr.ctr_crypt_plain(sel_rows.view(torch.int32).view(1, -1),
                               KEY_POST, NONCE_POST)
    expected = {
        "selection": (sel_rows, sel_cnt, 8),
        "projection": sp.select_project_plain(
            words[None], np.zeros(8, np.int32), np.zeros(8, np.float32),
            proj3, nv) + (3,),
        "smart_addressing": sp.select_project_plain(
            words[None][:, :, [2, 6]].contiguous(), np.zeros(2, np.int32),
            np.zeros(2, np.float32), np.ones(2, np.float32), nv) + (2,),
        "selection_post_encrypt": (post.view(torch.float32).view(
            sel_rows.shape), sel_cnt, 8),
        "pre_decrypt_selection": (sel_rows, sel_cnt, 8),
    }
    read = shipped = 0
    for name, res_list in results.items():
        rows, cnt, width = expected[name]
        for res in res_list:
            if res.count != int(cnt[0]) or word_err(res.rows,
                                                    rows[0]):
                raise AssertionError(f"{name}: result differs from the "
                                     f"plain path")
            if res.shipped_bytes != res.count * width * 4:
                raise AssertionError(f"{name}: shipped bytes "
                                     f"{res.shipped_bytes}")
        report(f"{name}: {res_list[0].count} of {n_rows} rows, "
               f"{N_CONNECTIONS} results bitwise equal to the plain path")
    for qp in qps:
        read += qp.bytes_read_pool
        shipped += qp.bytes_shipped
    report(f"bytes: read {read}, shipped {shipped}")
    del results, pending, expected, sel_rows, post

    # ---- per-verb p50: one stacked round of all connections, 5 repeats
    p50 = verb_p50(fv, node, qps, verbs, report)
    profile_rounds(fv, node, qps, verbs, report)
    return launches, p50


def submit_round(fv, qps, t, p):
    """One request per connection: `t` is one table for all of them, or a
    list of one table each; a string table comes as (table, strings,
    lengths), its byte sideband."""
    ts = t if isinstance(t, list) else [t] * len(qps)
    out = []
    for qp, x in zip(qps, ts):
        if isinstance(x, tuple):
            ft, mat, lens = x
            out.append(fv.submit_request(qp, ft, p, strings=mat,
                                         lengths=lens))
        else:
            out.append(fv.submit_request(qp, x, p))
    return out


def verb_p50(fv, node, qps, verbs, report, strict=False):
    """Per-verb p50: one stacked round of all connections, 5 repeats, the
    verbs in turn within each repeat (so that rounds whose host time
    drifts over seconds, as the regex rounds' does, are compared at the
    same moments); `strict` flushes each under sync debug mode "error".
    Each verb's line also gives the host's part, submit to the flush's
    return (stacking a sideband, launching), beside its p50."""
    times = {name: [] for name in verbs}
    host = {name: [] for name in verbs}
    for name in [name for _ in range(5) for name in verbs]:
        t, p = verbs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            reqs = submit_round(fv, qps, t, p)
            node.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        for r in reqs:
            r.wait()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        host[name].append((t1 - t0) * 1e3)
    p50 = {}
    for name in verbs:
        p50[name] = statistics.median(times[name])
        report(f"p50 {name}: {p50[name]:.3f} ms for {N_CONNECTIONS} "
               f"stacked requests (runs "
               f"{[round(x, 3) for x in times[name]]}; host to flush p50 "
               f"{statistics.median(host[name]):.3f} ms)")
    return p50


def profile_rounds(fv, node, qps, verbs, report, focus=None):
    """One traced round of each verb: device time by operation (top 8),
    the host-to-device uploads' share and the device's busy share of the
    round's wall clock; with `focus`, the device time of the operations
    whose name holds it, and of the rest."""
    from torch.profiler import ProfilerActivity, profile
    for name, (t, p) in verbs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reqs = submit_round(fv, qps, t, p)
            node.flush()
            for r in reqs:
                r.wait()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        h2d = sum(d for d, k, _ in rows if "HtoD" in k)
        report(f"profile {name}: wall {wall_us / 1e3:.3f} ms, device busy "
               f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%, idle "
               f"{100 - 100 * busy / wall_us:.1f}%), of it uploads "
               f"{h2d / 1e3:.3f} ms ({100 * h2d / wall_us:.1f}% of wall); "
               "top: " + "; ".join(f"{k[:48]} x{c} {d / 1e3:.3f} ms"
                                   for d, k, c in rows[:8]))
        if focus is not None:
            ups = [round(evt.time_range.elapsed_us() / 1e3, 3)
                   for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CUDA
                   and "HtoD" in evt.name]
            report(f"profile {name} uploads, ms each: {ups}")
            mine = sum(d for d, k, _ in rows if focus in k)
            report(f"profile {name} split: uploads {h2d / 1e3:.3f} ms, "
                   f"{focus} {mine / 1e3:.3f} ms, rest "
                   f"{(busy - h2d - mine) / 1e3:.3f} ms; busy "
                   f"{100 * busy / wall_us:.1f}%, idle "
                   f"{100 - 100 * busy / wall_us:.1f}% of "
                   f"{wall_us / 1e3:.3f} ms")


def device_rows(prof):
    """[(device us, name, count)] of a trace's device-side events
    (kernels, copies), largest first: the host ops that launched them
    carry the same time again."""
    per: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            d, c = per.get(evt.name, (0.0, 0))
            per[evt.name] = (d + evt.time_range.elapsed_us(), c + 1)
    return sorted(((d, k, c) for k, (d, c) in per.items()), reverse=True)


def plain_groups(hg, sp, op, words, pipe, n_valid):
    """One request's groups payload computed by the plain versions alone,
    from the table's words (n, 8) of which the first n_valid rows are the
    request's: prologue, aggregation, then the collision rows stably
    packed to the front. Also each bucket's sum of |v| ("abs_sum")."""
    n = words.shape[0]
    ops = np.zeros(8, np.int32)
    svals = np.zeros(8, np.float32)
    group = distinct = None
    for o in pipe:
        if isinstance(o, op.Select):
            for pr in o.predicates:
                i = int(pr.col[1:])
                ops[i], svals[i] = op.OPS[pr.op], pr.value
        elif isinstance(o, op.GroupBy):
            group = o
        elif isinstance(o, op.Distinct):
            distinct = o
    if group is not None:
        kcol, vcols, nb = int(group.key[1:]), [int(c[1:]) for c in
                                               group.values], group.n_buckets
    else:
        kcol = int(distinct.cols[0][1:])
        vcols, nb = [kcol], distinct.n_buckets
    nv = torch.tensor([n_valid], dtype=torch.int32, device="cuda")
    keys, vals = hg.group_prep_plain(words[None], kcol, vcols, ops, svals, nv,
                                     DROP_KEY)
    res = hg.group_aggregate_plain(keys, vals, nb)
    abs_sum = hg.group_aggregate_plain(keys, vals.abs(), nb)["sum"][0]
    keep = res["overflow_mask"] & (keys != DROP_KEY)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    cnt = int(keep.sum())
    v = len(vcols)
    out = {f: x[0] for f, x in res.items() if f != "overflow_mask"}
    out["ovf_keys"] = keys.gather(-1, order)[0, :cnt]
    out["ovf_vals"] = vals.gather(1, order[..., None].expand(1, n, v))[0,
                                                                        :cnt]
    out["shipped"] = nb * (2 + 4 * v) * 4 + cnt * (1 + v) * 4
    out["abs_sum"] = abs_sum
    return out


def group_path(fv, op, hg, sp, kernels, gen, node, qps, n_rows, report):
    """Drive the group verbs once through the node (a third 1 GiB table);
    returns the launch counts of the counted run and the per-verb p50s.
    Connection i reads the table's first n_rows - i * n_rows / 16 rows, so
    the four stacked requests have different data (ragged n_valid)."""
    cols = (fv.Column("c0", "i32"),) + tuple(fv.Column(f"c{i}")
                                             for i in range(1, 8))
    ft = fv.alloc_table_mem(qps[0], fv.FTable("grp", cols, n_rows=n_rows))
    words = torch.randn((n_rows, 8), generator=gen, device="cuda")
    words[:, 0] = torch.randint(0, GROUP_KEYS, (n_rows,), generator=gen,
                                device="cuda").float()
    fv.table_write(qps[0], ft, words)
    views = [dataclasses.replace(ft, n_rows=n_rows - i * (n_rows // 16))
             for i in range(len(qps))]
    report(f"pool: table grp of {len(ft.pages)} pages, {GROUP_KEYS} keys; "
           f"connections read its first {[v.n_rows for v in views]} rows")
    verbs = {
        "group_by": (views, (op.GroupBy("c0", ("c1", "c2"),
                                        n_buckets=1024),)),
        "selection_group_by": (views, (
            op.Select((op.Predicate("c3", "<", 0.0),)),
            op.GroupBy("c0", ("c1",), aggs=("count", "sum", "min", "max")))),
        "distinct": (views, (op.Distinct(("c0",), n_buckets=256),)),
    }

    reset_launches(kernels)
    d0 = node.dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    pending = {name: submit_round(fv, qps, t, p)
               for name, (t, p) in verbs.items()}
    node.flush()
    torch.cuda.set_sync_debug_mode("default")
    results = {name: [r.wait() for r in reqs]
               for name, reqs in pending.items()}
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    dispatches = node.dispatches - d0
    report(f"group path: {N_CONNECTIONS * len(verbs)} requests in "
           f"{dispatches} dispatches, {run_ms:.3f} ms, launches {launches}, "
           f"no host sync before finalize")
    if dispatches != len(verbs):
        raise AssertionError(f"{dispatches} dispatches for {len(verbs)} "
                             f"distinct signatures: requests did not stack")
    for name in ("group_prep", "hash_group", "select_project"):
        if launches[name] == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"group path")

    keys = words[:, 0].long()
    # how many connections read each row: the weight of its merged total
    weight = sum((torch.arange(n_rows, device="cuda") < v.n_rows).double()
                 for v in views)
    for name, res_list in results.items():
        pipe = verbs[name][1]
        worst = 0.0
        for view, res in zip(views, res_list):
            exp = plain_groups(hg, sp, op, words, pipe, view.n_rows)
            g = res.groups
            for f in ("bucket_keys", "count", "min", "max"):
                if not torch.equal(nan_words(g[f]), nan_words(exp[f])):
                    raise AssertionError(f"{name}: {f} differs from the "
                                         f"plain path")
            worst = max(worst, same_sums(g["sum"], exp["sum"],
                                         exp["abs_sum"], "tolerance", name))
            if not (np.array_equal(g["ovf_keys"], exp["ovf_keys"].cpu().numpy())
                    and np.array_equal(
                        g["ovf_vals"].view(np.uint32),
                        exp["ovf_vals"].cpu().numpy().view(np.uint32))):
                raise AssertionError(f"{name}: collision rows differ from "
                                     f"the plain path")
            if res.shipped_bytes != exp["shipped"]:
                raise AssertionError(f"{name}: shipped bytes "
                                     f"{res.shipped_bytes} vs {exp['shipped']}")
            del exp
        # all four partials merged against per-key counts and float64 sums
        # of the rows each connection read
        w = weight
        if isinstance(pipe[0], op.Select):
            w = torch.where(words[:, 3] < 0.0, weight, 0.0)
        vcol = 1 if name != "distinct" else 0
        cnt = torch.bincount(keys, weights=w, minlength=GROUP_KEYS)
        cnt = cnt.round().long().cpu().numpy()
        s64 = torch.zeros(GROUP_KEYS, dtype=torch.float64, device="cuda")
        s64.index_add_(0, keys, words[:, vcol].double() * w)
        a64 = torch.zeros(GROUP_KEYS, dtype=torch.float64, device="cuda")
        a64.index_add_(0, keys, words[:, vcol].abs().double() * w)
        s64, a64 = s64.cpu().numpy(), a64.cpu().numpy()
        merged = fv.merge_group_partials(ft, pipe, res_list).groups
        if sorted(merged) != [i for i in range(GROUP_KEYS) if cnt[i]]:
            raise AssertionError(f"{name}: merged keys differ")
        merged_worst = 0.0
        for key, (c, s, _, _) in merged.items():
            if c != cnt[key]:
                raise AssertionError(f"{name}: key {key} count {c} vs "
                                     f"{cnt[key]}")
            d = abs(float(s[0]) - s64[key])
            if d > GROUP_REL_TOL * a64[key]:
                raise AssertionError(f"{name}: key {key} sum off by {d}")
            merged_worst = max(merged_worst, d / max(a64[key], 1e-30))
        ovf = [int(r.groups["ovf_keys"].shape[0]) for r in res_list]
        report(f"{name}: collision rows per connection {ovf}; "
               f"{N_CONNECTIONS} payloads equal to the plain path (sums "
               f"within {worst:.3g} absolute); all {N_CONNECTIONS} merged: "
               f"{len(merged)} keys, counts exact, sums within "
               f"{merged_worst:.3g} of sum |v| (float64)")
    del results, pending, weight
    p50 = verb_p50(fv, node, qps, verbs, report)
    profile_rounds(fv, node, qps, verbs, report)
    return launches, p50


def plain_join(hj, sp, ctr, op, words, bk, bv, pipe, n_valid):
    """One join request's rows computed by the plain versions alone from
    the probe table's words (n, 3), of which the first n_valid rows are
    the request's: probe, the widened table, select/project/pack (the hit
    column an ==1 predicate, zeroed), then the response cipher."""
    rows = words[:n_valid][None]
    nv = torch.tensor([n_valid], dtype=torch.int32, device="cuda")
    wide = hj.hash_join_plain(rows, 0, bk, bv, nv)
    c = wide.shape[2]
    ops = np.zeros(c, np.int32)
    vals = np.zeros(c, np.float32)
    proj = np.ones(c, np.float32)
    ops[-1], vals[-1], proj[-1] = op.OPS["=="], 1.0, 0.0
    for o in pipe:
        if isinstance(o, op.Select):
            for pr in o.predicates:
                i = ("k", "a", "b").index(pr.col)
                ops[i], vals[i] = op.OPS[pr.op], pr.value
    packed, cnt = sp.select_project_plain(wide, ops, vals, proj, nv)
    if isinstance(pipe[-1], op.Crypt):
        packed = ctr.ctr_crypt_plain(
            packed.view(torch.int32).view(1, -1), pipe[-1].key,
            pipe[-1].nonce).view(torch.float32).view(packed.shape)
    return packed[0], int(cnt[0])


def join_path(fv, op, hj, sp, ctr, kernels, gen, node, qps, report):
    """Drive the join verbs through the node: a probe table of 2^26 rows
    and bench_join.py's two builds. A cold round checks each build's keys
    on the host; the counted warm round after it flushes under sync debug
    mode "error". Returns the counted run's launches and per-verb p50s."""
    n_rows = 1 << JOIN_ROWS_LOG2
    ft = fv.alloc_table_mem(qps[0], fv.FTable(
        "probe", (fv.Column("k", "i32"), fv.Column("a"), fv.Column("b")),
        n_rows=n_rows))
    words = torch.rand((n_rows, 3), generator=gen, device="cuda")
    words[:, 0] = torch.randint(0, JOIN_KEYS, (n_rows,), generator=gen,
                                device="cuda").float()
    fv.table_write(qps[0], ft, words)
    builds = {}
    for k in JOIN_BUILDS:
        bft = fv.alloc_table_mem(qps[0], fv.FTable(
            f"build{k}", (fv.Column("k", "i32"), fv.Column("v")), n_rows=k))
        bk = torch.randperm(JOIN_KEYS, generator=gen,
                            device="cuda")[:k].to(torch.int32)
        bv = torch.rand((k, 1), generator=gen, device="cuda")
        fv.table_write(qps[0], bft, torch.cat([bk[:, None].float(), bv], 1))
        builds[k] = (bk, bv)
    views = [dataclasses.replace(ft, n_rows=n_rows - i * (n_rows // 16))
             for i in range(len(qps))]
    match = {k: float(torch.isin(words[:, 0].to(torch.int32), bk).double()
                      .mean()) for k, (bk, _) in builds.items()}
    report(f"pool: table probe of {len(ft.pages)} pages, builds of "
           f"{JOIN_BUILDS} keys matching {match} of its rows; connections "
           f"read its first {[v.n_rows for v in views]} rows")

    def join(k):
        return op.JoinSmall("k", f"build{k}", "k", ("v",))
    verbs = {
        "join_512": (views, (join(512),)),
        "join_64": (views, (join(64),)),
        "selection_join_512": (views, (
            op.Select((op.Predicate("a", "<", 0.5),)), join(512))),
        "join_512_post_encrypt": (views, (
            join(512), op.Crypt(KEY_POST, NONCE_POST, "post"))),
    }
    # the cold round: each build's keys are checked unique on the host
    for t, p in verbs.values():
        for r in submit_round(fv, qps, t, p):
            r.wait()

    reset_launches(kernels)
    d0 = node.dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    pending = {name: submit_round(fv, qps, t, p)
               for name, (t, p) in verbs.items()}
    node.flush()
    torch.cuda.set_sync_debug_mode("default")
    results = {name: [r.wait() for r in reqs]
               for name, reqs in pending.items()}
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    dispatches = node.dispatches - d0
    report(f"join path: {N_CONNECTIONS * len(verbs)} requests in "
           f"{dispatches} dispatches, {run_ms:.3f} ms, launches {launches}, "
           f"a warm round with no host sync before finalize")
    if dispatches != len(verbs):
        raise AssertionError(f"{dispatches} dispatches for {len(verbs)} "
                             f"distinct signatures: requests did not stack")
    if launches["hash_join"] != dispatches or \
            launches["select_project"] != dispatches:
        raise AssertionError(f"join path: expected one hash_join and one "
                             f"select_project launch a dispatch, got "
                             f"{launches}")
    if launches["ctr_crypt"] != 1:
        raise AssertionError("join path: the post-encrypt verb did not "
                             "launch ctr_crypt once")

    for name, res_list in results.items():
        pipe = verbs[name][1]
        k = 64 if name == "join_64" else 512
        for view, res in zip(views, res_list):
            rows, cnt = plain_join(hj, sp, ctr, op, words, *builds[k], pipe,
                                   view.n_rows)
            if res.count != cnt or word_err(res.rows, rows):
                raise AssertionError(f"{name}: result differs from the "
                                     f"plain path")
            if res.shipped_bytes != cnt * (3 + 1) * 4:
                raise AssertionError(f"{name}: shipped bytes "
                                     f"{res.shipped_bytes}")
            if res.read_bytes != view.n_rows * 3 * 4:
                raise AssertionError(f"{name}: read bytes {res.read_bytes}")
            del rows
        report(f"{name}: counts {[r.count for r in res_list]}, "
               f"{N_CONNECTIONS} results bitwise equal to the plain path")
    del results, pending
    p50 = verb_p50(fv, node, qps, verbs, report)
    profile_rounds(fv, node, qps, verbs, report)
    return launches, p50


def wide_path(fv, op, sp, kernels, gen, node, qps, report):
    """Project and SmartAddress of 3 columns over a 128-column table (Fig.
    7's widest tuple, benchmarks/bench_projection.py) through the node,
    counted and checked against the plain path. Returns the launches and
    per-verb p50s."""
    n_rows, c = 1 << 18, 128
    ft = fv.alloc_table_mem(qps[0], fv.FTable(
        "wide", tuple(fv.Column(f"c{i}") for i in range(c)), n_rows=n_rows))
    words = torch.randn((n_rows, c), generator=gen, device="cuda")
    fv.table_write(qps[0], ft, words)
    cols = ("c0", "c1", "c2")
    verbs = {"projection_128": (ft, (op.Project(cols),)),
             "smart_addressing_128": (ft, (op.SmartAddress(cols),))}
    reset_launches(kernels)
    pending = {name: submit_round(fv, qps, t, p)
               for name, (t, p) in verbs.items()}
    node.flush()
    results = {name: [r.wait() for r in reqs]
               for name, reqs in pending.items()}
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if launches["select_project"] != len(verbs):
        raise AssertionError(f"wide path: launches {launches}")
    nv = torch.tensor([n_rows], dtype=torch.int32, device="cuda")
    proj = np.zeros(c, np.float32)
    proj[:3] = 1
    expected = {
        "projection_128": (sp.select_project_plain(
            words[None], np.zeros(c, np.int32), np.zeros(c, np.float32),
            proj, nv)[0][0], n_rows * c * 4),
        "smart_addressing_128": (words[:, :3], n_rows * 3 * 4),
    }
    for name, res_list in results.items():
        rows, read = expected[name]
        for res in res_list:
            if (res.count != n_rows or word_err(res.rows, rows)
                    or res.shipped_bytes != n_rows * 3 * 4
                    or res.read_bytes != read):
                raise AssertionError(f"{name}: result differs from the "
                                     f"plain path")
        report(f"{name}: {N_CONNECTIONS} results of {n_rows} rows x "
               f"{res_list[0].rows.shape[1]} words bitwise equal to the "
               f"plain path, read {read} bytes each")
    del results, pending, expected
    return launches, verb_p50(fv, node, qps, verbs, report)


def dfa_strings(gen, b, n, w):
    """(B, n, w) bytes on the card for the kernel checks: letters, space,
    0 and bytes >= 128, with "err", "exxfr" and "eaqrx" each planted in a
    fifth of the rows (where they fit); lengths in [-3, w + 3] (below 0, 0
    and past the width among them)."""
    alphabet = torch.tensor(list(b"aeerrxzfq ") + [0, 128, 200, 255],
                            dtype=torch.uint8, device="cuda")
    strings = alphabet[torch.randint(0, alphabet.numel(), (b, n, w),
                                     generator=gen, device="cuda")]
    for tok in (b"err", b"exxfr", b"eaqrx"):
        if len(tok) <= w:
            rows = torch.rand((b, n), generator=gen, device="cuda") < 0.2
            at = (len(tok) * 7) % (w - len(tok) + 1)
            strings[..., at: at + len(tok)][rows] = torch.tensor(
                list(tok), dtype=torch.uint8, device="cuda")
    lengths = torch.randint(-3, w + 4, (b, n), generator=gen, device="cuda",
                            dtype=torch.int32)
    return strings, lengths


def bench_strings(gen, b, n, w):
    """benchmarks/bench_regex.py's strings (`_make_strings`) on the card:
    w - 1 lowercase letters with "err" at a random position in [0, w - 7)
    in the even rows, w - 4 letters in the odd rows, zero-padded to w.
    The letters after an inserted "err" are as uniform as those it
    displaces, so writing it over them gives the same distribution."""
    strings = torch.randint(97, 123, (b, n, w), generator=gen, device="cuda",
                            dtype=torch.uint8)
    strings[..., w - 1] = 0
    strings[:, 1::2, w - 4:] = 0
    pos = torch.randint(0, w - 7, (b, (n + 1) // 2, 1), generator=gen,
                        device="cuda")
    tok = torch.tensor(list(b"err"), dtype=torch.uint8, device="cuda")
    strings[:, 0::2].scatter_(2, pos + torch.arange(3, device="cuda"),
                              tok.expand(b, (n + 1) // 2, 3))
    lengths = torch.full((b, n), w - 4, dtype=torch.int32, device="cuda")
    lengths[:, 0::2] = w - 1
    return strings, lengths


def make_strings(rng, n, w):
    """`bench_strings` on the host, from a numpy generator: (n, w) uint8
    bytes and (n,) int32 lengths."""
    mat = np.zeros((n, w), np.uint8)
    mat[:, : w - 1] = rng.integers(97, 123, (n, w - 1), dtype=np.uint8)
    mat[1::2, w - 4:] = 0
    even = np.arange(0, n, 2)
    pos = rng.integers(0, w - 7, even.size)
    mat[even[:, None], pos[:, None] + np.arange(3)] = np.frombuffer(
        b"err", np.uint8)
    lens = np.full(n, w - 4, np.int32)
    lens[0::2] = w - 1
    return mat, lens


def check_dfa_match(dfa, compile_regex, gen, b, report):
    """dfa_match vs its plain version, exactly: every width of DFA_WIDTHS
    at B x 2^16 strings of mixed bytes and lengths for each pattern (and
    from an odd byte offset), then the main path's B x 2^22 strings of 64
    bytes; times the kernel there for each pattern and at Fig. 10's widths,
    and the plain version. Returns the JSON entry."""
    dfas = {p: dfa.prepare_dfa(*compile_regex(p), "cuda")
            for p in REGEX_PATTERNS}
    states = {p: int(t.shape[0]) for p, (t, _) in dfas.items()}
    n = 1 << 16
    for w in DFA_WIDTHS:
        strings, lengths = dfa_strings(gen, b, n, w)
        n_valid = torch.tensor([n, n - 1000, 1, 0][:b], dtype=torch.int32,
                               device="cuda")
        hits = {}
        for pat, (table, accept) in dfas.items():
            got = dfa.dfa_match(strings, lengths, n_valid, table, accept)
            exp = dfa.dfa_match_plain(strings, lengths, n_valid, table,
                                      accept)
            if not torch.equal(got, exp):
                raise AssertionError(f"dfa_match width {w} {pat!r}: "
                                     f"{int((got != exp).sum())} rows differ "
                                     f"from the plain version")
            hits[pat] = got.sum(dim=1).tolist()
        buf = torch.empty(strings.numel() + 1, dtype=torch.uint8,
                          device="cuda")
        buf[1:] = strings.view(-1)
        got = dfa.dfa_match(buf[1:].view(b, n, w), lengths, n_valid,
                            *dfas["err"])
        exp = dfa.dfa_match_plain(strings, lengths, n_valid, *dfas["err"])
        if not torch.equal(got, exp):
            raise AssertionError(f"dfa_match width {w} from an odd offset "
                                 f"differs from the plain version")
        report(f"dfa_match width {w}, {b}x{n} strings, n_valid "
               f"{n_valid.tolist()}: matches {hits}, equal to the plain "
               f"version (also from an odd byte offset)")
        del strings, lengths, buf, got, exp

    n, w = 1 << REGEX_ROWS_LOG2, REGEX_WIDTH
    strings, lengths = bench_strings(gen, b, n, w)
    full = torch.full((b,), n, dtype=torch.int32, device="cuda")
    table, accept = dfas["err"]
    got = dfa.dfa_match(strings, lengths, full, table, accept)
    exp = dfa.dfa_match_plain(strings, lengths, full, table, accept)
    if not torch.equal(got, exp):
        raise AssertionError("dfa_match at the main path's shape differs "
                             "from the plain version")
    rate = float(got.float().mean())
    del got, exp
    ms = cuda_ms(lambda: dfa.dfa_match(strings, lengths, full, table,
                                       accept))
    ms_patterns = {p: cuda_ms(lambda: dfa.dfa_match(strings, lengths, full,
                                                    *dfas[p]))
                   for p in REGEX_PATTERNS}
    plain_ms = cuda_ms(lambda: dfa.dfa_match_plain(strings, lengths, full,
                                                   table, accept),
                       reps=3, warmup=1)
    moved = (strings.numel() + lengths.numel() * 4 + b * n + b * 4
             + table.numel() * 4 + accept.numel())
    lookups = int(lengths.clamp(0, w).sum())
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = lookups / SMEM_LOOKUPS_PER_S
    del strings, lengths
    ms_by_width = {w: ms}
    for wv in (16, 32, 128):
        sv, lv = bench_strings(gen, b, n, wv)
        ms_by_width[wv] = cuda_ms(lambda: dfa.dfa_match(sv, lv, full, table,
                                                        accept))
        del sv, lv
    report(f"dfa_match {b}x{n} strings of {w} bytes, {rate:.4f} match "
           f"'err': {ms:.3f} ms (patterns of {states} states: "
           f"{ms_patterns}); plain {plain_ms:.3f} ms; bound "
           f"{max(t_bytes, t_ops) * 1e3:.3f} ms (bytes {t_bytes * 1e3:.3f}, "
           f"{lookups} lookups {t_ops * 1e3:.3f}); by width {ms_by_width}")
    return {"name": "dfa_match", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dfa_match.cu",
            "replaces": "src/repro/kernels/dfa_match.py:76",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": [b, n, w],
            "ms_patterns": ms_patterns, "states": states,
            "ms_by_width": ms_by_width, "match_rate": rate}


def regex_path(fv, op, dfa, ctr, compile_regex, kernels, seed, node, qps,
               report):
    """Drive RegexMatch over four string tables through the node (their
    bytes ride each request), clear, encrypted under a pre-Crypt, and in
    partitions with row ids; returns the counted run's launches and the
    per-verb p50s."""
    n, w = 1 << REGEX_ROWS_LOG2, REGEX_WIDTH
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    tables = []
    for i in range(len(qps)):
        mat, lens = make_strings(rng, n, w)
        tables.append((fv.FTable(f"log{i}", (fv.Column("bytes", "str"),),
                                 n_rows=n, str_width=w), mat, lens))
    report(f"regex path: {len(qps)} string tables of {n} x {w} bytes made "
           f"in {time.perf_counter() - t0:.1f} s")
    rx = op.RegexMatch("err")
    pre = op.Crypt(KEY_PRE, NONCE_PRE, "pre")
    verbs = {"regex": (tables, (rx,)),
             "regex_post_encrypt": (tables, (rx, op.Crypt(
                 KEY_POST, NONCE_POST, "post")))}
    # mixed widths (64 and 48) and row counts, one power-of-two row bucket
    mixed = []
    for i, ((_, mat, lens), rows) in enumerate(zip(
            tables, (n, n - n // 4, 3 * n // 4 + 5, n // 2 + 1))):
        wi = w if i % 2 == 0 else 48
        mixed.append((fv.FTable(f"mix{i}", (fv.Column("bytes", "str"),),
                                n_rows=rows, str_width=wi),
                      mat[:rows, :wi], np.minimum(lens[:rows], wi)))
    # the same tables encrypted at rest (the plain cipher, on the card)
    t0 = time.perf_counter()
    encrypted = []
    for ft, mat, lens in tables:
        dev = torch.from_numpy(mat).cuda().view(1, -1)
        enc = ctr.ctr_crypt_bytes_plain(dev, KEY_PRE, NONCE_PRE)
        encrypted.append((fv.FTable(f"enc_{ft.name}",
                                    (fv.Column("bytes", "str"),),
                                    n_rows=n, str_width=w),
                          enc.view(n, w).cpu().numpy(), lens))
        del dev, enc
    # table 0 in partitions by a seeded permutation, clear and encrypted
    parts = np.array_split(rng.permutation(n), len(qps))
    partitions = {
        name: [(fv.FTable(f"{name}{i}", (fv.Column("bytes", "str"),),
                          n_rows=len(ids), str_width=w), src[ids],
                tables[0][2][ids], ids) for i, ids in enumerate(parts)]
        for name, src in (("part", tables[0][1]),
                          ("part_enc", encrypted[0][1]))}
    report(f"regex path: tables encrypted and table 0 cut into "
           f"{len(parts)} partitions in {time.perf_counter() - t0:.1f} s")

    def submit_parts(name, p):
        return [fv.submit_request(qp, ft, p, strings=mat, lengths=lens,
                                  row_ids=ids)
                for qp, (ft, mat, lens, ids) in zip(qps, partitions[name])]

    rounds = (("clear", lambda: {name: submit_round(fv, qps, t, p)
                                 for name, (t, p) in verbs.items()},
               len(verbs)),
              ("mixed", lambda: {"regex_mixed": submit_round(fv, qps, mixed,
                                                             (rx,))}, 1),
              ("pre_decrypt", lambda: {"regex_pre_decrypt": submit_round(
                  fv, qps, encrypted, (pre, rx))}, 1),
              ("partitions", lambda: {"regex_partitions": submit_parts(
                  "part", (rx,))}, 1),
              ("partitions_pre_decrypt", lambda: {
                  "regex_partitions_pre_decrypt": submit_parts(
                      "part_enc", (pre, rx))}, 1))
    reset_launches(kernels)
    pending, per_round = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, submit, _ in rounds:
            d0, l0 = node.dispatches, read_launches(kernels)
            pending.update(submit())
            node.flush()
            l1 = read_launches(kernels)
            per_round[name] = (node.dispatches - d0,
                               {k: l1[k] - l0[k] for k in l1 if l1[k] - l0[k]})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    results = {name: [r.wait() for r in reqs]
               for name, reqs in pending.items()}
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    report(f"regex path: {len(results) * N_CONNECTIONS} requests in "
           f"{sum(d for d, _ in per_round.values())} dispatches, "
           f"{run_ms:.3f} ms, launches {launches}, per round (dispatches, "
           f"launches) {per_round}, no host sync before finalize")
    for name, _, dispatches in rounds:
        cipher = 1 if "pre_decrypt" in name else 0
        want = (dispatches, {"dfa_match": dispatches,
                             **({"ctr_crypt_bytes": 1} if cipher else {})})
        if per_round[name] != want:
            raise AssertionError(f"regex path, round {name}: expected "
                                 f"(dispatches, launches) {want}, got "
                                 f"{per_round[name]}")

    table, accept = dfa.prepare_dfa(*compile_regex("err"), "cuda")

    def plain_mask(mat, lens):
        strings = torch.from_numpy(np.ascontiguousarray(mat)).cuda()[None]
        nv = torch.tensor([mat.shape[0]], dtype=torch.int32, device="cuda")
        return dfa.dfa_match_plain(strings, torch.from_numpy(lens).cuda()[None],
                                   nv, table, accept)[0]

    expected = [plain_mask(mat, lens) for _, mat, lens in tables]
    runs = {"regex": tables, "regex_post_encrypt": tables,
            "regex_mixed": mixed, "regex_pre_decrypt": encrypted,
            "regex_partitions": partitions["part"],
            "regex_partitions_pre_decrypt": partitions["part_enc"]}
    for name, res_list in results.items():
        for i, (req, res) in enumerate(zip(runs[name], res_list)):
            mat = req[1]
            if name == "regex_mixed":
                exp = plain_mask(mat, req[2])
            elif name.startswith("regex_partitions"):
                exp = expected[0][torch.from_numpy(req[3]).cuda()]
            else:
                exp = expected[i]
            rows, wi = mat.shape
            if not torch.equal(res.mask, exp):
                raise AssertionError(f"{name}: connection {i}'s mask differs "
                                     f"from the plain path")
            # the JAX rules: one byte a valid row shipped, rows x own
            # width read; no count
            if (res.shipped_bytes != rows or res.read_bytes != rows * wi
                    or res.count is not None):
                raise AssertionError(f"{name}: shipped {res.shipped_bytes} "
                                     f"read {res.read_bytes} for {rows} x "
                                     f"{wi}")
        report(f"{name}: matches {[int(r.mask.sum()) for r in res_list]} of "
               f"{[r.mask.numel() for r in res_list]}, {N_CONNECTIONS} masks "
               f"equal to the plain path, shipped "
               f"{[r.shipped_bytes for r in res_list]} read "
               f"{[r.read_bytes for r in res_list]} bytes")
    # the pre-decrypt round answers as the clear round did; the partitions'
    # masks, scattered back by row id, are the whole table's
    for a, c in zip(results["regex_pre_decrypt"], results["regex"]):
        if (not torch.equal(a.mask, c.mask)
                or (a.shipped_bytes, a.read_bytes) != (c.shipped_bytes,
                                                       c.read_bytes)):
            raise AssertionError("regex_pre_decrypt differs from the clear "
                                 "round")
    for name in ("regex_partitions", "regex_partitions_pre_decrypt"):
        whole = torch.zeros(n, dtype=torch.bool, device="cuda")
        for ids, res in zip(parts, results[name]):
            whole[torch.from_numpy(ids).cuda()] = res.mask
        if not torch.equal(whole, expected[0]):
            raise AssertionError(f"{name}: the masks scattered back by row "
                                 f"id differ from the whole table's")
        report(f"{name}: {len(parts)} partitions scattered back by row id "
               f"equal the whole table's mask ({int(whole.sum())} of {n})")
    report("regex_pre_decrypt: masks, shipped and read bytes equal to the "
           "clear round's")
    del results, pending, expected

    sideband_split(tables, encrypted, report)
    verbs["regex_mixed"] = (mixed, (rx,))
    verbs["regex_pre_decrypt"] = (encrypted, (pre, rx))
    p50 = verb_p50(fv, node, qps, verbs, report, strict=True)
    profile_rounds(fv, node, qps, verbs, report, focus="dfa_match")
    return launches, p50


def sideband_split(tables, encrypted, report):
    """Where a regex round's host time goes: the round's byte sideband
    (four tables' strings, 1 GiB) stacked into pinned host memory as the
    node stacks it, the clear tables and the encrypted ones in turn (their
    arrays come from numpy and from torch's `.cpu()`), then uploaded (CUDA
    events), each timed alone."""
    b = len(tables)
    n, w = tables[0][1].shape
    pinned = torch.empty((b, n, w), dtype=torch.uint8, pin_memory=True)
    view = pinned.numpy()
    times = {"clear": [], "encrypted": []}
    for _ in range(3):
        for name, src in (("clear", tables), ("encrypted", encrypted)):
            t0 = time.perf_counter()
            for i, (_, mat, _) in enumerate(src):
                view[i] = mat
            times[name].append((time.perf_counter() - t0) * 1e3)
    dev = torch.empty((b, n, w), dtype=torch.uint8, device="cuda")
    up_ms = cuda_ms(lambda: dev.copy_(pinned, non_blocking=True), reps=5,
                    warmup=1)
    report(f"sideband of a regex round, {pinned.numel()} bytes: stacked into "
           f"pinned memory in "
           + "; ".join(f"{k} {statistics.median(v):.3f} ms (runs "
                       f"{[round(x, 3) for x in v]})"
                       for k, v in times.items())
           + f"; uploaded in {up_ms:.3f} ms "
           f"({pinned.numel() / up_ms / 1e6:.1f} GB/s)")
    del pinned, dev


def da_lengths(gen, p, b, s, kind):
    """(P, B) int32 lengths on the card: "full" (S), or "mixed": 0, 1 and
    S spread over the grid, the rest uniform in [0, S]."""
    if kind == "full":
        return torch.full((p, b), s, dtype=torch.int32, device="cuda")
    lens = torch.randint(0, s + 1, (p * b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[0::4], lens[1::4], lens[2::4] = 0, 1, s
    return lens.view(p, b)


def da_inputs(gen, shape, dtype, lengths):
    """Kernel-check inputs on the card: q (P, B, Hkv*G, D) f32, k and v
    (P, B, S, Hkv, D) N(0, 1) in `dtype`, lengths by `da_lengths`."""
    p, b, s, hkv, g, d = shape
    q = torch.randn((p, b, hkv * g, d), generator=gen, device="cuda")
    k = torch.randn((p, b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((p, b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, da_lengths(gen, p, b, s, lengths)


def f64_partials(q, k, v, lens, scale):
    """The kernel's function in f64 (an accuracy yardstick for both the
    kernel and its plain version)."""
    p, b, hq, d = q.shape
    s, hkv = k.shape[2], k.shape[3]
    qd = q.double().view(p, b, hkv, hq // hkv, d)
    sc = torch.einsum("pbhgd,pbshd->pbhgs", qd, k.double()) * scale
    valid = torch.arange(s, device="cuda") < lens[..., None, None, None]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(dim=-1).clamp(min=-1e30)
    w = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
    o = torch.einsum("pbhgs,pbshd->pbhgd", w, v.double())
    return o.view(p, b, hq, d), m.view(p, b, hq), w.sum(-1).view(p, b, hq)


def check_da_case(da, q, k, v, lens, scale, name, report, f64=False):
    """One kernel call against its plain version by the DA_TOL rules.
    Returns the largest |o difference|."""
    o, m, l = da.decode_attention(q, k, v, lens, scale)
    eo, em, el = da.decode_attention_plain(q, k, v, lens, scale)
    o_abs = da.decode_attention_plain(q, k, v.abs(), lens, scale)[0]
    diff = (o - eo).abs()
    if float((diff - DA_TOL * o_abs).max()) > 0:
        raise AssertionError(f"decode_attention {name}: o off by more than "
                             f"{DA_TOL} of its sum |p v|")
    for got, exp, what in ((l, el, "l"), (m, em, "m")):
        if not torch.allclose(got, exp, rtol=DA_TOL, atol=DA_TOL):
            raise AssertionError(f"decode_attention {name}: {what} differs "
                                 f"from the plain version")
    empty = (lens == 0)[..., None].expand_as(m)
    if not (bool((m[empty] == -1e30).all()) and bool((l[empty] == 0).all())
            and bool((o[empty] == 0).all())):
        raise AssertionError(f"decode_attention {name}: an empty (p, b) is "
                             f"not (0, -1e30, 0)")
    o2 = da.decode_attention(q, k, v, lens, scale)[0]
    if not torch.equal(o, o2):
        raise AssertionError(f"decode_attention {name}: two launches differ")
    err = float(diff.max())
    loose = int((~torch.isclose(o, eo, rtol=DA_TOL, atol=DA_TOL)).sum())
    line = (f"decode_attention {name}: max |o - plain| {err:.3e} (max of it "
            f"over sum|p v| {float((diff / o_abs.clamp(min=1e-30)).max()):.3e}"
            f"; {loose} of {o.numel()} outside allclose(1e-5, 1e-5)), "
            f"lengths {int((lens == 0).sum())} zero / "
            f"{int((lens == k.shape[2]).sum())} full of {lens.numel()}; "
            f"deterministic")
    if f64:
        fo, fm, fl = f64_partials(q, k, v, lens, scale)
        line += (f"; vs f64: kernel o {float((o.double() - fo).abs().max()):.3e}"
                 f" l {float((l.double() - fl).abs().max()):.3e}, plain o "
                 f"{float((eo.double() - fo).abs().max()):.3e} l "
                 f"{float((el.double() - fl).abs().max()):.3e}")
        del fo, fm, fl
    report(line)
    return err


def check_da_nonfinite(da, q, k, v, lens, scale, name, report):
    """Non-finite K and V against the plain version: in every other (p, b)
    with rows one element of K or V inside the length is +inf, -inf or NaN
    by turns; in the others with rows past the length, one V element there
    is +inf, -inf or NaN. The kernels read no row past the length, so the
    plain version runs over V with those rows zeroed. NaN and inf in the
    same places (inf with its sign), m equal, the rest by the DA_TOL
    rules; two launches bitwise equal."""
    p, b, s, hkv, d = k.shape
    kinds = [(k, float("inf")), (k, -float("inf")), (k, float("nan")),
             (v, float("inf")), (v, -float("inf")), (v, float("nan"))]
    for j, n in enumerate(lens.view(-1).tolist()):
        if j % 2 == 0 and n > 0:
            t, val = kinds[(j // 2) % 6]
            t[j // b, j % b, (j * 31) % n, j % hkv, (j * 5) % d] = val
        elif j % 2 and n < s:
            v[j // b, j % b, n + (j * 7) % (s - n), j % hkv, (j * 5) % d] = (
                kinds[3 + (j // 2) % 3][1])
    seen = v.clone()
    seen[torch.arange(s, device="cuda") >= lens[..., None]] = 0
    o, m, l = da.decode_attention(q, k, v, lens, scale)
    eo, em, el = da.decode_attention_plain(q, k, seen, lens, scale)
    for got, exp, what in ((o, eo, "o"), (l, el, "l"), (m, em, "m")):
        inf = torch.isinf(exp)
        if not (torch.equal(torch.isnan(got), torch.isnan(exp))
                and torch.equal(torch.isinf(got), inf)
                and torch.equal(got[inf], exp[inf])):
            raise AssertionError(f"decode_attention {name}: {what}'s NaN "
                                 f"and inf differ from the plain version")
    o_abs = da.decode_attention_plain(q, k, seen.abs(), lens, scale)[0]
    fin = torch.isfinite(eo) & torch.isfinite(o_abs)
    if float(((o - eo).abs() - DA_TOL * o_abs)[fin].max()) > 0:
        raise AssertionError(f"decode_attention {name}: a finite o off by "
                             f"more than {DA_TOL} of its sum |p v|")
    fin = torch.isfinite(el)
    if not (torch.allclose(l[fin], el[fin], rtol=DA_TOL, atol=DA_TOL)
            and torch.allclose(m, em, rtol=DA_TOL, atol=DA_TOL)):
        raise AssertionError(f"decode_attention {name}: l or m differs "
                             f"from the plain version")
    o2, m2, l2 = da.decode_attention(q, k, v, lens, scale)
    if not all(torch.equal(a.view(torch.int32), c.view(torch.int32))
               for a, c in ((o, o2), (m, m2), (l, l2))):
        raise AssertionError(f"decode_attention {name}: two launches differ")
    past = int(torch.isnan(da.decode_attention_plain(
        q, k, v, lens, scale)[0]).any(-1).sum())
    report(f"decode_attention {name}, +-inf and NaN in K and V: NaN and inf "
           f"where the plain version has them ({int(torch.isnan(o).sum())} "
           f"NaN and {int(torch.isinf(o).sum())} inf elements of o), m = 0 "
           f"on the {int((em == 0).sum())} (p, b, head) rows of a +inf or "
           f"NaN score, the rest within the DA rules, two launches bitwise "
           f"equal; "
           f"past the length the plain version over the unzeroed V has "
           f"{past} NaN rows of o the kernel does not read")
    return float((o - eo).abs()[torch.isfinite(eo)].max())


def check_decode_attention(da, gen, report):
    """decode_attention vs its plain version on the card at the far-KV
    path's shape and beside it; times the kernel, its plain version and
    SDPA at the path's shape with every row valid. Returns the JSON entry."""
    shape = (KV_SHARDS, KV_BATCH, KV_SHARD_ROWS, KV_HKV, KV_HQ // KV_HKV,
             KV_DH)
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for lengths in ("mixed", "full"):
            q, k, v, lens = da_inputs(gen, shape, dtype, lengths)
            err = max(err, check_da_case(
                da, q, k, v, lens, KV_DH ** -0.5,
                f"{str(dtype)[6:]} {lengths} {list(shape)}", report,
                f64=dtype == torch.float32))
            del q, k, v, lens
    # non-finite K and V: the tensor-core kernel (bf16) and the FMA kernel
    # (f32) at the path's shape, ragged lengths
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, lens = da_inputs(gen, shape, dtype, "mixed")
        err = max(err, check_da_nonfinite(
            da, q, k, v, lens, KV_DH ** -0.5,
            f"{str(dtype)[6:]} mixed {list(shape)}", report))
        del q, k, v, lens
    p, b, s = shape[:3]
    for hkv, g, d in ((8, 1, 128), (4, 8, 128), (8, 4, 64), (8, 4, 256)):
        sh = (p, b, s, hkv, g, d)
        q, k, v, lens = da_inputs(gen, sh, torch.bfloat16, "mixed")
        err = max(err, check_da_case(da, q, k, v, lens, d ** -0.5,
                                     f"bf16 mixed {list(sh)}", report))
        del q, k, v, lens
    torch.cuda.empty_cache()

    # timing at the path's shape, the path's query: (B, Hq, D) bf16,
    # replicated over the shards
    q, k, v, lens = da_inputs(gen, shape, torch.bfloat16, "full")
    q = q[0].to(torch.bfloat16).expand(p, *q.shape[1:])
    scale = KV_DH ** -0.5
    mixed = da_lengths(gen, p, b, s, "mixed")
    # SDPA over the unsharded cache: (B, Hkv, S, D), the query (B, Hq, 1, D)
    hkv, d = KV_HKV, KV_DH
    ks = k.permute(1, 3, 0, 2, 4).reshape(b, hkv, p * s, d)
    vs = v.permute(1, 3, 0, 2, 4).reshape(b, hkv, p * s, d)
    qs = q[0][:, :, None]
    glen = lens.sum(dim=0)
    mask = (torch.arange(p * s, device="cuda") < glen[:, None])[:, None, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=scale, enable_gqa=True)

    def kernel(lengths):
        return lambda: da.decode_attention(q, k, v, lengths, scale)

    # the kernel and SDPA timed both ways in this run: DA_BATCH launches
    # back to back a timed run (the wrapper's Python hides behind the
    # card), and one launch a run (the host's launch time counts too)
    ms, library_ms, mixed_ms = (cuda_ms(f, batch=DA_BATCH) for f in (
        kernel(lens), sdpa, kernel(mixed)))
    one_ms, one_library_ms, one_mixed_ms = (cuda_ms(f) for f in (
        kernel(lens), sdpa, kernel(mixed)))
    plain_ms = cuda_ms(lambda: da.decode_attention_plain(q, k, v, lens,
                                                         scale),
                       reps=3, warmup=1)
    o, m, l = da.decode_attention(q, k, v, lens, scale)
    merged = (o * torch.exp(m - m.amax(0))[..., None]).sum(0) / (
        l * torch.exp(m - m.amax(0))).sum(0)[..., None]
    sdpa_err = float((sdpa()[:, :, 0].float() - merged).abs().max())
    rows = int(lens.clamp(0, s).sum())
    moved = (q.numel() * q.element_size() + 2 * rows * hkv * d
             * k.element_size() + lens.numel() * 4
             + (o.numel() + m.numel() + l.numel()) * 4)
    flops = 4 * KV_HQ * d * rows
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    del o, m, l, merged, ks, vs
    report(f"decode_attention {list(shape)} bf16, every row valid: {ms:.3f} "
           f"ms {DA_BATCH} launches a timed run, {one_ms:.3f} one a run; "
           f"ragged lengths, reading {int(mixed.sum()) / rows:.3f} of the "
           f"rows: {mixed_ms:.3f} / {one_mixed_ms:.3f}; plain {plain_ms:.3f}"
           f" ms; SDPA over the unsharded cache (merged output only; max "
           f"|SDPA - merged partials| {sdpa_err:.3e}) {library_ms:.3f} / "
           f"{one_library_ms:.3f}; bound {bound_ms:.3f} ms (bytes {moved}: "
           f"{t_bytes * 1e3:.3f}, flops {flops}: {t_ops * 1e3:.3f})")
    lib = da._build.lib("decode_attention.cu")
    g = KV_HQ // hkv
    splits, chunk = da._split_plan(p * b, hkv, g, s, d, 1,
                                   da._slots(q.device, d, g, 1), lib)
    report(f"decode_attention {list(shape)} bf16: {100 * bound_ms / ms:.1f}% "
           f"of its bound, {moved / ms / 1e6:.1f} GB/s; kernel / SDPA, same "
           f"run: {ms / library_ms:.3f} at {DA_BATCH} launches a timed run, "
           f"{one_ms / one_library_ms:.3f} at one; "
           f"{lib.da_blocks_per_sm(d, g, 1)} blocks an SM of "
           f"{lib.da_smem_bytes(d, g, 1)} bytes of shared memory, {splits} "
           f"splits of {chunk} rows (stages of {lib.da_stage_rows(d, g, 1)})")
    fma = time_fma_kernel(da, gen, q, k, v, lens, mixed, scale, report)
    del q, k, v
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:88",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": list(shape),
            "ms_ragged": mixed_ms, "sdpa_max_abs_diff": sdpa_err,
            "ms_one_launch_a_run": one_ms,
            "library_ms_one_launch_a_run": one_library_ms,
            "ms_ragged_one_launch_a_run": one_mixed_ms,
            "fma_kernel_ms": fma}


def fma_only_lib(da):
    """decode_attention.cu built with -DDA_FMA_ONLY, which compiles its
    tensor-core path out: the f32 FMA kernel takes every 16-byte row."""
    bld = da._build
    out = bld.BUILD_DIR / (bld._target("decode_attention.cu").stem
                           + "-fma-only.so")
    subprocess.run([bld._nvcc(), *bld.NVCC_FLAGS, "-DDA_FMA_ONLY", "-o",
                    str(out), str(bld.CSRC / "decode_attention.cu")],
                   check=True, capture_output=True, text=True, timeout=900)
    return bld._load("decode_attention.cu", out)


@contextlib.contextmanager
def da_library(da, lib):
    """decode_attention's wrapper launches from `lib` inside the block."""
    libs, name = da._build._LIBS, "decode_attention.cu"
    saved = libs[name]
    libs[name] = lib
    da._slots.cache_clear()
    try:
        yield
    finally:
        libs[name] = saved
        da._slots.cache_clear()


def time_fma_kernel(da, gen, q, k, v, lens, mixed, scale, report):
    """The tensor-core kernel against the FMA kernel where the tensor cores
    run: the FMA build checked at the path's shape, then both timed at the
    far-KV path's shapes (far: the sharded pool, full and ragged; naive:
    one shard of every row; local: each KV head on two shards), DA_BATCH
    launches a timed run, in the order tensor, FMA, FMA, tensor. Returns
    {shape: [tensor ms, FMA ms]}, each the mean of its two runs."""
    fma = fma_only_lib(da)
    with da_library(da, fma):
        check_da_case(da, q, k, v, lens, scale,
                      f"FMA build, bf16 full {list(k.shape)}", report)
    p, b, s, hkv, d = k.shape
    n = p * s
    kn = torch.randn((1, b, n, hkv, d), generator=gen, device="cuda").to(
        k.dtype)
    ql = torch.randn((p, b, 2, d), generator=gen, device="cuda").to(q.dtype)
    kl = torch.randn((p, b, n, 1, d), generator=gen, device="cuda").to(
        k.dtype)
    every = lens.sum(0, keepdim=True, dtype=torch.int32)   # n a sequence
    cases = {"far full": (q, k, v, lens), "far ragged": (q, k, v, mixed),
             "naive": (q[:1], kn, kn, every),
             "local": (ql, kl, kl, every.expand(p, -1))}
    tensor = da._build.lib("decode_attention.cu")

    def timed(args):
        return cuda_ms(lambda: da.decode_attention(*args, scale),
                       batch=DA_BATCH)

    out = {}
    for name, args in cases.items():
        t = {"tensor": [], "fma": []}
        for which in ("tensor", "fma", "fma", "tensor"):
            with da_library(da, fma if which == "fma" else tensor):
                t[which].append(timed(args))
        out[name] = [statistics.mean(t["tensor"]), statistics.mean(t["fma"])]
    report("decode_attention, tensor-core kernel vs FMA kernel (the same "
           "source built -DDA_FMA_ONLY), ms at " + "; ".join(
               f"{name} [P, B, S, Hkv] {list(args[1].shape[:4])} G "
               f"{args[0].shape[2] // args[1].shape[3]}: {out[name][0]:.3f} "
               f"vs {out[name][1]:.3f} ({out[name][1] / out[name][0]:.2f}x)"
               for name, args in cases.items()))
    del kn, ql, kl, cases
    return out


def plain_block_step(ref, x, ws, k_full, v_full, pos):
    """The far-KV decode step in plain torch over the unsharded cache (B,
    S, Hkv, D): the projections with the full weights, each sequence's
    new row written at its position, full masked attention
    (`ref.full_attention_oracle`), the out-projection."""
    wq, wk, wv, wo = ws
    b = x.shape[0]
    rows = torch.arange(b, device="cuda")
    k_full[rows, pos.long()] = (x @ wk).view(b, KV_HKV, KV_DH)
    v_full[rows, pos.long()] = (x @ wv).view(b, KV_HKV, KV_DH)
    q = (x @ wq).view(b, KV_HQ, KV_DH)
    attn = ref.full_attention_oracle(q, k_full, v_full, pos + 1)
    return attn.reshape(b, -1).to(x.dtype) @ wo


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()) / float(
        b.float().abs().max())


def far_kv_path(fk, ref, kernels, gen, seed, report):
    """Drive granite-3-8b's attention block through `far_kv.attend_block`
    in every mode for KV_STEPS decode steps, counted and checked; returns
    the launches and the p50 ms of a step per mode."""
    b, p, s_loc = KV_BATCH, KV_SHARDS, KV_SHARD_ROWS
    s, dm, hq, hkv, dh = p * s_loc, KV_D_MODEL, KV_HQ, KV_HKV, KV_DH
    rng = np.random.default_rng(seed)
    full = [rng.standard_normal(sh, dtype=np.float32) / np.float32(
        np.sqrt(sh[0])) for sh in ((dm, hq * dh), (dm, hkv * dh),
                                   (dm, hkv * dh), (hq * dh, dm))]
    heads = dict(n_q_heads=hq, n_kv_heads=hkv, head_dim=dh)
    w = fk.block_weights_from_numpy(*full, tp=p, dtype=torch.bfloat16,
                                    device="cuda", **heads)
    ws = [torch.from_numpy(a).to("cuda", torch.bfloat16) for a in full]
    k_full = torch.randn((b, s, hkv, dh), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    v_full = torch.randn((b, s, hkv, dh), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    lens_np = np.sort(rng.integers(1, s - KV_STEPS + 1, b))
    lens_np[0], lens_np[-1] = 1, s - KV_STEPS
    lens = torch.from_numpy(lens_np.astype(np.int32)).cuda()
    caches = {mode: fk.shard_cache(k_full, v_full, tp=p, mode=mode,
                                   device="cuda") for mode in KV_MODES}
    xs = torch.randn((KV_STEPS, b, dm), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    empty = int((lens[None] <= torch.arange(p, device="cuda")[:, None]
                 * s_loc).sum())
    report(f"far-KV path: d_model {dm}, Hq {hq}, Hkv {hkv}, Dh {dh}, bf16; "
           f"B={b} sequences of lengths {lens_np.tolist()} over {p} shards x "
           f"{s_loc} rows ({empty} of {p * b} (shard, sequence) pairs "
           f"empty); cache {k_full.numel() * 4} bytes (K and V)")

    reset_launches(kernels)
    times = {mode: [] for mode in KV_MODES}
    errs = {mode: 0.0 for mode in KV_MODES}
    modes_err = 0.0
    for i in range(KV_STEPS):
        pos = lens + i
        outs = {}
        for mode in KV_MODES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "far":   # nothing in a far step may wait for the card
                torch.cuda.set_sync_debug_mode("error")
            try:
                outs[mode] = fk.attend_block(xs[i], w, *caches[mode], pos,
                                             lens, mode=mode, **heads)[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            times[mode].append((time.perf_counter() - t0) * 1e3)
        plain = plain_block_step(ref, xs[i], ws, k_full, v_full, pos)
        for mode in KV_MODES:
            errs[mode] = max(errs[mode], rel_err(outs[mode], plain))
            modes_err = max(modes_err, rel_err(outs[mode], outs["far"]))
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    if max(errs.values()) > KV_BF16_TOL or modes_err > KV_BF16_TOL:
        raise AssertionError(f"far-KV path: outputs differ: vs the plain "
                             f"step {errs}, between modes {modes_err}")
    if launches["decode_attention"] != KV_STEPS * len(KV_MODES) or any(
            n for name, n in launches.items() if name != "decode_attention"):
        raise AssertionError(f"far-KV path: expected one decode_attention "
                             f"launch a step, got {launches}")
    far_k = caches["far"][0].transpose(0, 1).reshape(k_full.shape)
    cache_err = rel_err(far_k, k_full)
    if cache_err > KV_BF16_TOL:
        raise AssertionError(f"far-KV path: the far cache differs from the "
                             f"plain one ({cache_err})")
    report(f"far-KV path: {KV_STEPS} steps x {len(KV_MODES)} modes, launches "
           f"{launches}; far steps under sync debug mode \"error\"; max "
           f"|out - plain step| / max |plain| {errs}, between modes "
           f"{modes_err:.3e} (tolerance {KV_BF16_TOL}); far cache vs plain "
           f"{cache_err:.3e}")
    p50 = {f"far_kv_{mode}": statistics.median(t)
           for mode, t in times.items()}
    for mode in KV_MODES:
        report(f"p50 far_kv_{mode}: {p50[f'far_kv_{mode}']:.3f} ms a decode "
               f"step (runs {[round(t, 3) for t in times[mode]]}); shipped "
               f"{fk.shipped_bytes_per_layer(mode, batch=b, hq=hq, hkv=hkv, head_dim=dh, seq_len=s, tp=p)}"
               f" bytes a layer (modelled)")
    del k_full, v_full, ws
    pos = lens + KV_STEPS - 1            # the last step again: idempotent
    for mode in KV_MODES:
        trace_call(f"far_kv_{mode} step", lambda: fk.attend_block(
            xs[-1], w, *caches[mode], pos, lens, mode=mode, **heads),
            report)
    del caches
    return launches, p50

def tg_random(rng, b, p, c, pw, n_frames=6):
    """A random word buffer and random descriptors (host arrays): every
    mode, widths 0..33, bit offsets straddling words and running off both
    ends of the frame, dictionary offsets outside it, bases across the
    u32 range."""
    buf = rng.integers(0, 2**32, (n_frames, pw), dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    desc = (rng.integers(0, n_frames, (b, p)).astype(np.int32),
            rng.integers(0, 3, (b, p, c)).astype(np.int32),
            rng.integers(0, 34, (b, p, c)).astype(np.int32),
            rng.integers(0, 2**32, (b, p, c), dtype=np.uint64).astype(
                np.uint32),
            rng.integers(-8, pw + 8, (b, p, c)).astype(np.int32),
            rng.integers(-64, pw * 32 + 64, (b, p, c)).astype(np.int32))
    return buf, desc


def tg_words(rng, n, c):
    """Words whose column planes need every packed width 1..32 (column j
    spans [0, 2^(j % 32 + 1))), dictionary-friendly columns, and NaN
    payloads, inf, -0.0 and subnormals in every third column."""
    u = np.zeros((n, c), np.uint64)
    for j in range(c):
        w = j % 32 + 1
        if j % 5 == 4:
            u[:, j] = rng.integers(0, 2**32, 7, dtype=np.uint64)[
                rng.integers(0, 7, n)]
        else:
            u[:, j] = rng.integers(0, 2**w, n, dtype=np.uint64)
            u[0, j] = 2**w - 1
    u = u.astype(np.uint32)
    specials = u[:, ::3]
    flat = specials.reshape(-1)
    for v in (0x7FC0BEEF, 0xFFC00001, 0x7F800000, 0x80000000, 0x00000005,
              0x807FFFFF):
        flat[rng.integers(0, flat.size, max(1, flat.size // 200))] = v
    u[:, ::3] = flat.reshape(specials.shape)
    return u.view(np.float32)


def tg_pair(tg, buf, tier, n, c, cols, pw, what):
    """The kernel and the plain version on the same operands, bitwise.
    Returns (kernel output, word error)."""
    got = tg.tier_gather(buf, tier, n, c, cols, pw)
    exp = tg.tier_gather_plain(buf, tier, n, c, cols, pw)
    err = word_err(got, exp)
    if err:
        raise AssertionError(f"tier_gather {what}: kernel and plain differ "
                             f"(word err {err})")
    return got, err


def check_tier_gather(tg, fpool, fv, seed, report):
    """tier_gather against its plain version on the card, bitwise: random
    descriptors at C = 3, 5, 7, 8, B = 1 and 4; a pool's real cold frames
    (4 KiB pages, every other page cold: delta and dictionary planes of
    widths 1..32, pages starting mid-row, NaN and subnormal payloads)
    alone, column-granular and stacked with null-descriptor padding; one
    request alone against the same request in a stack. Returns the
    largest word error (0)."""
    rng = np.random.default_rng(seed)
    pw = 4096 // 4
    for c in (3, 5, 7, 8):
        for b in (1, 4):
            buf, desc = tg_random(rng, b, 3, c, pw)
            tbuf = torch.from_numpy(buf.view(np.int32).copy()).cuda().view(
                torch.float32)
            tier = tg.tier_tensors(desc, "cuda")
            for cols in (None, [c - 1, 0, c - 1], [c // 2]):
                tg_pair(tg, tbuf, tier, 3 * pw // c, c, cols, pw,
                        f"random descriptors C={c} B={b} cols={cols}")
    report("tier_gather random descriptors (C = 3, 5, 7, 8; B = 1, 4; "
           "widths 0..33, offsets off both ends): bitwise equal")
    for c in (3, 5, 7, 8, 32):
        n = 2500 if c < 32 else 700
        words = tg_words(rng, n, c)
        pool = fpool.FarPool(8 * 2**20, page_bytes=4096, device="cuda")
        ft = pool.alloc_table(fv.FTable(
            "t", tuple(fv.Column(f"c{i}") for i in range(c)), n_rows=n))
        pool.write_table(ft, words)
        p_n = len(ft.pages)
        pool.demote_table(ft, page_idx=range(0, p_n, 2))
        te = pool._tier[ft.table_id]
        widths = sorted(set(te.width[te.cold].reshape(-1).tolist()))
        modes = set(te.mode[te.cold].reshape(-1).tolist())
        if not (te.cold.any() and not te.cold.all() and {1, 2} <= modes):
            raise AssertionError(f"tier_gather C={c}: the frames hold no "
                                 "mixed delta and dictionary planes")
        one = tuple(t[0] for t in pool.tier_desc_stacked([ft], p_n + 2))
        null = tg.tier_tensors(
            tg.null_descriptor(p_n + 2, c, pool.null_page), "cuda")
        stack = tuple(torch.stack([a, b, a, b]) for a, b in zip(null, one))
        rows = (p_n + 2) * pw // c
        for tier, what in ((one, "B=1"), (stack, "B=4")):
            for cols in (None, [c - 1, 0]):
                tg_pair(tg, pool.buf, tier, rows, c, cols, pw,
                        f"pool frames C={c} {what} cols={cols}")
        alone, _ = tg_pair(tg, pool.buf, one, n, c, None, pw, "alone")
        stacked, _ = tg_pair(tg, pool.buf, stack, n, c, None, pw, "stacked")
        if (word_err(alone, torch.from_numpy(words).cuda())
                or word_err(stacked[1], alone) or word_err(stacked[3], alone)
                or stacked[0].view(torch.int32).any()):
            raise AssertionError(f"tier_gather C={c}: decoded words differ "
                                 "from the written ones, or a request "
                                 "alone from the same request stacked")
        report(f"tier_gather pool frames C={c}: {p_n} pages, "
               f"{int(te.cold.sum())} cold, plane widths {widths}, B = 1 "
               f"and 4 with null padding: bitwise equal to the plain "
               f"version and the written words; request 1 alone == "
               f"stacked")
        del pool
    return 0


def analytics_words(gen, n):
    """benchmarks/bench_tiering.py's `_analytics_data`, made on the card:
    c0 an i32 key uniform in [0, 64), c1..c7 integer-valued f32 uniform in
    [0, 128)."""
    w = torch.randint(0, 128, (n, 8), generator=gen, device="cuda").float()
    w[:, 0] = torch.randint(0, 64, (n,), generator=gen,
                            device="cuda").float()
    return w


def same_result(a, b, what):
    """Two results of one verb bitwise equal: rows and count, or the
    groups payload; and their shipped bytes."""
    if a.kind == "groups":
        ga, gb = a.groups, b.groups
        bad = [f for f in ("bucket_keys", "count", "sum", "min", "max")
               if word_err(ga[f], gb[f])]
        if bad or not (np.array_equal(ga["ovf_keys"], gb["ovf_keys"])
                       and np.array_equal(ga["ovf_vals"].view(np.uint32),
                                          gb["ovf_vals"].view(np.uint32))):
            raise AssertionError(f"{what}: groups differ ({bad})")
    elif a.count != b.count or word_err(a.rows, b.rows):
        raise AssertionError(f"{what}: rows differ ({a.count} vs {b.count})")
    if a.shipped_bytes != b.shipped_bytes:
        raise AssertionError(f"{what}: shipped {a.shipped_bytes} vs "
                             f"{b.shipped_bytes}")


def tiered_round(fv, node, qps, t, p, strict):
    """One stacked round of a verb (one request a connection), flushed
    under sync debug mode "error" when `strict`; the finalized results."""
    if strict:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        reqs = submit_round(fv, qps, t, p)
        node.flush()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [r.wait() for r in reqs]


def tiered_path(fv, op, tg, fpool, kernels, gen, report):
    """The tiered path: bench_tiering.py's analytics table at full size
    demoted to the cold tier, the five verbs in stacked rounds over it,
    each bitwise its round over a hot copy, a mixed-tier round, a timed
    promotion; tier_gather held to its plain version at the path's
    shapes and timed. Returns (launches, p50s, tier_gather's entry)."""
    n = 1 << TIER_ROWS_LOG2
    node = fv.FViewNode(3 * 2**30, n_regions=N_CONNECTIONS,
                        promote_after=10**9, device="cuda")
    qps = [fv.open_connection(node) for _ in range(N_CONNECTIONS)]
    cols = tuple(fv.Column(f"c{i}", "i32" if i == 0 else "f32")
                 for i in range(8))
    words = analytics_words(gen, n)
    cold = fv.alloc_table_mem(qps[0], fv.FTable("facts", cols, n_rows=n))
    fv.table_write(qps[0], cold, words)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    demoted = node.pool.demote_table(cold)
    demote_s = time.perf_counter() - t0
    summary = node.pool.tier_summary()
    report(f"tiered path: demote_table of {len(cold.pages)} pages "
           f"({demoted} demoted) {demote_s:.3f} s on the host; "
           f"tier_summary {summary}")
    if demoted != len(cold.pages) or summary["effective_capacity"] < 1.5:
        raise AssertionError("tiered path: the analytics table did not "
                             "demote to an effective capacity >= 1.5")
    hot = fv.alloc_table_mem(qps[0], fv.FTable("facts_hot", cols, n_rows=n))
    fv.table_write(qps[0], hot, words)
    report(f"with the hot copy: effective capacity "
           f"{node.pool.tier_summary()['effective_capacity']:.4f}")

    # ---- the kernel at the path's shapes: B=4 stacked requests
    b, pw, buf = N_CONNECTIONS, node.pool.page_words, node.pool.buf
    tier4 = node.pool.tier_desc_stacked([cold] * b, len(cold.pages))
    err = 0
    for sel_cols, what in ((None, "rows"), (TIER_SMART_IDX, "3 columns")):
        got, e = tg_pair(tg, buf, tier4, n, 8, sel_cols, pw,
                         f"path shape {what}")
        err = max(err, e)
        ref_cols = words if sel_cols is None else words[:, sel_cols]
        if any(word_err(got[i], ref_cols) for i in range(b)):
            raise AssertionError(f"tier_gather {what}: the decoded words "
                                 "differ from the written ones")
        del got
    report(f"tier_gather at B={b} x 2^{TIER_ROWS_LOG2} rows x 8 words, rows "
           "and 3 columns: bitwise equal to the plain version and to the "
           "written words")
    ms = cuda_ms(lambda: tg.tier_gather(buf, tier4, n, 8, None, pw))
    ms3 = cuda_ms(lambda: tg.tier_gather(buf, tier4, n, 8, TIER_SMART_IDX,
                                         pw))
    plain_ms = cuda_ms(lambda: tg.tier_gather_plain(buf, tier4, n, 8, None,
                                                    pw), reps=3, warmup=1)
    read = b * node.pool.tier_read_bytes(cold)
    read3 = b * node.pool.tier_read_bytes(cold, TIER_SMART_IDX)
    out_bytes, out3 = b * n * 8 * 4, b * n * 3 * 4
    bound = (read + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound3 = (read3 + out3) / HBM_BYTES_PER_S * 1e3
    # the flat page gather beside it (torch indexing, as the rows path runs
    # it, CUDA events): requests over one table, their page lists stacked
    # contiguous (B, P) as the scheduler stacks them; the same with request
    # b's list rotated by b/4 of the table; three requests over three
    # disjoint page sets of the pool (no page read twice) against three
    # over one table; one request
    pages = node.pool.pages_of(hot)
    p_n = pages.shape[0]
    others = torch.tensor(sorted(set(range(node.pool.n_pages))
                                 - set(hot.pages))[: 2 * p_n],
                          device="cuda")
    variants = {"same": pages.expand(b, -1).contiguous(),
                "rotated": torch.stack([pages.roll(i * p_n // b)
                                        for i in range(b)]),
                "same3": pages.expand(3, -1).contiguous(),
                "disjoint3": torch.cat([pages[None],
                                        others.view(2, p_n)]),
                "one": pages[None]}
    flat = {name: cuda_ms(lambda pg=pg: fpool.gather_rows(buf, pg, n, 8))
            for name, pg in variants.items()}
    page_bytes = out_bytes // b
    report(f"tier_gather rows {ms:.3f} ms (bound {bound:.3f} ms: reads "
           f"{read} B of planes and dictionaries, writes {out_bytes} B; "
           f"{100 * bound / ms:.1f}% of it, "
           f"{(read + out_bytes) / ms / 1e6:.1f} GB/s); 3 columns "
           f"{ms3:.3f} ms (bound {bound3:.3f} ms: reads {read3} B, writes "
           f"{out3} B); plain version {plain_ms:.3f} ms (in row chunks)")
    report("flat page gather (torch indexing), CUDA events, each request "
           f"reading {page_bytes} B as indexed and writing {page_bytes} B: "
           + "; ".join(f"{k} {v:.3f} ms ({variants[k].shape[0]} requests, "
                       f"{2 * page_bytes * variants[k].shape[0] / v / 1e6:.1f}"
                       " GB/s as indexed)" for k, v in flat.items()))
    flat4, flat1 = flat["same"], flat["one"]
    del tier4

    sel = op.Select((op.Predicate("c1", "<", 64.0),
                     op.Predicate("c2", ">", 16.0)))
    pipes = {
        "selection": (sel,),
        "projection": (op.Project(("c0", "c3", "c5")),),
        "smart_addressing": (op.SmartAddress(tuple(
            f"c{i}" for i in TIER_SMART_IDX)),),
        "group_by": (op.GroupBy("c0", ("c1", "c2"), n_buckets=64),),
        "selection_post_encrypt": (sel, op.Crypt(KEY_POST, NONCE_POST,
                                                 "post")),
    }

    # ---- the counted run: each verb's cold round (flushed without a host
    # sync), then its hot round; every cold result bitwise the hot one
    reset_launches(kernels)
    d0 = node.dispatches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, p in pipes.items():
        cold_res = tiered_round(fv, node, qps, cold, p, strict=True)
        hot_res = tiered_round(fv, node, qps, hot, p, strict=False)
        want = node.pool.tier_read_bytes(
            cold, fv.compile_pipeline(cold, p).read_cols)
        for c_res, h_res in zip(cold_res, hot_res):
            same_result(c_res, h_res, f"cold {name}")
            if not c_res.read_bytes == want < h_res.read_bytes:
                raise AssertionError(f"cold {name}: read {c_res.read_bytes}"
                                     f", tier_read_bytes {want}, hot "
                                     f"{h_res.read_bytes}")
        r0 = cold_res[0]
        report(f"cold {name}: {N_CONNECTIONS} results bitwise equal to the "
               f"hot round ({r0.count if r0.kind == 'rows' else 'groups'}"
               f", shipped {r0.shipped_bytes} B each); read "
               f"{r0.read_bytes} B = tier_read_bytes, "
               f"{r0.read_bytes / hot_res[0].read_bytes:.4f} of the hot "
               f"read")
        del cold_res, hot_res
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(kernels)
    dispatches = node.dispatches - d0
    report(f"tiered path: {2 * len(pipes)} rounds in {dispatches} "
           f"dispatches, {run_ms:.3f} ms, launches {launches}, cold rounds "
           "with no host sync before finalize")
    if dispatches != 2 * len(pipes) or launches["tier_gather"] != len(pipes):
        raise AssertionError("tiered path: the cold rounds did not stack "
                             "into one tier_gather launch each")

    p50 = {f"cold_{k}": v for k, v in verb_p50(
        fv, node, qps, {k: (cold, p) for k, p in pipes.items()}, report,
        strict=True).items()}
    p50.update({f"hot_{k}": v for k, v in verb_p50(
        fv, node, qps, {k: (hot, p) for k, p in pipes.items()},
        report).items()})
    for k in pipes:
        report(f"p50 {k}: cold {p50[f'cold_{k}']:.3f} ms, hot "
               f"{p50[f'hot_{k}']:.3f} ms "
               f"({p50[f'cold_{k}'] / p50[f'hot_{k}']:.3f}x)")
    profile_rounds(fv, node, qps, {f"cold {k}": (cold, p)
                                   for k, p in pipes.items()}, report)
    profile_rounds(fv, node, qps, {"hot selection": (hot, pipes[
        "selection"])}, report)

    # ---- promotion of a subset, timed; the promoted pages bitwise hot
    subset = list(range(0, 2 * TIER_PROMOTE, 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    promoted = node.pool.promote_table(cold, page_idx=subset)
    promote_s = time.perf_counter() - t0
    idx = torch.tensor(subset, device="cuda")
    if promoted != len(subset) or word_err(
            buf[node.pool.pages_of(cold)[idx]], buf[pages[idx]]):
        raise AssertionError("promoted pages differ from the hot copy's")
    report(f"promote_table of {promoted} pages: {promote_s:.3f} s on the "
           f"host; the promoted pages bitwise equal to the hot copy's")
    t0 = time.perf_counter()
    rest = node.pool.promote_table(cold, page_idx=range(
        2 * TIER_PROMOTE, len(cold.pages), 2))
    bits = node.pool.tier_bits(cold)
    if not (bits[1::2].all() and not bits[::2].any()):
        raise AssertionError("the mixed layout is not every other page cold")
    report(f"promote_table of {rest} more pages: "
           f"{time.perf_counter() - t0:.3f} s; every other page cold")
    for name, p in pipes.items():
        mixed = tiered_round(fv, node, qps, cold, p, strict=True)
        hot_res = tiered_round(fv, node, qps, hot, p, strict=False)
        for m_res, h_res in zip(mixed, hot_res):
            same_result(m_res, h_res, f"mixed {name}")
        report(f"mixed-tier {name}: bitwise equal to the hot round")
        del mixed, hot_res
    for qp in qps:
        fv.close_connection(qp)
    entry = {"name": "tier_gather", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/tier_gather.cu",
             "replaces": "src/repro/kernels/tier.py:51",
             "launches": None, "max_abs_err": float(err), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
             "library_ms": None, "shape": [b, n, 8],
             "ms_3_columns": ms3, "bound_ms_3_columns": bound3,
             "flat_gather_ms": flat4, "flat_gather_b1_ms": flat1,
             "flat_gather_rotated_ms": flat["rotated"],
             "flat_gather_b3_ms": flat["same3"],
             "flat_gather_b3_disjoint_ms": flat["disjoint3"],
             "demote_s": demote_s, "promote_s": promote_s,
             "effective_capacity": summary["effective_capacity"]}
    return launches, p50, entry


def trace_call(name, fn, report, reps=5):
    """`reps` traced calls after one untraced: a call's wall clock, the
    device's busy share of it and the largest device items, per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    rows = [(d / reps, k, c // reps) for d, k, c in device_rows(prof)]
    busy = sum(r[0] for r in rows)
    report(f"profile {name}, per call of {reps}: wall {wall_us / 1e3:.3f} ms, "
           f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%, "
           f"idle {100 - 100 * busy / wall_us:.1f}%); top: "
           + "; ".join(f"{k[:48]} x{c} {d / 1e3:.3f} ms"
                       for d, k, c in rows[:8]))


def ptxas_lines(log):
    """The register and spill lines of `nvcc -Xptxas=-v`, each after the
    (demangled, where `c++filt` exists) kernel it reports on."""
    names, out, entry = [], [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            names.append(entry)
        elif "registers" in line or "spill" in line:
            out.append((entry, line.split(":", 1)[-1].strip()))
    plain = dict(zip(names, names))
    if names and shutil.which("c++filt"):
        demangled = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True, check=True,
                                   timeout=60).stdout.splitlines()
        plain.update(zip(names, (d.replace("(anonymous namespace)::", "")
                                 .split("(")[0] for d in demangled)))
    return [f"{plain.get(entry, '?')}: {text}" for entry, text in out]


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch as fv
    from repro_torch.core import operators as op
    from repro_torch.kernels import _build
    from repro_torch.core.regex import compile_regex
    from repro_torch.core import far_kv as fk
    from repro_torch.kernels import ctr_crypt as ctr
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dfa_match as dfa
    from repro_torch.kernels import hash_group as hg
    from repro_torch.kernels import hash_join as hj
    from repro_torch.kernels import ref
    from repro_torch.kernels import select_project as sp
    from repro_torch.kernels import tier as tg
    from repro_torch.core import pool as fpool
    # every kernel wrapper's launch counter, by the JSON line's names
    kernels = {"select_project": sp.select_project,
               "ctr_crypt": ctr.ctr_crypt,
               "ctr_crypt_bytes": ctr.ctr_crypt_bytes,
               "hash_group": hg.group_aggregate,
               "group_prep": hg.group_prep,
               "hash_join": hj.hash_join,
               "dfa_match": dfa.dfa_match,
               "decode_attention": da.decode_attention,
               "tier_gather": tg.tier_gather}
    # f32 products in full f32 (the defaults, stated): no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def report(line):
        print(line, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    report(smi)
    report(f"torch {torch.__version__} cuda {torch.version.cuda} device "
           f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_all()
    report(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, log in sorted(_build.build_log.items()):
        for line in ptxas_lines(log):
            report(f"  {src}: {line}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n = 1 << ROWS_LOG2
    entries = [check_select_project(sp, gen, N_CONNECTIONS, n, report)]
    torch.cuda.empty_cache()
    entries.append(check_ctr_crypt(ctr, gen, N_CONNECTIONS, n * 8,
                                   report))
    torch.cuda.empty_cache()
    entries.append(check_ctr_crypt_bytes(ctr, gen, N_CONNECTIONS, report))
    torch.cuda.empty_cache()
    entries += check_hash_group(hg, ref, gen, N_CONNECTIONS, n, report)
    torch.cuda.empty_cache()
    entries.append(check_hash_join(hj, ref, gen, N_CONNECTIONS,
                                   1 << JOIN_ROWS_LOG2, report))
    torch.cuda.empty_cache()
    entries.append(check_dfa_match(dfa, compile_regex, gen, N_CONNECTIONS,
                                   report))
    torch.cuda.empty_cache()
    entries.append(check_decode_attention(da, gen, report))
    torch.cuda.empty_cache()

    node = fv.FViewNode(4 * 2**30, device="cuda")
    qps = [fv.open_connection(node) for _ in range(N_CONNECTIONS)]
    rows_launches, p50 = rows_path(fv, op, sp, ctr, kernels, gen, node, qps,
                                   n, report)
    torch.cuda.empty_cache()
    group_launches, group_p50 = group_path(fv, op, hg, sp, kernels, gen,
                                           node, qps, n, report)
    p50.update(group_p50)
    torch.cuda.empty_cache()
    join_launches, join_p50 = join_path(fv, op, hj, sp, ctr, kernels, gen,
                                        node, qps, report)
    p50.update(join_p50)
    torch.cuda.empty_cache()
    wide_launches, wide_p50 = wide_path(fv, op, sp, kernels, gen, node, qps,
                                        report)
    p50.update(wide_p50)
    torch.cuda.empty_cache()
    regex_launches, regex_p50 = regex_path(fv, op, dfa, ctr, compile_regex,
                                           kernels, args.seed, node, qps,
                                           report)
    p50.update(regex_p50)
    for qp in qps:
        fv.close_connection(qp)
    del node, qps
    torch.cuda.empty_cache()
    kv_launches, kv_p50 = far_kv_path(fk, ref, kernels, gen, args.seed,
                                      report)
    p50.update(kv_p50)
    torch.cuda.empty_cache()
    check_tier_gather(tg, fpool, fv, args.seed, report)
    tier_launches, tier_p50, tier_entry = tiered_path(
        fv, op, tg, fpool, kernels, gen, report)
    entries.append(tier_entry)
    p50.update(tier_p50)
    # launches: the counted runs of all paths together
    for e in entries:
        e["launches"] = sum(run[e["name"]] for run in (
            rows_launches, group_launches, join_launches, wide_launches,
            regex_launches, kv_launches, tier_launches))
    report(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    report(f"p50 ms per verb: {json.dumps(p50)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
