#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit (`nvidia-smi`);
2. build both CUDA kernels from `src/repro_torch/kernels/csrc/` (`nvcc`);
3. each kernel against its plain torch version on the card, at the main
   path's shapes (B=4 stacked requests of 2^25 rows x 8 f32 columns; the
   cipher over 4 streams of 2^28 words): bitwise equal outputs, equal
   counts, inputs with inf/NaN/-0.0/subnormal words, every opcode,
   OP_SKIP columns, n_valid tails, explicit cipher positions. Times each
   (CUDA events, median of 10 after warm-up) beside its plain version,
   a library yardstick where one exists, and its bound;
4. the main path: `FViewNode(4 GiB)` holding a 2^25-row x 8-column table
   (1 GiB, 512 pool pages; the 8-column schema of
   benchmarks/bench_selection.py) and an encrypted copy, four connections
   each submitting selection (~10%), projection, smart addressing,
   selection + post-encrypt and pre-decrypt + selection in one round;
   flush (with torch's sync debug mode set to raise: nothing before
   finalize may wait for the card), finalize, check every result bitwise
   against the plain path on the same data, check both kernels' launch
   counters moved during the run and that same-signature requests
   stacked; then per-verb p50;
5. a JSON line with every kernel's numbers, and the last line
   `{"ok": true, "device": {...}}`.

Exits 2 without a result where torch sees no CUDA device.
"""
from __future__ import annotations

import argparse
import json
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
# 32-bit integer instructions: 64 INT32 lanes per SM (NVIDIA's H100
# whitepaper), same SMs and clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The cipher's instructions per word, counted in the kernel's SASS
# (`cuobjdump -sass` of the sm_90a build): per counter block 2 initial key
# adds, 20 rounds of add + funnel-shift rotate + xor, 5 key injections of
# 2 adds (the round constant folds into a three-input add) = 72; one block
# serves two words, each XORed with its data word once. Index arithmetic
# the kernel also issues is its own overhead, not the function's work.
CIPHER_OPS_PER_WORD = 72 / 2 + 1
ROWS_LOG2 = 25                # 2^25 rows x 8 f32 words = a 1 GiB table
KEY_PRE, NONCE_PRE = (0x0BADF00D, 0x5EED5EED), 1234
KEY_POST, NONCE_POST = (0x12345678, 0x9ABCDEF0), 99
SEL_THRESHOLD = -1.2815516            # P(N(0,1) < t) = 0.10
N_CONNECTIONS = 4


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of `reps` timed calls (CUDA events), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
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
    return {"name": "select_project", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/select_project.cu",
            "replaces": "src/repro/kernels/select_project.py:78",
            "launches": None, "max_abs_err": float(err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                         >= compares / FP32_OPS_PER_S else "operations"),
            "library_ms": library_ms,
            "shape": [b, n, 8]}


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


def main_path(fv, op, sp, ctr, gen, n_rows, report):
    """Drive the port's verbs once through FViewNode; returns the launch
    counts of the counted run and the per-verb p50s."""
    node = fv.FViewNode(4 * 2**30, device="cuda")
    qps = [fv.open_connection(node) for _ in range(N_CONNECTIONS)]
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
    sp.select_project.launches = 0
    ctr.ctr_crypt.launches = 0
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
    launches = {"select_project": sp.select_project.launches,
                "ctr_crypt": ctr.ctr_crypt.launches}
    dispatches = node.dispatches - d0
    report(f"main path: {N_CONNECTIONS * len(verbs)} requests in "
           f"{dispatches} dispatches, {run_ms:.3f} ms, launches {launches}, "
           f"no host sync before finalize")
    if dispatches != len(verbs):
        raise AssertionError(f"{dispatches} dispatches for {len(verbs)} "
                             f"distinct signatures: requests did not stack")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} kernel never launched on the "
                                 f"main path")

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
    p50 = {}
    for name, (t, p) in verbs.items():
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [fv.submit_request(qp, t, p) for qp in qps]
            node.flush()
            for r in reqs:
                r.wait()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50[name] = statistics.median(times)
        report(f"p50 {name}: {p50[name]:.3f} ms for {N_CONNECTIONS} "
               f"stacked requests (runs {[round(x, 3) for x in times]})")
    for qp in qps:
        fv.close_connection(qp)
    return launches, p50


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch as fv
    from repro_torch.core import operators as op
    from repro_torch.kernels import _build
    from repro_torch.kernels import ctr_crypt as ctr
    from repro_torch.kernels import select_project as sp

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                report(f"  {src}: {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n = 1 << ROWS_LOG2
    entries = [check_select_project(sp, gen, N_CONNECTIONS, n, report)]
    torch.cuda.empty_cache()
    entries.append(check_ctr_crypt(ctr, gen, N_CONNECTIONS, n * 8,
                                   report))
    torch.cuda.empty_cache()

    launches, p50 = main_path(fv, op, sp, ctr, gen, n, report)
    for e in entries:
        e["launches"] = launches[e["name"]]
    report(f"peak device memory: {torch.cuda.max_memory_allocated()} bytes")
    report(f"p50 ms per verb: {json.dumps(p50)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
