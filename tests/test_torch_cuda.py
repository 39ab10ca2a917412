"""The port's CUDA kernels on the card, at edge shapes, against their plain
versions; and the node's request mix on the card against the CPU.

Marked `cuda`: these need an NVIDIA GPU and `nvcc` and skip elsewhere.
Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

`chip_smoke.py` covers the main path's shapes (2^25-row stacks); these
cover the ragged ones: row counts that are not a multiple of the kernel's
1024-row block, 1..32 columns, odd stream lengths, single requests.
"""
import numpy as np
import pytest
import torch

import repro_torch as fv
from repro_torch.core import operators as op
from repro_torch.kernels import ctr_crypt as tctr
from repro_torch.kernels import select_project as tsp

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _table(seed, shape):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=shape).astype(np.float32)
    flat = t.reshape(-1)
    for v in (np.inf, -np.inf, np.nan, -0.0, 0.0):
        flat[rng.integers(0, flat.size, size=max(1, flat.size // 50))] = v
    flat[rng.integers(0, flat.size, size=max(1, flat.size // 50))] = (
        np.array([5, 0x807FFFFF], np.uint32).view(np.float32)[0])
    return t


@pytest.mark.parametrize("n", [1, 255, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("c", [1, 3, 9, 32])
def test_select_project_kernel_matches_plain(card, n, c):
    rng = np.random.default_rng(n * 100 + c)
    b = 3
    table = torch.from_numpy(_table(c, (b, n, c))).to(card)
    ops = rng.integers(0, 8, size=c).astype(np.int32)
    vals = rng.normal(size=c).astype(np.float32)
    proj = (rng.random(c) < 0.6).astype(np.float32)
    n_valid = torch.tensor([n, n // 2, max(0, n - 7)], dtype=torch.int32,
                           device=card)
    before = tsp.select_project.launches
    got, cnt = tsp.select_project(table, ops, vals, proj, n_valid)
    exp, ecnt = tsp.select_project_plain(table, ops, vals, proj, n_valid)
    torch.cuda.synchronize()
    assert tsp.select_project.launches == before + 1
    assert torch.equal(cnt, ecnt)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("length", [1, 2, 3, 1001, 65537])
@pytest.mark.parametrize("with_idx", [False, True])
def test_ctr_crypt_kernel_matches_plain(card, length, with_idx):
    rng = np.random.default_rng(length)
    data = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, length),
                                         dtype=np.int64).astype(np.int32))
    idx = None
    if with_idx:
        idx = torch.from_numpy(rng.integers(-2**31, 2**31, size=(2, length),
                                            dtype=np.int64).astype(np.int32))
        idx = idx.to(card)
    data = data.to(card)
    before = tctr.ctr_crypt.launches
    got = tctr.ctr_crypt(data, (0xA5A5A5A5, 0x5A5A5A5A), 0xFFFFFFFF, idx=idx)
    exp = tctr.ctr_crypt_plain(data, (0xA5A5A5A5, 0x5A5A5A5A), 0xFFFFFFFF,
                               idx=idx)
    torch.cuda.synchronize()
    assert tctr.ctr_crypt.launches == before + 1
    assert torch.equal(got, exp)


def test_flush_never_waits_for_the_card(card):
    """The lazy contract: from submit through flush nothing synchronises
    with the device (torch raises on a synchronising call while the sync
    debug mode is "error"); finalize is where the host waits."""
    node = fv.FViewNode(8 * 2**20, page_bytes=64 * 2**10, device=card)
    qps = [fv.open_connection(node) for _ in range(2)]
    cols = tuple(fv.Column(f"c{i}") for i in range(8))
    ft = fv.alloc_table_mem(qps[0], fv.FTable("t", cols, 3000))
    fv.table_write(qps[0], ft, _table(0, (3000, 8)))
    sel = op.Select((op.Predicate("c1", "<", 0.1),))
    pipes = [(sel,), (op.SmartAddress(("c5", "c2")), sel),
             (op.Crypt((1, 2), 3, "pre"), op.Project(("c0",)), sel,
              op.Crypt((4, 5), 6, "post")),
             (op.Crypt((1, 2), 3, "pre"), op.SmartAddress(("c3", "c1")),
              sel)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        reqs = [fv.submit_request(qp, ft, p) for p in pipes for qp in qps]
        reqs.append(fv.submit_request(qps[0], ft, pipes[2],
                                      row_ids=np.arange(3000) + 9))
        node.flush()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(r.wait().count >= 0 for r in reqs)
    assert node.dispatches == len(pipes) + 1


def test_node_mix_on_the_card_matches_the_cpu(card):
    results = []
    for device in (card, torch.device("cpu")):
        node = fv.FViewNode(8 * 2**20, page_bytes=64 * 2**10, device=device)
        qps = [fv.open_connection(node) for _ in range(3)]
        cols = tuple(fv.Column(f"c{i}") for i in range(8))
        tables = []
        for i, n in enumerate((3000, 2100, 700)):
            ft = fv.alloc_table_mem(qps[0], fv.FTable(f"t{i}", cols, n))
            fv.table_write(qps[0], ft, _table(i, (n, 8)))
            tables.append(ft)
        sel = op.Select((op.Predicate("c1", "<", 0.1),))
        pipes = [(sel,), (op.SmartAddress(("c5", "c2")), sel),
                 (op.Crypt((1, 2), 3, "pre"), sel, op.Crypt((4, 5), 6,
                                                            "post"))]
        reqs = [fv.submit_request(qp, ft, p)
                for p in pipes for qp, ft in zip(qps, tables)]
        reqs.append(fv.submit_request(qps[0], tables[0], pipes[0],
                                      row_ids=np.arange(3000) * 2 + 1))
        node.flush()
        res = [r.wait() for r in reqs]
        results.append(([r.rows.cpu() for r in res],
                         [(r.count, r.shipped_bytes, r.read_bytes)
                          for r in res], res[-1].sel_ids, node.dispatches,
                         [(qp.bytes_read_pool, qp.bytes_shipped)
                          for qp in qps]))
    (rows_g, meta_g, ids_g, disp_g, qp_g), (rows_c, meta_c, ids_c, disp_c,
                                            qp_c) = results
    assert meta_g == meta_c and disp_g == disp_c and qp_g == qp_c
    np.testing.assert_array_equal(ids_g, ids_c)
    for g, c in zip(rows_g, rows_c):
        assert torch.equal(g.view(torch.int32), c.view(torch.int32))


def test_call_without_device_runs_on_the_card(card):
    cols = tuple(fv.Column(f"c{i}") for i in range(8))
    pipe = fv.compile_pipeline(fv.FTable("t", cols, 0), (
        op.Crypt((1, 2), 3, "pre"), op.Select((op.Predicate("c1", "<",
                                                            0.1),)),
        op.Crypt((4, 5), 6, "post")))
    rows = _table(5, (3000, 8))
    ids = np.arange(3000) * 3 + 2
    before = (tsp.select_project.launches, tctr.ctr_crypt.launches)
    got = pipe(rows, row_ids=ids)                   # numpy in, card runs
    assert got.rows.device.type == "cuda"
    assert (tsp.select_project.launches, tctr.ctr_crypt.launches) == (
        before[0] + 1, before[1] + 2)
    exp = pipe(rows, row_ids=ids, device="cpu")
    assert (got.count, got.shipped_bytes, got.read_bytes) == (
        exp.count, exp.shipped_bytes, exp.read_bytes)
    np.testing.assert_array_equal(got.sel_ids, exp.sel_ids)
    assert torch.equal(got.rows.cpu().view(torch.int32),
                       exp.rows.view(torch.int32))
