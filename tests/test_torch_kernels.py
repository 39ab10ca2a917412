"""The port's kernel modules against the JAX reference, on the CPU.

The CUDA kernels cannot run here (no card); what runs is each kernel's
plain torch version, through the same dispatch wrapper the pipeline calls.
It is held BITWISE to the JAX contracts: `repro.kernels.ops.
select_project_xla` (with validity masks, inf/NaN rows), the Pallas
`select_project` in interpret mode (finite data: the Pallas kernel
projects by multiplying, so non-finite values differ there by design),
`repro.kernels.ref.ctr_crypt` (with and without explicit positions) and
the Pallas `ctr_crypt` in interpret mode. Inputs come from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ctr_crypt as tctr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import select_project as tsp

N_COLS = 8
# subnormal words compare as 0.0 in the reference (TPU and XLA on the CPU)
SUBNORMALS = tuple(np.array([0x00000005, 0x80000005, 0x007FFFFF, 0x80400000],
                            np.uint32).view(np.float32))

# (sel_ops, sel_vals, proj_mask): every opcode, OP_SKIP columns, an
# out-of-range code (passes, as in the reference), full and partial
# projections
PLANS = {
    "all_ops": ([1, 2, 3, 4, 5, 6, 0, 0],
                [0.5, 1.0, -1.5, -2.0, 0.0, 0.25, 0, 0],
                [1, 0, 1, 1, 0, 1, 0, 1]),
    "lt_only": ([0, 1, 0, 0, 0, 0, 0, 0], [0, 0.1, 0, 0, 0, 0, 0, 0],
                [1] * 8),
    "ne_nan": ([6, 6, 0, 0, 0, 0, 0, 9], [0.0, 1.0, 0, 0, 0, 0, 0, 0],
               [0, 0, 1, 0, 0, 0, 1, 0]),
    "skip_all": ([0] * 8, [0] * 8, [0, 1, 0, 0, 1, 1, 0, 0]),
    "subnormal_consts": ([5, 2, 3, 0, 0, 0, 0, 0],
                         [SUBNORMALS[0], SUBNORMALS[1], SUBNORMALS[3], 0, 0,
                          0, 0, 0], [1] * 8),
}


def _table(seed: int, n: int, *, finite: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, N_COLS)).astype(np.float32)
    t[rng.random((n, N_COLS)) < 0.05] = 0.0
    if not finite:
        for v in (np.inf, -np.inf, np.nan, -0.0, *SUBNORMALS):
            rows = rng.choice(n, size=max(1, n // 40), replace=False)
            cols = rng.integers(0, N_COLS, size=rows.size)
            t[rows, cols] = v
        # a NaN with a non-default payload must travel bit for bit
        payload = np.array([0x7FC0BEEF], np.uint32).view(np.float32)[0]
        t[rng.integers(0, n), rng.integers(0, N_COLS)] = payload
    return t


def _plan(name):
    ops, vals, proj = PLANS[name]
    return (np.asarray(ops, np.int32), np.asarray(vals, np.float32),
            np.asarray(proj, np.float32))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _port_select(table: np.ndarray, plan, n_valid) -> tuple:
    ops, vals, proj = plan
    nv = torch.tensor(np.atleast_1d(n_valid), dtype=torch.int32)
    packed, count = tops.select_project(
        torch.from_numpy(table.reshape(nv.shape[0], -1, N_COLS)), ops, vals,
        proj, nv)
    return packed.numpy(), count.numpy()


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("tail", [0, 37, 512, 600])
def test_select_project_matches_xla_with_valid_mask(plan, tail):
    n = 600
    table = _table(1, n)
    nv = n - tail
    ops, vals, proj = _plan(plan)
    exp_rows, exp_count = jops.select_project_xla(
        jnp.asarray(table), ops, vals, proj,
        jnp.arange(n) < nv)
    rows, count = _port_select(table, _plan(plan), nv)
    assert int(count[0]) == int(exp_count)
    np.testing.assert_array_equal(_bits(rows[0]), _bits(exp_rows))


@pytest.mark.parametrize("plan", ["all_ops", "lt_only", "skip_all"])
def test_select_project_matches_pallas_interpret_on_finite_data(plan):
    n = 512
    table = _table(2, n, finite=True)
    ops, vals, proj = _plan(plan)
    exp_rows, exp_count = jops.select_project(
        jnp.asarray(table), jnp.asarray(ops), jnp.asarray(vals),
        jnp.asarray(proj), interpret=True)
    rows, count = _port_select(table, _plan(plan), n)
    assert int(count[0]) == int(exp_count)
    np.testing.assert_array_equal(_bits(rows[0]), _bits(exp_rows))


def test_select_project_stack_axis_with_per_request_n_valid():
    b, n = 4, 700
    stack = np.stack([_table(10 + i, n) for i in range(b)])
    n_valid = np.asarray([n, 0, 333, 699], np.int32)
    plan = _plan("all_ops")
    rows, count = _port_select(stack, plan, n_valid)
    for i in range(b):
        exp_rows, exp_count = jops.select_project_xla(
            jnp.asarray(stack[i]), *plan, jnp.arange(n) < n_valid[i])
        assert int(count[i]) == int(exp_count)
        np.testing.assert_array_equal(_bits(rows[i]), _bits(exp_rows))


def _words(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


KEYS = [((0x12345678, 0x9ABCDEF0), 7), ((0xFFFFFFFF, 0), 0xFFFFFFFF),
        ((1, 2), 0)]


@pytest.mark.parametrize("key,nonce", KEYS)
@pytest.mark.parametrize("length", [1, 257, 1000])
def test_ctr_crypt_matches_ref(key, nonce, length):
    data = _words(3, (2, length))
    out = tops.crypt(torch.from_numpy(data.view(np.int32)), key, nonce)
    for b in range(2):
        exp = jref.ctr_crypt(jnp.asarray(data[b]),
                             jnp.asarray(np.asarray(key, np.uint32)), nonce)
        np.testing.assert_array_equal(out[b].numpy().view(np.uint32),
                                      np.asarray(exp))


@pytest.mark.parametrize("key,nonce", KEYS)
def test_ctr_crypt_explicit_positions_match_ref(key, nonce):
    rng = np.random.default_rng(4)
    data = _words(5, (3, 400))
    # partition-style positions: row_id * width + column, plus positions
    # past 2^31 (negative as int32) to pin the uint32 wraparound
    row_ids = rng.choice(10**6, size=(3, 100), replace=False)
    idx = (row_ids[:, :, None] * 4 + np.arange(4)).reshape(3, 400)
    idx[0, :7] = [2**31, 2**32 - 1, 2**31 + 1, 0, 1, 2**32 - 2, 12345]
    idx32 = idx.astype(np.uint32)
    out = tops.crypt(torch.from_numpy(data.view(np.int32)), key, nonce,
                     idx=torch.from_numpy(idx32.view(np.int32)))
    for b in range(3):
        exp = jref.ctr_crypt(jnp.asarray(data[b]),
                             jnp.asarray(np.asarray(key, np.uint32)), nonce,
                             idx=jnp.asarray(idx32[b]))
        np.testing.assert_array_equal(out[b].numpy().view(np.uint32),
                                      np.asarray(exp))


def test_ctr_crypt_matches_pallas_interpret():
    key, nonce = (0xDEADBEEF, 0x01234567), 99
    data = _words(6, (1, 256 * 128 + 5))
    exp = jops.crypt(jnp.asarray(data[0]), np.asarray(key, np.uint32), nonce,
                     interpret=True)
    out = tops.crypt(torch.from_numpy(data.view(np.int32)), key, nonce)
    np.testing.assert_array_equal(out[0].numpy().view(np.uint32),
                                  np.asarray(exp))


@pytest.mark.parametrize("with_idx", [False, True])
def test_ctr_crypt_is_its_own_inverse(with_idx):
    data = torch.from_numpy(_words(7, (2, 999)).view(np.int32))
    idx = (torch.from_numpy(_words(8, (2, 999)).view(np.int32))
           if with_idx else None)
    enc = tops.crypt(data, (5, 6), 11, idx=idx)
    assert not torch.equal(enc, data)
    assert torch.equal(tops.crypt(enc, (5, 6), 11, idx=idx), data)


def test_plain_crypt_chunks_match_one_pass(monkeypatch):
    data = torch.from_numpy(_words(9, (3, 1001)).view(np.int32))
    whole = tctr.ctr_crypt_plain(data, (1, 2), 3)
    monkeypatch.setattr(tctr, "_PLAIN_CHUNK", 64)
    assert torch.equal(tctr.ctr_crypt_plain(data, (1, 2), 3), whole)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is refused, and
    only the dispatch in kernels/ops.py routes CPU tensors to the plain
    versions."""
    table = torch.zeros((1, 8, N_COLS))
    nv = torch.tensor([8], dtype=torch.int32)
    launches = (tsp.select_project.launches, tctr.ctr_crypt.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tsp.select_project(table, *_plan("all_ops"), nv)
    with pytest.raises(ValueError, match="CUDA"):
        tctr.ctr_crypt(torch.zeros((1, 8), dtype=torch.int32), (1, 2), 3)
    tops.select_project(table, *_plan("all_ops"), nv)     # plain version
    assert (tsp.select_project.launches, tctr.ctr_crypt.launches) == launches


def test_dispatch_refuses_other_devices():
    table = torch.zeros((1, 8, N_COLS), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tops.select_project(table, *_plan("all_ops"),
                            torch.zeros((1,), dtype=torch.int32,
                                        device="meta"))
