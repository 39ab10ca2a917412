"""The port stands alone: `src/repro_torch/` and `chip_smoke.py` import
neither jax nor anything of the JAX package `repro`.

Two checks: a subprocess imports `repro_torch`, runs a selection, a
join, a GroupBy request (merged client-side), a RegexMatch over a
string table, the same over its bytes encrypted and deciphered by a
pre-Crypt, a far-KV decode step and a selection over a table demoted
to the cold tier (the page codec of `repro_torch/distributed/` and the
tiered gather of `kernels/tier.py`) on the CPU and then finds no `jax`
and no `repro` module loaded, and the tiering modules loaded; an AST scan
of every port file (`distributed/` and `kernels/tier.py` among them) and
of `chip_smoke.py` finds no such import statement.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_PROBE = """
import sys
import numpy as np
import repro_torch as fv
from repro_torch.core import operators as op
node = fv.FViewNode(8 * 2**20, device="cpu")
qp = fv.open_connection(node)
ft = fv.alloc_table_mem(qp, fv.FTable("t", (fv.Column("a"), fv.Column("b")),
                                      n_rows=64))
fv.table_write(qp, ft, np.arange(128, dtype=np.float32).reshape(64, 2))
res = fv.farview_request(qp, ft, (op.Select((op.Predicate("a", "<", 20.0),)),
                                  op.Crypt((1, 2), 3, "post")))
assert res.count == 10, res.count
dim = fv.alloc_table_mem(qp, fv.FTable("dim", (fv.Column("k"), fv.Column("v")),
                                       n_rows=8))
fv.table_write(qp, dim, np.arange(16, dtype=np.float32).reshape(8, 2) * 2)
res = fv.farview_request(qp, ft, (op.JoinSmall("a", "dim", "k", ("v",)),))
assert res.count == 8, res.count
group = (op.GroupBy("a", ("b",), n_buckets=16),)
merged = fv.merge_group_partials(ft, group,
                                 [fv.farview_request(qp, ft, group)])
assert sorted(merged.groups) == list(range(0, 128, 2)), merged.groups
sft, mat, lens = fv.string_table("s", [b"error: disk", b"fine", b"an error"],
                                 16)
res = fv.farview_request(qp, sft, (op.RegexMatch("err(or)?"),),
                         strings=mat, lengths=lens)
assert res.mask.tolist() == [True, False, True], res.mask
import torch
from repro_torch.kernels import ctr_crypt
enc = ctr_crypt.ctr_crypt_bytes_plain(torch.from_numpy(mat.reshape(1, -1)),
                                      (1, 2), 3).numpy().reshape(mat.shape)
res = fv.farview_request(qp, sft, (op.Crypt((1, 2), 3, "pre"),
                                   op.RegexMatch("err(or)?")),
                         strings=enc, lengths=lens)
assert res.mask.tolist() == [True, False, True], res.mask
from repro_torch.core import far_kv
eye = np.eye(8, dtype=np.float32)
w = far_kv.block_weights_from_numpy(eye, eye[:, :4], eye[:, :4], eye, tp=2,
                                    n_q_heads=4, n_kv_heads=2, head_dim=2,
                                    device="cpu")
kc, vc = far_kv.shard_cache(np.ones((1, 8, 2, 2), np.float32),
                            np.ones((1, 8, 2, 2), np.float32), tp=2,
                            mode="far", device="cpu")
out, _, _ = far_kv.attend_block(torch.ones((1, 8)), w, kc, vc, 3,
                                torch.tensor([3]), n_q_heads=4,
                                n_kv_heads=2, head_dim=2)
assert out.shape == (1, 8), out.shape
cold = fv.alloc_table_mem(qp, fv.FTable("cold", (fv.Column("a"),
                                                 fv.Column("b")), n_rows=64))
fv.table_write(qp, cold, np.arange(128, dtype=np.float32).reshape(64, 2))
assert node.pool.demote_table(cold) == 1
res = fv.farview_request(qp, cold, (op.Select((op.Predicate("a", "<",
                                                            20.0),)),))
assert res.count == 10 and node.pool.is_tiered(cold), res.count
assert res.read_bytes < cold.n_bytes, res.read_bytes
for mod in ("repro_torch.distributed.compress", "repro_torch.kernels.tier"):
    assert mod in sys.modules, mod
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_import_and_request_load_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_scan_covers_every_port_subpackage():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for path in ("src/repro_torch/distributed/compress.py",
                 "src/repro_torch/kernels/tier.py",
                 "src/repro_torch/core/pool.py", "chip_smoke.py"):
        assert path in scanned, path
