"""Build the CUDA kernels of `kernels/csrc/` at first use and bind them.

Each `.cu` file exposes a plain C interface and is compiled by `nvcc` into
its own shared library under `build/torch_kernels/` at the repository
root, then loaded with `ctypes`. All sources compile in parallel, one
`nvcc` process each. A library's file name carries a hash of its source,
the shared `.cuh` headers and the flags, so an edited source or header
rebuilds and an unchanged one loads
straight from the build directory. Nothing here runs at import time: the
first kernel launch (or `load_all()`) builds.

Pointers and the stream cross as `ctypes.c_void_p`, sizes as `c_longlong`
or `c_int`, an attention scale as `c_float`, and every launch function
returns `cudaGetLastError()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("select_project.cu", "ctr_crypt.cu", "hash_group.cu",
           "hash_join.cu", "dfa_match.cu", "decode_attention.cu",
           "tier_gather.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "select_project.cu": {
        "sp_count": ([_P, _P, _I, _P, _P, _LL, _I, _I, _P], _I),
        "sp_pack": ([_P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _P], _I),
        "sp_rows_per_block": ([], _I),
        "sp_error_string": ([_I], ctypes.c_char_p),
    },
    "ctr_crypt.cu": {
        "ctr_crypt": ([_P, _P, _P, _LL, _I, _U, _U, _U, _P], _I),
        "ctr_crypt_bytes": ([_P, _P, _P, _LL, _I, _I, _U, _U, _U, _P], _I),
        "ctr_error_string": ([_I], ctypes.c_char_p),
    },
    "hash_group.cu": {
        "hg_prep": ([_P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _LL, _I, _P],
                    _I),
        "hg_bucket": ([_P, _P, _LL, _I, _I, _P], _I),
        "hg_claim": ([_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P], _I),
        "hg_aggregate": ([_P] * 15 + [_LL, _I, _I, _I, _I, _I, _I, _P],
                         _I),
        "hg_piece_rows": ([], _I),
        "hg_direct": ([_P] * 13 + [_LL, _I, _I, _I, _I, _LL, _P], _I),
        "hg_direct_parts": ([_LL], _LL),
        "hg_direct_chunk": ([_I], _I),
        "hg_overflow": ([_P, _P, _P, _LL, _I, _I, _P], _I),
        "hg_max_vals": ([], _I),
        "hg_error_string": ([_I], ctypes.c_char_p),
    },
    "hash_join.cu": {
        "hj_probe": ([_P, _LL, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _LL,
                      _I, _P], _I),
        "hj_error_string": ([_I], ctypes.c_char_p),
    },
    "dfa_match.cu": {
        "dfa_match": ([_P, _P, _P, _P, _P, _I, _P, _LL, _I, _I, _P], _I),
        "dfa_max_states": ([], _I),
        "dfa_max_width": ([], _I),
        "dfa_error_string": ([_I], ctypes.c_char_p),
    },
    "decode_attention.cu": {
        "da_partial": ([_P, _LL, _LL, _I] + [_P] * 6
                       + [_LL, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
        "da_combine": ([_P] * 6 + [_LL, _I, _I, _I, _I, _P], _I),
        "da_blocks_per_sm": ([_I, _I, _I], _I),
        "da_smem_bytes": ([_I, _I, _I], _I),
        "da_stage_rows": ([_I, _I, _I], _I),
        "da_split_rows": ([_I, _I, _I], _I),
        "da_group_chunk": ([], _I),
        "da_error_string": ([_I], ctypes.c_char_p),
    },
    "tier_gather.cu": {
        "tier_gather": ([_P, _LL, _I] + [_P] * 6
                        + [_LL, _I, _P, _I, _LL, _I, _P, _P], _I),
        "tg_error_string": ([_I], ctypes.c_char_p),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}   # guarded-by: _LOCK
_LOCK = threading.Lock()
# nvcc/ptxas report (registers, shared memory, spills) of each source built
build_log: dict[str, str] = {}       # guarded-by: _LOCK


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels are "
                           "built from kernels/csrc/ at first use")
    return path


def _target(src: str) -> Path:
    # the shared headers (`*.cuh`) enter every source's hash
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / src).read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(src).stem}-{digest[:16]}.so"


def _load(src: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES[src].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) every source not yet built and load them all."""
    with _LOCK:
        missing = [s for s in SOURCES if s not in _LIBS]
        if not missing:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in missing:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        for src in missing:
            _LIBS[src] = _load(src, _target(src))
        return dict(_LIBS)


def lib(src: str) -> ctypes.CDLL:
    """The loaded library of one source file, building all on first use."""
    with _LOCK:
        found = _LIBS.get(src)
    return found if found is not None else load_all()[src]


def upload(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values -> a tensor on `device` without synchronising: on the
    card through pinned memory and a non-blocking copy (a copy from
    pageable host memory waits for the stream's queued work; a host
    tensor already pinned is not copied again). A tensor already on a
    device is moved with `.to`."""
    t = torch.as_tensor(values, dtype=dtype)
    if t.device.type != "cpu":
        return t.to(device)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def check(code: int, error_string, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = error_string(code)
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")
