"""Build, load and launch the package's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  Builds
happen at first use (never at import), all sources in parallel, into
``build/repro_torch/`` at the repository root, keyed by a hash of the
sources and flags — so a fresh checkout builds itself.  A failed build
raises with nvcc's stderr.  Building and loading hold one process-wide
lock, so threads that first use a kernel together build it once.

Every launch runs on ``torch.cuda.current_stream()``, allocates nothing, and
returns ``cudaGetLastError()``; :func:`launch` raises when it is non-zero
and counts the launch in :data:`LAUNCHES` (a plain integer per kernel).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source name -> (C entry point, argtypes)
ENTRY = {
    "rowgather": ("rowgather_launch",
                  [_P, _I, _L, _I, _P, _L, _L, _P, _P, _I, _I, _L, _I, _L,
                   _L, _P]),
    "dma": ("dma_launch",
            [_P, _I, _L, _I, _P, _L, _L, _P, _P, _I, _I, _L, _L, _I, _I, _I,
             _L, _P]),
    "dedup": ("dedup_launch",
              [_P, _I, _L, _I, _P, _L, _L, _I, _P, _P, _I, _I, _P]),
    "rowgather_int8": ("rowgather_int8_launch",
                       [_P, _L, _I, _P, _P, _L, _L, _P, _P, _P, _P, _I, _I,
                        _L, _L, _I, _I, _L, _P]),
    "dedup_int8": ("dedup_int8_launch",
                   [_P, _L, _I, _P, _P, _L, _L, _I, _P, _P, _P, _P, _I, _I,
                    _P]),
    "bitonic": ("bitonic_launch", [_P, _P, _P, _P, _P, _P, _L, _I, _P]),
}

# an H100 SXM's streaming multiprocessors: what the launch plans assume
# when they are asked about no card (the CPU tests)
H100_SMS = 132
# the most dynamic shared memory one block may take on Hopper (227 KB)
SMEM_MAX = 232_448

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"l2dist_rowgather": 0, "l2dist_dma": 0,
                            "dedupdist": 0, "int8dist_rowgather": 0,
                            "dedupdist_int8": 0, "sort_pairs": 0}
BUILD_LOG: Dict[str, str] = {}      # source name -> nvcc/ptxas output
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
# serializes build() and the first load of each library; re-entrant, since
# _func builds under it
_BUILD_LOCK = threading.RLock()
# the launch counts are read-modify-written by every launch
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (on PATH or under CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> List[str]:
    """Compile every named source (default: all) whose library is missing,
    one ``nvcc`` per source, all started together.  Returns the names
    built."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Optional[Iterable[str]]) -> List[str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ENTRY if names is None else names:
        out = _lib_path(name)
        if out.exists():
            continue
        # per process and thread: no two builders write one file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOG[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{stderr}")
            continue
        os.replace(tmp, out)     # atomic: concurrent builders never race
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return list(procs)


def _func(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        with _BUILD_LOCK:
            fn = _FUNCS.get(name)
            if fn is None:
                build([name])
                entry, argtypes = ENTRY[name]
                fn = getattr(ctypes.CDLL(str(_lib_path(name))), entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FUNCS[name] = fn
    return fn


def launch(source: str, kernel: str, *args) -> None:
    """Call ``source``'s C entry point with ``args`` (tensors become device
    pointers) on the current stream; raise on a non-zero CUDA error and
    count the launch under ``kernel``."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = _func(source)(*c_args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def vec_ok(table: torch.Tensor, queries: torch.Tensor) -> int:
    """1 when rows and query rows can be read as aligned 16-byte chunks."""
    per16 = 16 // table.element_size()
    d = table.shape[1]
    return int(d % per16 == 0 and table.data_ptr() % 16 == 0
               and queries.data_ptr() % 16 == 0)


def int8_vec_ok(codes: torch.Tensor, qc: torch.Tensor) -> int:
    """1 when int8 code rows can be read as 4-byte words and staged as
    16-byte chunks, and int32 query codes as 16-byte chunks (d a multiple
    of 16, both tables 16-byte aligned)."""
    return int(codes.shape[1] % 16 == 0 and codes.data_ptr() % 16 == 0
               and qc.data_ptr() % 16 == 0)


def check_int8_inputs(kernel: str, codes: torch.Tensor,
                      scales: torch.Tensor, ids: torch.Tensor,
                      queries: torch.Tensor) -> None:
    """:func:`check_inputs` for an int8 codes table with its (N, 1) f32
    per-vector scales."""
    if scales.dtype != torch.float32:
        raise TypeError(f"{kernel}: scales must be float32, got "
                        f"{scales.dtype}")
    if scales.device != codes.device:
        raise ValueError(f"{kernel}: scales on {scales.device}, codes on "
                         f"{codes.device}")
    if codes.device.type == "cuda" and not scales.is_contiguous():
        raise ValueError(f"{kernel}: CUDA inputs must be contiguous")
    check_inputs(kernel, codes, ids, queries, (torch.int8,))


def check_inputs(kernel: str, table: torch.Tensor, ids: torch.Tensor,
                 queries: torch.Tensor,
                 table_dtypes=(torch.float32, torch.bfloat16)) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    if table.dim() != 2 or ids.dim() != 2 or queries.dim() != 2:
        raise ValueError(f"{kernel}: want table (N, d), ids (B, C), queries "
                         f"(B, d); got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(queries.shape)}")
    if queries.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"{kernel}: queries {tuple(queries.shape)} do not "
                         f"match ids {tuple(ids.shape)} and d = "
                         f"{table.shape[1]}")
    if table.dtype not in table_dtypes:
        raise TypeError(f"{kernel}: table must be one of {table_dtypes}, "
                        f"got {table.dtype}")
    if ids.dtype != torch.int32 or queries.dtype != torch.float32:
        raise TypeError(f"{kernel}: ids must be int32 and queries float32, "
                        f"got {ids.dtype} and {queries.dtype}")
    devs = {table.device, ids.device, queries.device}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devs}")
    dev = table.device
    if dev.type == "cuda":
        if not (table.is_contiguous() and ids.is_contiguous()
                and queries.is_contiguous()):
            raise ValueError(f"{kernel}: CUDA inputs must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"{kernel}: unsupported device {dev}")
