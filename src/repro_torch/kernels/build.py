"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into ``build/<name>-<hash>.so`` next to this file, with a plain C
interface (one entry per dtype, each returning ``cudaGetLastError()``).
The hash covers the sources and the flags, so an edited kernel rebuilds
and an unchanged one is reused.  Nothing is built at import: the first
wrapper call builds what it needs, and ``build_all`` builds every kernel
at once, one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("switched_mlp", "fused_dispatch", "mcma_mlp", "slstm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    """Where the shared library for ``csrc/<name>.cu`` is (or will be)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed kernel that is not built yet, in parallel.

    Returns ``{name: compiler output}`` (ptxas register and shared-memory
    report) for the ones compiled by this call; raises on any failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        build_all.compiles += 1
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


build_all.compiles = 0          # nvcc processes started in this process


def load(name: str, entries: dict[str, tuple[int, int]]) -> ctypes.CDLL:
    """Load (building first if needed) ``csrc/<name>.cu``'s library and
    declare each C entry ``fn`` of ``entries[fn] = (n_pointers, n_ints)``
    as taking that many pointers (``c_void_p``), then that many ``c_int``,
    then the stream (``c_void_p``), and returning an ``int`` error code."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    for fn, (n_ptr, n_int) in entries.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = ([ctypes.c_void_p] * n_ptr
                          + [ctypes.c_int] * n_int + [ctypes.c_void_p])
            f.restype = ctypes.c_int
    return lib


RESOURCE_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
                 "cluster")


def resources(name: str, fn: str, args: tuple[int, ...],
              keys: tuple[str, ...] = RESOURCE_KEYS) -> dict[str, int]:
    """What ``cudaFuncGetAttributes`` says of one kernel of
    ``csrc/<name>.cu`` through its C query ``fn(*args, out)``, which takes
    ints and fills ``out`` with one int per key.  The tile routine's
    launchers take (bf16, d_h_p, d_out_p, block_t) and report ``keys``:
    registers per thread, static shared bytes, the dynamic shared bytes of
    a launch at those widths, local (spill) bytes per thread, cluster
    width."""
    f = getattr(load(name, {}), fn)
    f.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * len(keys))()
    err = f(*args, out)
    if err:
        raise RuntimeError(f"{fn}: cudaFuncGetAttributes failed with CUDA "
                           f"error {err}")
    return dict(zip(keys, out))
