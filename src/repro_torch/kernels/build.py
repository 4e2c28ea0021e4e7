"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Route (b) of building a Hopper kernel: ``nvcc`` compiles every source with
a plain C interface for ``sm_90a`` (one ``nvcc`` process per source, all
started together), links them into one shared library under the repo's
``build/kernels/`` directory (listed in ``.gitignore``), and ``ctypes``
loads it. No PyTorch headers are compiled, so the build takes seconds.

The library is built on first use — the first kernel launch on a CUDA
tensor — and keyed by a hash of the sources, so an edited source rebuilds.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}      # sources, seconds, compiler output

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "kv_transfer_launch": [_VP, _VP, _VP, _VP, _LL, _LL, _VP, _VP],
    "kv_gather_blocks_launch": [_VP, _VP, _VP, _LL, _LL, _VP],
    "paged_decode_attention_launch": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    "paged_decode_attention_workspace_floats": [_I, _I, _I, _I, _I, _I],
    "flash_prefill_launch": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _VP, _VP, _VP],
    "flash_prefill_scale_check": [_VP, _VP, _LL, _I, _VP],
}
_RESTYPES = {"paged_decode_attention_workspace_floats": _LL}     # the rest return int


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build_library(verbose: bool = False) -> pathlib.Path:
    """Compile every source in parallel and link one shared library.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel); its output lands in ``BUILD_INFO["log"]``. Returns the path.
    """
    srcs = sources()
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflowkv_kernels_{digest}.so"
    BUILD_INFO.update(sources=[str(s.relative_to(CSRC.parents[1])) for s in srcs])
    if lib.exists() and not verbose:
        BUILD_INFO.update(seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{digest}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      log="".join(logs) + link.stdout)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:                # every launch asks: no lock once loaded
        return _LIB
    with _LOCK:
        if _LIB is None:
            cdll = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _LIB = cdll
    return _LIB


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
