"""Build and load the port's CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt
at its next use and an unchanged one is loaded as it is.  Builds go into
``build/kernels/`` at the root of the checkout.  ``build_all`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: a library is built the first time a
wrapper launches its kernel (or when ``build_all`` is called).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")
SOURCES = ("decode_attention", "int4_matmul", "paged_decode_attention",
           "rmsnorm", "ssd_update", "dequantize")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas' per-kernel register / spill report (kept beside each library as
# <name>-<hash>.log) and build seconds, by source
build_log: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    every ``csrc/*.cuh`` header it may include, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for ``name`` unless its library is already built.  It
    writes a temporary file that ``_finish`` renames into place, so a
    half-written library is never loaded."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path],
            t0: float) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every named source in parallel (one nvcc each); returns the
    seconds each build took (0.0 for a library that was already built)."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is None:   # built earlier: its ptxas log lies beside it
                build_seconds.setdefault(n, 0.0)
                saved = _lib_path(n).with_suffix(".log")
                if n not in build_log and saved.exists():
                    build_log[n] = saved.read_text()
            else:
                _finish(n, job, t0)
    return {n: build_seconds[n] for n in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what the
    kernels' split plans fill."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def ticket_buffer(tickets: dict, device, size: int, what: str):
    """The tickets on ``device`` of a kernel whose last block by ticket
    adds the others' partials (``tickets`` is that kernel's own store, by
    device index): int32 (size,), allocated zeroed at the first call,
    which must not be under CUDA-graph capture, and kept; every launch
    leaves them at 0.  Calls on one device share them, so those calls run
    in one stream order (as the models' steps and their graphs do)."""
    import torch
    buf = tickets.get(device.index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: call it once before CUDA-graph capture "
                               "(its first call allocates the tickets)")
        buf = tickets[device.index] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
