"""Build the port's CUDA kernels with nvcc into shared libraries.

Each source under ``kernels/*/csrc/`` has a plain C interface and is
compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), at first use.  A library is
named by the hash of its source and flags, so an edited source is rebuilt
and an unchanged one is loaded as built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LOADED: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or "
                           "CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        Path(source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: Path) -> dict:
    """Compile ``source`` unless it is built already.

    Returns ``library``, ``seconds`` (0.0 when it was already built) and
    ``log`` (nvcc's ``-Xptxas -v`` report of registers, shared memory and
    spills, kept beside the library so a built one still reports it).
    Raises if nvcc fails.
    """
    out = library_path(source)
    log = out.with_suffix(".log")
    if out.exists():
        return {"library": str(out), "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}")
    tmp_log = log.with_suffix(f".{os.getpid()}.log.tmp")
    tmp_log.write_text(proc.stdout)
    os.replace(tmp_log, log)
    os.replace(tmp, out)  # atomic: a reader never sees a partial file
    return {"library": str(out), "seconds": time.perf_counter() - t0,
            "log": proc.stdout}


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    out = library_path(source)
    lib = _LOADED.get(out)
    if lib is None:
        build(source)
        lib = _LOADED[out] = ctypes.CDLL(str(out))
    return lib
