"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``_build/<name>-<hash>.so``, where the hash covers every source
under ``csrc/`` and the flags, so an edited source or flag rebuilds and an
unchanged one loads the cached library.  Nothing here runs at import: the
package imports on machines without ``nvcc`` or a card, where only the
plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction and no fast-math: the kernel keeps the plain
    # version's rounding (precise sqrtf/logf/sinf/cosf, IEEE division)
    "-fmad=false",
    # ptxas reports each kernel's registers, stack frame and spills
    "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the cached library was loaded
    log: str = ""  # nvcc's output (ptxas -v) when built here


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels build on a machine with the CUDA toolkit"
    )


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(name.encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{_source_hash(name)}.so"
    seconds = 0.0
    log = ""
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: never load a half-written library
        log = proc.stdout + proc.stderr
    return Library(lib=ctypes.CDLL(str(out)), path=out, build_seconds=seconds,
                   log=log)


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, built on first
    use, with its argument types; every entry point returns an int (a
    launch entry 0 on success, else a CUDA error code)."""
    fn = getattr(load(name).lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
