"""ctypes bindings for the native (C++) BVH builders and OBJ parser.

Counterpart of :mod:`spira_tpu.accel.native`, over the same framework-free
sources (``native/bvh_builder.cpp``, ``native/obj_loader.cpp``).  The
package builds its own copy of the library with ``native/Makefile`` (its
compiler and flags) into the git-ignored ``spira_tpu_torch/_build/``, keyed
by a hash of the sources, the Makefile and the ``CXX``/``CXXFLAGS`` the
build sees, so it never loads ``native/libspira_native.so``, which another
process may be writing in place.  The build runs under an exclusive lock
on ``_build/native.lock``: the library and a SHA-256 stamp of its bytes
are written to temporary names and moved into place with ``os.replace``,
and a library whose bytes do not match its stamp (a partly written or
truncated file) is rebuilt before it is loaded.  Where no toolchain can
build it, the callers fall back to the NumPy builder and the Python parser,
as the JAX package does, with a note in the log at INFO.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .bvh import LEAF_SIZE, FlatBVH, add_links

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB_NAME = "libspira_native.so"
_SOURCES = ("Makefile", "bvh_builder.cpp", "obj_loader.cpp")
_log = logging.getLogger(__name__)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _source_hash() -> str:
    """Hash of what the library is built from: the sources, the Makefile
    (its compiler line) and the environment's ``CXX``/``CXXFLAGS``, which
    the Makefile's ``?=`` lets override its own."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_NATIVE_DIR / name).read_bytes())
    for var in ("CXX", "CXXFLAGS"):
        h.update(f"{var}={os.environ.get(var, '')}".encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where this package's copy of the library lives (built or not)."""
    return _BUILD_DIR / f"native-{_source_hash()}" / _LIB_NAME


def _stamp(path: Path) -> Path:
    return path.with_name(path.name + ".sha256")


def _whole(path: Path) -> bool:
    """The library exists and its bytes are the ones its stamp names."""
    try:
        want = _stamp(path).read_text().strip()
        got = hashlib.sha256(path.read_bytes()).hexdigest()
    except OSError:
        return False
    return got == want


def _build(path: Path) -> None:
    """``make`` on a private copy of ``native/``, then the library and its
    stamp moved into place (the caller holds the lock)."""
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR,
                                     prefix="native-build-") as tmp:
        for name in _SOURCES:
            shutil.copy2(_NATIVE_DIR / name, tmp)
        subprocess.run(["make", "-C", tmp], check=True, capture_output=True,
                       text=True, timeout=300)
        built = Path(tmp) / _LIB_NAME
        digest = hashlib.sha256(built.read_bytes()).hexdigest()
        path.parent.mkdir(parents=True, exist_ok=True)
        os.replace(built, path)
        stamp = Path(tmp) / "stamp"
        stamp.write_text(digest + "\n")
        os.replace(stamp, _stamp(path))


def ensure_library() -> Path:
    """This package's copy of the library, built under the lock if it is
    missing or not whole; raises ``OSError`` or
    ``subprocess.SubprocessError`` when it cannot be built."""
    path = library_path()
    if _whole(path):
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "native.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not _whole(path):  # another process may have built it
            _build(path)
    return path


@functools.lru_cache(maxsize=None)
def _load_library():
    """The loaded library (built on first use), or None where no toolchain
    can build it."""
    try:
        path = ensure_library()
    except (OSError, subprocess.SubprocessError) as e:  # no toolchain
        detail = getattr(e, "stderr", "") or e
        _log.info("native build failed (%s); using the NumPy builder",
                  detail)
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _log.info("native load failed (%s); using the NumPy builder", e)
        return None
    outs = [_F32P, _F32P, _I32P, _I32P, _I32P, _I32P]
    fn = lib.spira_build_bvh
    fn.restype = ctypes.c_int32
    fn.argtypes = [_F32P, _F32P, ctypes.c_int32, ctypes.c_int32] + outs
    if hasattr(lib, "spira_parse_obj"):
        pf = lib.spira_parse_obj
        pf.restype = ctypes.c_int32
        pf.argtypes = [
            ctypes.c_char_p,  # text
            ctypes.c_long,  # length
            ctypes.POINTER(_F32P),  # out_verts
            ctypes.POINTER(ctypes.c_long),  # out_nverts
            ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),  # out_faces
            ctypes.POINTER(ctypes.c_long),  # out_nfaces
        ]
        lib.spira_free.restype = None
        lib.spira_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "spira_build_bvh_rows"):
        rf = lib.spira_build_bvh_rows
        rf.restype = ctypes.c_int32
        rf.argtypes = [_F32P, _F32P, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32] + outs  # ... leaf_size, row, outs
    if hasattr(lib, "spira_build_sbvh"):
        sf = lib.spira_build_sbvh
        sf.restype = ctypes.c_int32
        sf.argtypes = [
            _F32P, _F32P,  # lo, hi
            _F32P, _F32P, _F32P,  # va, vb, vc (null: box clipping)
            ctypes.c_int32,  # n
            ctypes.c_int32,  # leaf_size
            ctypes.c_float,  # alpha
            ctypes.c_int32,  # max_refs
        ] + outs + [_I32P]  # ..., out_n_refs
    return lib


def parse_obj_native(text: str):
    """Parse OBJ text with the C++ parser; returns (verts (V,3) f32,
    faces (T,3) i64, 0-based, fan-triangulated) or None when the library
    (or the symbol) is unavailable or the text holds no triangles."""
    lib = _load_library()
    if lib is None or not hasattr(lib, "spira_parse_obj"):
        return None
    raw = text.encode("utf-8", errors="replace")
    vp = _F32P()
    fp = ctypes.POINTER(ctypes.c_longlong)()
    nv = ctypes.c_long(0)
    nf = ctypes.c_long(0)
    rc = lib.spira_parse_obj(raw, len(raw), ctypes.byref(vp),
                             ctypes.byref(nv), ctypes.byref(fp),
                             ctypes.byref(nf))
    if rc != 0:
        return None
    try:
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy()
    finally:
        lib.spira_free(vp)
        lib.spira_free(fp)
    return verts.astype(np.float32), faces.astype(np.int64)


def native_available() -> bool:
    return _load_library() is not None


def build_bvh_native(lo: np.ndarray, hi: np.ndarray,
                     leaf_size: int = LEAF_SIZE, row_size: int = 0) -> FlatBVH:
    """Binned-SAH build via the C++ library; raises if it is unavailable.

    ``row_size`` > 0 prices SAH costs in leaf rows (ceil(count/row_size))
    instead of primitives, with an exact 3-axis sweep for small nodes."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    cap = max(2 * n - 1, 1)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.int32)
    prim_idx = np.empty(n, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    outs = (ptr(node_min, ctypes.c_float), ptr(node_max, ctypes.c_float),
            ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
            ptr(is_leaf, ctypes.c_int32), ptr(prim_idx, ctypes.c_int32))
    ins = (ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float), n, leaf_size)
    if row_size:
        m = lib.spira_build_bvh_rows(*ins, row_size, *outs)
    else:
        m = lib.spira_build_bvh(*ins, *outs)
    if m < 0:
        raise RuntimeError("native BVH build failed")
    max_leaf = int(right[:m][is_leaf[:m] == 1].max())
    t = torch.from_numpy
    return add_links(FlatBVH(
        node_min=t(node_min[:m].copy()), node_max=t(node_max[:m].copy()),
        left=t(left[:m].copy()), right=t(right[:m].copy()),
        is_leaf=t(is_leaf[:m].copy()), prim_idx=t(prim_idx),
        max_leaf=max_leaf,
    ))


def build_bvh_best(lo, hi, leaf_size: int = LEAF_SIZE,
                   row_size: int = 0) -> FlatBVH:
    """Native SAH builder when available, NumPy median split otherwise.
    ``row_size`` needs the native builder; the NumPy fallback ignores it
    (tree quality, not correctness)."""
    if native_available():
        return build_bvh_native(lo, hi, leaf_size, row_size=row_size)
    from .bvh import build_bvh

    return build_bvh(lo, hi, leaf_size)


def build_sbvh_native(lo: np.ndarray, hi: np.ndarray,
                      v0: np.ndarray | None = None,
                      v1: np.ndarray | None = None,
                      v2: np.ndarray | None = None,
                      leaf_size: int = LEAF_SIZE, alpha: float = 1e-5,
                      max_ref_factor: float = 1.8) -> FlatBVH:
    """SBVH build (binned SAH plus spatial splits, Stich et al. HPG 2009)
    via the C++ library; raises ``RuntimeError`` if it is unavailable.

    A spatial split puts a straddling reference into both children with a
    clipped box (true polygon clipping when the vertices ``v0``/``v1``/
    ``v2`` are given, else the box clamped), so ``prim_idx`` may be longer
    than the primitive count and repeat entries.  ``alpha`` is the overlap
    threshold relative to the root's area; ``max_ref_factor`` caps the
    references at that multiple of the primitives."""
    lib = _load_library()
    if lib is None or not hasattr(lib, "spira_build_sbvh"):
        raise RuntimeError("native SBVH builder unavailable")
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    max_refs = max(int(n * max_ref_factor) + 8, n + 8)
    cap = 2 * max_refs - 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    is_leaf = np.empty(cap, np.int32)
    prim_idx = np.empty(max_refs, np.int32)
    n_refs = ctypes.c_int32(0)
    # contiguous vertex copies, held alive across the call
    verts = [None if a is None else np.ascontiguousarray(a, np.float32)
             for a in (v0, v1, v2)]

    def ptr(a, t=ctypes.c_float):
        if a is None:
            return _F32P()
        return a.ctypes.data_as(ctypes.POINTER(t))

    m = lib.spira_build_sbvh(
        ptr(lo), ptr(hi), *(ptr(v) for v in verts), n, leaf_size,
        ctypes.c_float(alpha), max_refs, ptr(node_min), ptr(node_max),
        ptr(left, ctypes.c_int32), ptr(right, ctypes.c_int32),
        ptr(is_leaf, ctypes.c_int32), ptr(prim_idx, ctypes.c_int32),
        ctypes.byref(n_refs))
    if m < 0:
        raise RuntimeError("native SBVH build failed")
    max_leaf = int(right[:m][is_leaf[:m] == 1].max())
    t = torch.from_numpy
    return add_links(FlatBVH(
        node_min=t(node_min[:m].copy()), node_max=t(node_max[:m].copy()),
        left=t(left[:m].copy()), right=t(right[:m].copy()),
        is_leaf=t(is_leaf[:m].copy()),
        prim_idx=t(prim_idx[:n_refs.value].copy()), max_leaf=max_leaf,
    ))
