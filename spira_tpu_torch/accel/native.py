"""ctypes bindings for the native (C++) BVH builder and OBJ parser.

Counterpart of :mod:`spira_tpu.accel.native`, over the same framework-free
library (``native/libspira_native.so``, built from ``native/`` with
``make`` when it is missing).  The builder emits the exact flat layout of
:class:`spira_tpu_torch.accel.bvh.FlatBVH` with binned-SAH splits.  Where
the library is absent and cannot be built, the callers fall back to the
NumPy builder and the Python parser, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import subprocess
from pathlib import Path

import numpy as np
import torch

from .bvh import LEAF_SIZE, FlatBVH, add_links

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_NAME = "libspira_native.so"
_log = logging.getLogger(__name__)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=None)
def _load_library():
    """The loaded library (built with ``make`` if missing), or None."""
    path = _NATIVE_DIR / _LIB_NAME
    if not path.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:  # no toolchain
            _log.debug("native build failed (%s); using NumPy builder", e)
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _log.debug("native load failed (%s); using NumPy builder", e)
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
    if row_size and not hasattr(lib, "spira_build_bvh_rows"):
        raise RuntimeError(
            "native library is stale (no spira_build_bvh_rows); "
            "run `make -C native clean all`"
        )
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
        try:
            return build_bvh_native(lo, hi, leaf_size, row_size=row_size)
        except RuntimeError:
            if not row_size:
                raise
            return build_bvh_native(lo, hi, leaf_size)  # stale .so
    from .bvh import build_bvh

    return build_bvh(lo, hi, leaf_size)
