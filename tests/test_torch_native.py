"""The port's copy of the native library: built whole under a lock into
its own build directory, never loaded half written, and shared with JAX's
loader in the tests that compare native builds (``tests/_torch_native.py``).
"""

import hashlib
import logging
import os
import shutil
import subprocess
import sys

import numpy as np

from spira_tpu.accel import native as jnative
from spira_tpu.accel.bvh import build_two_level as j_build_two_level
from spira_tpu.scene import obj as jobj
from spira_tpu_torch.accel import native as tnative
from spira_tpu_torch.accel.bvh import build_two_level as t_build_two_level
from spira_tpu_torch.scene import obj as tobj

from ._torch_native import share_native_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BVH_FIELDS = ("node_min", "node_max", "left", "right", "is_leaf", "prim_idx",
              "parent", "sibling", "is_left")
#: processes that load the library at once from an empty build directory
N_LOADERS = 4


def _two_spheres(ico, build_two_level):
    """The two-icosphere scene of tests/test_torch_mxu.py."""
    return build_two_level([
        ico(center=(-0.6, 0.1, 0.0), radius=0.55, subdivisions=2,
            material=0),
        ico(center=(0.8, -0.2, 0.3), radius=0.45, subdivisions=1,
            material=1)])


def _assert_trees_equal(got, want):
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.max_leaf == want.max_leaf


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_lost_race_still_shares_the_native_tree(monkeypatch):
    """JAX's loader as a lost build race leaves it (tried once, no
    library): the fixture's repointing still gives both sides the native
    SAH tree, equal field for field, and not the NumPy median split."""
    monkeypatch.setattr(jnative, "_lib_tried", True)
    monkeypatch.setattr(jnative, "_lib", None)
    assert not jnative.native_available()
    assert share_native_library(monkeypatch)
    assert jnative.native_available()
    assert jnative._load_library()._name == str(tnative.library_path())
    (jb, _), (tb, _) = (_two_spheres(jobj.icosphere, j_build_two_level),
                        _two_spheres(tobj.icosphere, t_build_two_level))
    _assert_trees_equal(tb, jb)
    (mb, _) = _two_spheres(tobj.icosphere, lambda parts: t_build_two_level(
        parts, use_native=False))
    assert not np.array_equal(tb.prim_idx.numpy(), mb.prim_idx.numpy())


def test_truncated_library_is_rebuilt(monkeypatch, tmp_path):
    """A library cut short under its stamp (a build that died while
    writing) is rebuilt under the lock before it is loaded: the loader
    returns a whole library, whose trees equal the shared one's."""
    whole = tnative.ensure_library()
    build = tmp_path / "_build"
    shutil.copytree(whole.parent, build / whole.parent.name)
    cut = build / whole.parent.name / whole.name
    data = cut.read_bytes()
    cut.write_bytes(data[: len(data) // 2])
    monkeypatch.setattr(tnative, "_BUILD_DIR", build)
    tnative._load_library.cache_clear()
    try:
        lib = tnative._load_library()
        assert lib is not None and lib._name == str(cut)
        assert cut.read_bytes() == data
        tree, _ = _two_spheres(tobj.icosphere, t_build_two_level)
    finally:
        tnative._load_library.cache_clear()
    want, _ = _two_spheres(tobj.icosphere, t_build_two_level)
    _assert_trees_equal(tree, want)


LOADER = """
import hashlib, sys
from pathlib import Path
from spira_tpu_torch.accel import native
native._BUILD_DIR = Path(sys.argv[1])
lib = native._load_library()
tree = native.build_bvh_native(*[__import__("numpy").arange(
    24, dtype="float32").reshape(8, 3) + k for k in (0, 1)])
print(lib._name, hashlib.sha256(open(lib._name, "rb").read()).hexdigest(),
      hashlib.sha256(tree.prim_idx.numpy().tobytes()).hexdigest())
"""


def test_concurrent_first_loads_share_one_build(tmp_path):
    """Processes started together on an empty build directory each load
    the library and build with it; every one reads the same bytes, those
    the stamp names, and one build leaves no temporary behind."""
    build = tmp_path / "_build"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(build)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_LOADERS)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert len({tuple(o) for o in outs}) == 1, outs
    path, digest, _ = outs[0]
    assert digest == _digest(path)
    assert open(path + ".sha256").read().strip() == digest
    assert sorted(p.name for p in build.iterdir()) == sorted([
        "native.lock", os.path.basename(os.path.dirname(path))])


def test_unbuildable_library_falls_back_with_a_note(monkeypatch, tmp_path,
                                                    caplog):
    """Where the library cannot be built, the loader says so at INFO and
    the builders take the NumPy median split."""
    monkeypatch.setattr(tnative, "_NATIVE_DIR", tmp_path / "missing")
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "_build")
    tnative._load_library.cache_clear()
    try:
        with caplog.at_level(logging.INFO, logger=tnative.__name__):
            assert not tnative.native_available()
        assert any(r.levelno == logging.INFO and "NumPy builder" in r.message
                   for r in caplog.records)
        got, _ = t_build_two_level([tobj.icosphere(subdivisions=1)])
    finally:
        tnative._load_library.cache_clear()
    want, _ = t_build_two_level([tobj.icosphere(subdivisions=1)],
                                use_native=False)
    _assert_trees_equal(got, want)
