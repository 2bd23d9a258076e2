"""One native library for both packages in a test that holds a native
build of the port against JAX's.

Each package builds the shared C++ builder on first use: JAX's loader
with ``make`` into ``native/libspira_native.so`` in place, the port's into
its own ``_build/`` under a lock.  Under several pytest workers JAX's
loader can find the file half written by another worker, fail to load it
and remember the failure for the rest of its process, so that its trees
come from the NumPy builder while the port's come from the native SAH
builder.  ``share_native_library`` makes the port's whole library, points
JAX's loader at that same file (a test may patch a module global; the JAX
package is not edited), clears both caches and asserts that both sides
see the library alike.  Test files that compare native builds import the
module-scoped autouse fixture ``same_native_library``::

    from ._torch_native import same_native_library  # noqa: F401
"""

import subprocess

import pytest

from spira_tpu.accel import native as jnative
from spira_tpu_torch.accel import native as tnative


def share_native_library(monkeypatch) -> bool:
    """Point JAX's loader at the port's library; returns whether the
    library is available (to both sides alike)."""
    tnative._load_library.cache_clear()
    try:
        path = tnative.ensure_library()
    except (OSError, subprocess.SubprocessError):  # no toolchain: both
        path = None  # sides fall back alike
    if path is not None:
        monkeypatch.setattr(jnative, "_NATIVE_DIR", str(path.parent))
    monkeypatch.setattr(jnative, "_lib_tried", path is None)
    monkeypatch.setattr(jnative, "_lib", None)
    available = tnative.native_available()
    assert jnative.native_available() == available
    assert (path is not None) == available
    return available


@pytest.fixture(scope="module", autouse=True)
def same_native_library():
    with pytest.MonkeyPatch.context() as mp:
        yield share_native_library(mp)
    tnative._load_library.cache_clear()
