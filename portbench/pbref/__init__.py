"""The benchmark's plain reference: PyTorch only, importing nothing of the
program, against which every run's outputs are judged.

The pieces a configuration or a traffic mix names live one to a file and
are found by that name (:func:`plugin`): a mesh generator in
``meshes/<name>.py``, a tone map in ``tonemaps/<name>.py``, a forward
estimator in ``estimators/<name>.py`` and a gradient estimator in
``gradients/<name>.py``.  A new one is a new file."""

import importlib.util
import re
from pathlib import Path

_HERE = Path(__file__).resolve().parent


def plugin(group: str, name: str):
    """The module ``pbref/<group>/<name>.py``, loaded once."""
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", str(name)):
        raise ValueError(f"not a name: {name!r}")
    path = _HERE / group / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {group[:-1]} {name!r} (no file "
                       f"pbref/{group}/{name}.py)")
    key = f"pbref.{group}." + re.sub(r"[^A-Za-z0-9_]", "_", name)
    cached = _LOADED.get(key)
    if cached is None:
        spec = importlib.util.spec_from_file_location(key, path)
        cached = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cached)
        _LOADED[key] = cached
    return cached


_LOADED = {}
