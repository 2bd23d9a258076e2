"""Sample-granular checkpoint/resume.

Counterpart of :mod:`spira_tpu.utils.checkpoint`, in the same on-disk
layout: ``arrays.npz`` and a JSON ``manifest.json`` whose ``kind`` is
``render``, ``adaptive`` or ``train``, each written to a temporary file
and moved into place.  The RNG is counter-based, so (accumulator,
samples_done, seed, config) is a complete resume point, and a partial
render that the JAX package saved resumes here (same config JSON, same
threefry streams).

Inverse-rendering checkpoints hold the parameter dict and the optimizer's
``state_dict()`` (tensors as NumPy, the rest in the manifest); they are
the port's own and need not read the JAX package's optax files.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


class AsyncSaver:
    """One-deep asynchronous checkpoint writer.

    ``submit(fn, ...)`` joins the previous write, then runs ``fn`` on a
    fresh thread, so the write of chunk k overlaps chunk k+1's render.
    Writers go through a temporary file and ``os.replace``, so a kill
    mid-write leaves the previous complete checkpoint.  An exception in
    ``fn`` is raised at the next ``submit`` or ``wait``; call ``wait()``
    before reading checkpoint files back or exiting.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def submit(self, fn, *args, **kwargs) -> None:
        self.wait()

        def run():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced at the next submit/wait
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def host_snapshot(t: torch.Tensor):
    """A copy of ``t`` for the host, taken now on the calling thread, in
    stream order behind the work already queued: returns a function that
    waits for the copy and gives it as NumPy.  On the card the copy goes
    into pinned memory without blocking the host, and the function waits
    on an event, so a writer thread can call it while the next chunk
    runs; later writes to ``t`` do not reach the snapshot."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def get():
            copied.synchronize()
            return host.numpy()

        return get
    host = t.detach().clone().numpy()
    return lambda: host


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write(directory: str, arrays: dict, manifest: dict,
           compressed: bool) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, ARRAYS + ".tmp.npz")
    (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
    os.replace(tmp, os.path.join(directory, ARRAYS))
    tmp = os.path.join(directory, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(directory, MANIFEST))


def _read(directory: str, kind: str):
    """(manifest, arrays) of a checkpoint of ``kind``, or None."""
    mpath = os.path.join(directory, MANIFEST)
    apath = os.path.join(directory, ARRAYS)
    if not (os.path.exists(mpath) and os.path.exists(apath)):
        return None
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("kind") != kind:
        return None
    return manifest, np.load(apath)


def save_render_state(
    directory: str,
    *,
    accumulator,
    samples_done: int,
    seed: int,
    config_json: str,
) -> None:
    """Persist a partial render (uncompressed: the accumulator is
    Monte-Carlo noise, which zlib cannot shrink).  ``accumulator`` is an
    array or a tensor, or a function that gives one (a
    :func:`host_snapshot`)."""
    if callable(accumulator):
        accumulator = accumulator()
    _write(directory, {"accumulator": _numpy(accumulator)}, {
        "kind": "render",
        "samples_done": int(samples_done),
        "seed": int(seed),
        "config": config_json,
    }, compressed=False)


def load_render_state(directory: str):
    """Returns (accumulator, samples_done, seed, config_json) or None."""
    found = _read(directory, "render")
    if found is None:
        return None
    manifest, arrays = found
    return (
        arrays["accumulator"],
        manifest["samples_done"],
        manifest["seed"],
        manifest["config"],
    )


def save_adaptive_state(directory: str, *, arrays: dict, scalars: dict,
                        config_json: str) -> None:
    """Persist an adaptive render's round: the whole convergence ledger
    (acc/lum/lum2/counts/active) and the loop's scalars.  Keys derive from
    the monotone ``sample_base`` counter, so the resume is exact."""
    _write(directory, {k: _numpy(v) for k, v in arrays.items()},
           {"kind": "adaptive", "scalars": scalars, "config": config_json},
           compressed=True)


def load_adaptive_state(directory: str):
    """Returns (arrays dict, scalars dict, config_json) or None."""
    found = _read(directory, "adaptive")
    if found is None:
        return None
    manifest, arrays = found
    return dict(arrays), manifest["scalars"], manifest["config"]


def _state_dict(opt_state):
    return (opt_state.state_dict() if hasattr(opt_state, "state_dict")
            else opt_state)


def save_train_state(
    directory: str, *, params, opt_state, step: int, extra: dict | None = None
) -> None:
    """Persist an inverse-rendering loop: the parameter dict, the
    optimizer's state (a ``torch.optim.Optimizer`` or its
    ``state_dict()``) and the step.  The optimizer's tensors go into the
    arrays, its other values and its ``param_groups`` into the manifest."""
    payload = {f"params:{k}": _numpy(v) for k, v in params.items()}
    sd = _state_dict(opt_state)
    scalars = {}
    for idx, state in sd["state"].items():
        for k, v in state.items():
            if torch.is_tensor(v):
                payload[f"opt:{idx}/{k}"] = _numpy(v)
            else:
                scalars[f"{idx}/{k}"] = v
    _write(directory, payload, {
        "kind": "train",
        "step": int(step),
        "extra": extra or {},
        "opt_scalars": scalars,
        "param_groups": sd["param_groups"],
    }, compressed=True)


def load_train_state(directory: str, params_like, opt_state_like):
    """Restore (params, opt_state, step) into ``params_like`` (a dict of
    tensors, written in place, so an optimizer that holds them keeps
    them) and ``opt_state_like`` (an optimizer, whose ``load_state_dict``
    is called; anything else gets the state dict itself back).

    Returns None if no checkpoint exists.
    """
    found = _read(directory, "train")
    if found is None:
        return None
    manifest, arrays = found
    with torch.no_grad():
        for name, p in params_like.items():
            p.copy_(torch.from_numpy(arrays[f"params:{name}"]))
    state: dict = {}
    for key in arrays.files:
        if key.startswith("opt:"):
            idx, field = key[4:].split("/", 1)
            state.setdefault(int(idx), {})[field] = torch.from_numpy(
                arrays[key])
    for key, v in manifest["opt_scalars"].items():
        idx, field = key.split("/", 1)
        state.setdefault(int(idx), {})[field] = v
    groups = manifest["param_groups"]
    for g in groups:
        if "betas" in g:
            g["betas"] = tuple(g["betas"])
    sd = {"state": state, "param_groups": groups}
    if hasattr(opt_state_like, "load_state_dict"):
        opt_state_like.load_state_dict(sd)
        return params_like, opt_state_like, manifest["step"]
    return params_like, sd, manifest["step"]
