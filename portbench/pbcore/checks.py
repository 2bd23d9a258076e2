"""The comparisons that decide ``correct``: the numbers the program's
outputs give against the reference's, each held to its limit (the mix's
``limits``).  A number at or under its limit passes."""

from __future__ import annotations

import statistics

import numpy as np
import torch

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's takes no part in the gradient and change gaps
NEGLIGIBLE = 1e-3


def frames(program: list, reference: list) -> dict:
    """``px_off``: the share of checked pixels, over every checked frame,
    whose uint8 value differs from the reference's by more than one level
    in any channel."""
    prog = np.concatenate([np.asarray(p, np.int16) for p in program])
    ref = np.concatenate([np.asarray(r, np.int16) for r in reference])
    off = np.abs(prog - ref).max(axis=-1) > 1
    return dict(px_off=float(off.mean()))


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _worst_gap(prog: dict, ref: dict, keep) -> float:
    """The largest gap over the kept leaves between the program's norm of
    a leaf and the reference's, over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    p, r = _norms(prog), _norms(ref)
    median = statistics.median(r.values())
    gaps = [abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keep]
    return max(gaps) if gaps else 0.0


def steps(program: dict, reference: dict) -> dict:
    """``loss_gap``: the largest relative gap of the first steps' losses;
    ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    ``change_gap``: the worst leaf's gap of the norm of the leaves'
    change over the first steps.  Leaves whose reference gradient is
    negligible (under :data:`NEGLIGIBLE` of the median leaf's) are left
    out of both gaps."""
    lp, lr = program["losses"], reference["losses"]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
    g_ref = _norms(reference["first_grads"])
    median = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= NEGLIGIBLE * median]
    change_p = {k: program["after"][k].double().cpu()
                - program["start"][k].double().cpu() for k in keep}
    change_r = {k: reference["after"][k].double().cpu()
                - reference["start"][k].double().cpu() for k in keep}
    first_p = {k: program["first_grads"][k].cpu() for k in g_ref}
    first_r = {k: reference["first_grads"][k].cpu() for k in g_ref}
    return dict(loss_gap=loss_gap,
                grad_gap=_worst_gap(first_p, first_r, keep),
                change_gap=_worst_gap(change_p, change_r, keep))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit, or a limit without a number,
    fails."""
    out, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        out[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, out
