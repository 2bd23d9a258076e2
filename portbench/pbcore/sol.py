"""Speed-of-light prices of the path-tracing kernels on the card.

Frozen copy, at commit 86df806, of the prices of ``spira_tpu_torch/
utils/sol.py`` (``OPS``, ``path_units``, ``lower_bound_seconds``): the
work of a kernel counted in units (a path segment, a hit, a camera sample,
a sphere test, ...), each unit's float32 ALU instructions and special
function calls counted by hand from the CUDA sources, the ALU term priced
at the card's issue rate (128 lanes a clock an SM at its maximum SM
clock, read in the run) and the special functions at the weights kernel
#9 measured (``WEIGHTS``).  The bound is the largest of the ALU term, the
special-function term and the bytes over the memory rate, so it is a
lower bound on the kernel's time.  The units are counted by the
benchmark's own reference, never by the program.
"""

from __future__ import annotations

CLASSES = ("alu", "sqrt", "div", "exp", "log", "sin", "cos")
SPECIAL = CLASSES[1:]
LANES_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12
#: each special function's cost in ALU-instruction equivalents, measured
#: by kernel #9 (``chip_smoke.py`` phase 1b) on an NVIDIA H100 80GB HBM3
#: at a 700.00 W power limit, at commit 86df806
WEIGHTS = {"sqrt": 9.143, "div": 9.18, "exp": 8.271, "log": 21.882,
           "sin": 22.33, "cos": 23.528}

OPS = dict(
    sphere_test=dict(alu=18),
    tri_test=dict(alu=50, div=1),
    hit=dict(alu=107, sqrt=4, div=2, sin=1, cos=1),
    miss=dict(alu=10),
    sample=dict(alu=26, sqrt=1, div=3),
    adjoint_hit=dict(alu=198, sqrt=6, div=4, sin=1, cos=1),
)


def issue_rate_per_s(sms: int, clock_hz: float) -> float:
    return LANES_PER_SM_CLOCK * sms * clock_hz


def ops_of(units: dict) -> dict:
    out = dict.fromkeys(CLASSES, 0)
    for unit, n in units.items():
        for op, k in OPS[unit].items():
            out[op] += k * n
    return out


def path_units(segments, hits, samples, n_spheres, n_tris=0) -> dict:
    """Units of a path tracer's run without its tree walk: ``segments``
    live path segments, ``hits`` of them hitting, over ``samples`` camera
    samples; each segment tests ``n_spheres`` spheres and ``n_tris``
    triangles by brute force."""
    return dict(sphere_test=segments * n_spheres, tri_test=segments * n_tris,
                hit=hits, miss=segments - hits, sample=samples)


def lower_bound_seconds(units: dict, nbytes: float, alu_per_s: float,
                        weights=None) -> dict:
    """The least time for ``units`` and ``nbytes``: ``bound_s``, the
    largest term, and its name ``bound_by``."""
    weights = WEIGHTS if weights is None else weights
    work = ops_of(units)
    special = sum(work[op] * weights[op] for op in SPECIAL)
    terms = dict(alu=work["alu"] / alu_per_s, special=special / alu_per_s,
                 bytes=nbytes / HBM_BYTES_PER_S)
    bound_by = max(terms, key=terms.get)
    return dict(bound_s=terms[bound_by], bound_by=bound_by, terms=terms)
