"""Speed-of-light model of the port's kernels on the card: the least time
the card could take for the work a kernel did, priced at the card's issue
rate and at special-function costs measured on the card itself.

Counterpart of ``spira_tpu/utils/sol.py``, written for Hopper: none of
its TPU constants (the vector unit's lane rate, the packet tile, the
K-pop batch, the any-hit reduce) describe this card.  The work is counted
per unit (a path segment, a BVH pop, a leaf triangle, a hit, a camera
sample, ...; :data:`OPS`) and split by class:

* ``alu``: float32 adds, multiplies, min/max, compares, selects and
  conversions, each one instruction, as every path kernel is built
  (``-fmad=false``: nothing is contracted);
* ``sqrt``, ``div`` (``1/x`` and ``x/y``, IEEE), ``exp``, ``log``,
  ``sin``, ``cos`` (:data:`SPECIAL`): one call each, compiled without
  fast-math into a multi-instruction sequence around the SFU.

:func:`lower_bound_seconds` prices the ALU instructions at the card's
issue rate (:func:`issue_rate_per_s`: 128 float32 lanes a clock an SM at
the maximum SM clock) and the special functions as one term: each call
times its weight in ALU-instruction equivalents, measured by kernel #9
(:mod:`spira_tpu_torch.bench.vpu_peak`), summed over the functions and
over the same issue rate.  The bound is the largest of the ALU term, the
special-function term and the bytes over the memory rate: a maximum, not
a sum, so it stays a lower bound however the sequences share the
schedulers with the ALU work.

The per-unit counts are taken by hand from the CUDA sources and count only
what every path through the code runs (a sphere test's square root runs
only where the ray meets the sphere, so it is not counted; a hit counts the
cheaper of its two scatter lobes), so the bound is a lower bound.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: operation classes, in the order reports list them
CLASSES = ("alu", "sqrt", "div", "exp", "log", "sin", "cos")
#: the special functions, priced together by their weights
SPECIAL = CLASSES[1:]
#: float32 lanes an SM issues a clock on compute capability 9.0 (CUDA C++
#: programming guide, arithmetic instruction throughput): add, multiply
#: and FMA alike
LANES_PER_SM_CLOCK = 128
#: device-memory rate (NVIDIA H100 SXM data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: the data sheet's float32 rate outside the tensor cores (an FMA counted
#: as two operations, at a 700 W limit): the yardstick chip_smoke.py used
#: before the special functions were priced, printed beside the bound
DATASHEET_F32_PER_S = 67e12
#: lanes of a superleaf block (accel/mxu.py)
SUPERLEAF = 128


def issue_rate_per_s(sms: int, clock_hz: float) -> float:
    """float32 ALU instructions a second the card can issue: 128 lanes a
    clock on each of ``sms`` SMs at ``clock_hz``."""
    return LANES_PER_SM_CLOCK * sms * clock_hz


@dataclass(frozen=True)
class Rates:
    """What the bound prices work at.  ``alu_per_s``: float32 ALU
    instructions per second (:func:`issue_rate_per_s`); ``weights``: each
    special function's cost in ALU-instruction equivalents, measured on
    the card by kernel #9; ``source``: the card, power limit and run they
    come from."""

    alu_per_s: float
    weights: dict = field(default_factory=dict)
    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    source: str = ""

    def as_dict(self) -> dict:
        return dict(alu_per_s=self.alu_per_s, weights=dict(self.weights),
                    hbm_bytes_per_s=self.hbm_bytes_per_s, source=self.source)


#: Operations per unit of work, by class, counted by hand from the CUDA
#: sources.
#:   sphere_test  one sphere against one segment (trace.cuh:nearest_sphere,
#:                up to the discriminant test; its sqrtf only on a hit)
#:   tri_test     one brute-force triangle (nearest_tri, the determinant
#:                test passing): 50 ALU and 1/det
#:   pop          one pair record's two slab tests (bvh.cuh:slab_child)
#:   leaf_tri     one Baldwin-Weber leaf triangle (bvh.cuh:visit_leaf):
#:                39 ALU and 1/den; leaf_tri_mt the Moller-Trumbore form
#:   ray          one walk's reciprocal direction: 3 divisions
#:   hit          point, emission, throughput, offset and the diffuse
#:                lobe (the cheaper lobe): sqrtf x4 (two of them in
#:                norm3), 1/x x2 (norm3), sinf, cosf
#:   miss         the sky gradient
#:   sample       ray generation: two divisions by du, dv and norm3
#:   spectral_*   spectral.cuh: per hit 8 Chebyshev SPD evaluations of 12
#:                terms and the lobe; per sample 12 sky SPDs, 4 lane
#:                coordinates (a division each), ray generation, and the
#:                CIE lobes: 7 Gaussians of 4 wavelengths, each a division
#:                and an expf
#:   adjoint_hit  adjoint.cuh's reverse sweep of one replayed hit: the
#:                recomputed diffuse lobe, three norm3 adjoints, the
#:                intersection adjoint
#:   block, lane  a superleaf block visit (superleaf.cuh:visit_lanes): m =
#:                o x d, and per lane tested (lane_hit) det/u/v (18
#:                products, 15 sums), t, 1/det, 3 products, u + v, 6
#:                compares, |det|; the kernels test a block's real lanes
OPS = dict(
    sphere_test=dict(alu=18),
    tri_test=dict(alu=50, div=1),
    pop=dict(alu=55),
    leaf_tri=dict(alu=39, div=1),
    leaf_tri_mt=dict(alu=50, div=1),
    ray=dict(div=3),
    hit=dict(alu=107, sqrt=4, div=2, sin=1, cos=1),
    miss=dict(alu=10),
    sample=dict(alu=26, sqrt=1, div=3),
    spectral_hit=dict(alu=507, sqrt=4, div=2, sin=1, cos=1),
    spectral_miss=dict(alu=30),
    spectral_sample=dict(alu=642, sqrt=1, div=35, exp=28),
    adjoint_hit=dict(alu=198, sqrt=6, div=4, sin=1, cos=1),
    block=dict(alu=9),
    lane=dict(alu=50, div=1),
)


def ops_of(units: dict) -> dict:
    """Operations by class of ``units`` ({unit name: count})."""
    out = dict.fromkeys(CLASSES, 0)
    for unit, n in units.items():
        for op, k in OPS[unit].items():
            out[op] += k * n
    return out


def walk_units(work: dict, form: str = "bw") -> dict:
    """Units of a BVH walk's inventory (``pops``, ``leaf_tris``,
    ``blocks``: superleaf blocks visited; ``lanes``: the lanes those visits
    test, where a kernel tests only a block's real lanes, else all 128 of
    each block)."""
    leaf = "leaf_tri" if form == "bw" else "leaf_tri_mt"
    blocks = work.get("blocks", 0)
    return {"pop": work.get("pops", 0), leaf: work.get("leaf_tris", 0),
            "block": blocks, "lane": work.get("lanes", blocks * SUPERLEAF)}


def path_units(work: dict, samples: int, n_spheres: int, n_tris: int, *,
               spectral: bool = False, bvh: bool = False,
               form: str = "bw") -> dict:
    """Units of a path tracer's run: ``work`` holds its live path
    ``segments`` and their ``hits`` (and a walk's inventory), over
    ``samples`` camera samples; each segment tests ``n_spheres`` spheres
    and either walks a tree (``bvh``) or tests ``n_tris`` triangles."""
    segments, hits = work["segments"], work["hits"]
    units = dict(sphere_test=segments * n_spheres)
    if bvh:
        units["ray"] = segments
    else:
        units["tri_test"] = segments * n_tris
    units.update(walk_units(work, form))
    prefix = "spectral_" if spectral else ""
    units[prefix + "hit"] = hits
    units[prefix + "miss"] = segments - hits
    units[prefix + "sample"] = samples
    return units


def lower_bound_seconds(work: dict, rates: Rates) -> dict:
    """The least time the card could take for ``work``: operations by
    class (:data:`CLASSES`, missing ones 0) and ``bytes`` (each input read
    once, each output written once).

    Returns ``bound_s``, the largest term; ``bound_by``, its name; and
    ``terms`` in seconds: ``alu``, the ALU instructions over
    ``rates.alu_per_s``; ``special``, the special-function calls times
    their weights over the same rate; ``bytes``, over the memory rate."""
    special = sum(work.get(op, 0) * rates.weights[op] for op in SPECIAL
                  if work.get(op, 0))
    terms = dict(alu=work.get("alu", 0) / rates.alu_per_s,
                 special=special / rates.alu_per_s,
                 bytes=work.get("bytes", 0) / rates.hbm_bytes_per_s)
    bound_by = max(terms, key=terms.get)
    return dict(bound_s=terms[bound_by], bound_by=bound_by, terms=terms)


def datasheet_bound_seconds(work: dict) -> float:
    """The data-sheet bound, kept for the record: every operation (a
    special function counted one, an FMA's two halves two) over the data
    sheet's
    67 TFLOP/s, or the bytes over the memory rate, whichever is larger."""
    ops = sum(work.get(op, 0) for op in CLASSES)
    return max(ops / DATASHEET_F32_PER_S,
               work.get("bytes", 0) / HBM_BYTES_PER_S)


def sol_pct(bound_s: float, measured_s: float) -> float:
    """Share of the bound achieved, in percent (100 = at the bound)."""
    if measured_s <= 0:
        return float("nan")
    return 100.0 * bound_s / measured_s
