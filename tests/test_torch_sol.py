"""The Hopper speed-of-light model (``spira_tpu_torch.utils.sol``) and the
weights the peak probe hands it, on hand-computed inputs."""

import math

import pytest

from spira_tpu_torch.bench import vpu_peak as vp
from spira_tpu_torch.utils import sol

RATES = sol.Rates(alu_per_s=1e12,
                  weights=dict(sqrt=4.0, div=2.0, exp=8.0, log=10.0,
                               sin=20.0, cos=20.0),
                  hbm_bytes_per_s=1e11, source="test")


def test_bound_is_the_largest_term():
    """3e9 ALU ops at 1e12/s = 3 ms; 1e9 sqrt of weight 4 = 4e9 ALU
    equivalents = 4 ms; 2e8 bytes at 1e11 B/s = 2 ms: the bound is the
    special-function term's 4 ms, not the 9 ms sum."""
    b = sol.lower_bound_seconds(dict(alu=3e9, sqrt=1e9, bytes=2e8), RATES)
    assert b["bound_by"] == "special"
    assert b["bound_s"] == pytest.approx(4e-3)
    assert b["terms"] == pytest.approx(dict(alu=3e-3, special=4e-3,
                                            bytes=2e-3))


def test_special_functions_share_one_term():
    """The special functions run on one pipe: their calls times weights
    sum into one term (1e8 sqrt x 4 + 1e8 div x 2 + 1e8 sin x 20 = 2.6e9
    ALU equivalents = 2.6 ms), which bounds against 2 ms of ALU work,
    though no one function's share (at most 2 ms) would."""
    b = sol.lower_bound_seconds(dict(alu=2e9, sqrt=1e8, div=1e8, sin=1e8),
                                RATES)
    assert b["bound_by"] == "special"
    assert b["bound_s"] == pytest.approx(2.6e-3)
    assert b["terms"] == pytest.approx(dict(alu=2e-3, special=2.6e-3,
                                            bytes=0.0))
    assert sol.SPECIAL == ("sqrt", "div", "exp", "log", "sin", "cos")


def test_bound_by_bytes():
    b = sol.lower_bound_seconds(dict(alu=1e6, div=1e6, bytes=1e9), RATES)
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(1e-2)
    assert b["terms"]["special"] == pytest.approx(2e-6)


def test_issue_rate():
    """128 float32 lanes a clock an SM: 132 SMs at 1,980 MHz issue
    3.345e13 instructions a second, half the data sheet's 67 TFLOP/s
    (which counts an FMA as two operations)."""
    rate = sol.issue_rate_per_s(132, 1.98e9)
    assert rate == pytest.approx(128 * 132 * 1.98e9)
    assert 2 * rate == pytest.approx(sol.DATASHEET_F32_PER_S, rel=2e-3)


def test_ops_of_path_units():
    """Two segments, one hit, one sample, spheres 2, a walk of 3 pops and
    5 BW leaf triangles: each unit's classes, by hand."""
    work = dict(segments=2, hits=1, pops=3, leaf_tris=5)
    units = sol.path_units(work, samples=1, n_spheres=2, n_tris=0, bvh=True)
    assert units == dict(sphere_test=4, ray=2, pop=3, leaf_tri=5, block=0,
                         lane=0, hit=1, miss=1, sample=1)
    ops = sol.ops_of(units)
    assert ops["alu"] == 4 * 18 + 3 * 55 + 5 * 39 + 107 + 10 + 26
    assert ops["div"] == 2 * 3 + 5 * 1 + 2 + 3
    assert ops["sqrt"] == 4 + 1
    assert (ops["sin"], ops["cos"], ops["exp"], ops["log"]) == (1, 1, 0, 0)
    brute = sol.path_units(dict(segments=3, hits=3), samples=2, n_spheres=1,
                           n_tris=4, spectral=True)
    assert brute["tri_test"] == 12 and brute["spectral_miss"] == 0
    assert sol.walk_units(dict(blocks=2), "mt") == dict(
        pop=0, leaf_tri_mt=0, block=2, lane=256)


def test_walk_units_count_real_lanes():
    """A stream that tests only a block's real lanes is priced at the
    lanes it tests, not 128 a block: 3 blocks, 200 real lanes."""
    units = sol.walk_units(dict(blocks=3, lanes=200))
    assert units == dict(pop=0, leaf_tri=0, block=3, lane=200)
    assert sol.ops_of(units)["alu"] == 3 * 9 + 200 * 50
    assert sol.ops_of(units)["div"] == 200


def test_walk_units_price_group_boxes():
    """A visit that tests lane groups' boxes before their lanes (#2b) is
    priced at the lanes it tests and 27 ALU instructions a box: 3 blocks,
    20 boxes, 90 lanes."""
    units = sol.walk_units(dict(blocks=3, lanes=90, groups=20))
    assert units == dict(pop=0, leaf_tri=0, block=3, lane=90, group=20)
    assert sol.ops_of(units)["alu"] == 3 * 9 + 90 * 50 + 20 * 27
    assert sol.ops_of(units)["div"] == 90


def test_every_unit_counts_known_classes():
    for unit, ops in sol.OPS.items():
        assert set(ops) <= set(sol.CLASSES), unit
        assert all(k > 0 for k in ops.values()), unit


def test_datasheet_bound_and_sol_pct():
    work = dict(alu=67e9, sqrt=67e9, bytes=0)
    assert sol.datasheet_bound_seconds(work) == pytest.approx(2e-3)
    assert sol.sol_pct(1e-3, 4e-3) == pytest.approx(25.0)
    assert math.isnan(sol.sol_pct(1.0, 0.0))


def test_probe_rates_to_sol_rates():
    """The ALU is priced at the issue rate given, not at the probe's; each
    special function's weight is the separate mode's instruction rate
    (3 lane-ops, 3 instructions a step) over its call rate, less the
    chain's own ALU work."""
    rates = dict(separate=3e12, contracted=3e12, sqrt=1e11, div=2e11,
                 exp=3e11, log=1e11, sin=5e10, cos=6e10)
    r = vp.sol_rates(rates, 4e12, "test")
    assert r.alu_per_s == pytest.approx(4e12)
    assert r.weights == pytest.approx(dict(sqrt=30.0, div=15.0, exp=10.0,
                                           log=29.0, sin=60.0, cos=50.0))
    assert set(r.weights) == set(sol.SPECIAL) == set(vp.SPECIAL)
    assert r.as_dict() == dict(alu_per_s=4e12, weights=r.weights,
                               hbm_bytes_per_s=sol.HBM_BYTES_PER_S,
                               source="test")
