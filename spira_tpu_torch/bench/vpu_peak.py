"""The card's peak float32 issue rate and the cost of its special
functions: the counterpart of ``benchmarks/vpu_peak.py`` (kernel #9), and
the source of the special-function weights
:mod:`spira_tpu_torch.utils.sol` prices a kernel's work with.

    python3 -m spira_tpu_torch.bench.vpu_peak [--out PATH]

Each element of the input starts ``CHAINS`` independent register chains
(``x + k``), steps each ``ITERS`` times and writes their sum.  The step
(``MODES``):

* ``separate``: ``min(x * 1.000001 + 1e-7, 1e30)`` as three instructions
  (FMUL, FADD, FMNMX), as every path kernel is built (``-fmad=false``);
  counted as ``benchmarks/vpu_peak.py:67-68`` counts it, 3 lane-ops;
* ``contracted``: the same with one rounding, ``fmaf(x, 1.000001, 1e-7)``
  then the min: 2 instructions, still 3 counted lane-ops;
* ``sqrt``, ``div``, ``exp``, ``log``, ``sin``, ``cos``: one ``sqrtf``,
  ``1.0f / x``, ``expf(-x)``, ``logf(x) + 2``, ``sinf`` or ``cosf`` as
  nvcc compiles it without fast-math.

On the card :func:`vpu_peak` launches ``csrc/peak.cu:spira_vpu_peak`` and
adds one to ``vpu_peak.launches``; on the CPU it runs :func:`peak_plain`,
the same chains on tensors.  :func:`time_modes` times every mode on
:func:`probe_input` at a grid that fills every SM several times over
(:func:`fill_elements`) and keeps each mode's output for the comparison
with the plain version; :func:`rates_from_ms` turns the times into
``{mode: rate}`` and :func:`sol_rates` those into the special-function
weights of :class:`~spira_tpu_torch.utils.sol.Rates`.  The JAX shape is
one (32, 128) tile, 4,096 elements: on the card it fills 16 of 132 SMs
and measures latency, so :func:`main` reports both.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from .. import _build
from ..utils import sol
from . import timing

CHAINS, ITERS = 8, 2000
#: one TPU tile (benchmarks/vpu_peak.py:27)
JAX_SHAPE = (32, 128)
MODES = ("separate", "contracted", "sqrt", "div", "exp", "log", "sin",
         "cos")
#: the special-function modes, in sol's class names
SPECIAL = MODES[2:]
#: lane-ops counted per chain-iteration of the two ALU modes, as JAX counts
LANE_OPS = 3
#: instructions per chain-iteration of the two ALU modes as nvcc builds
#: them (read in the SASS)
INSTRUCTIONS = {"separate": 3, "contracted": 2}
#: ALU instructions beside the special function in a chain step
EXTRA_ALU = {"log": 1}
#: resident threads an SM holds, and how many times the fill grid fills
#: every SM with them
THREADS_PER_SM, WAVES = 2048, 4
_C, _B = float(np.float32(1.000001)), float(np.float32(1e-7))


def _separate(xs):
    return (xs * 1.000001 + 1e-7).clamp(max=1e30)


def _contracted(xs):
    # x * c is exact in float64 (24-bit by 24-bit significands), so one
    # rounding of the float64 sum to float32 is fmaf's result but where the
    # float64 sum itself rounds onto a float32 tie (double rounding)
    return (xs.double() * _C + _B).float().clamp(max=1e30)


_STEPS = dict(
    separate=_separate,
    contracted=_contracted,
    sqrt=torch.sqrt,
    div=torch.reciprocal,
    exp=lambda xs: torch.exp(-xs),
    log=lambda xs: torch.log(xs) + 2.0,
    sin=torch.sin,
    cos=torch.cos,
)


def peak_plain(x, mode: str = "separate", iters: int = ITERS):
    """The plain version of kernel #9: ``CHAINS`` chains of ``mode`` from
    ``x + k``, ``iters`` steps, summed in chain order; float32, ``x``'s
    shape."""
    step = _STEPS[mode]
    xf = x.to(torch.float32)
    xs = torch.stack([xf + float(k) for k in range(CHAINS)])
    for _ in range(iters):
        xs = step(xs)
    acc = xs[0]
    for k in range(1, CHAINS):
        acc = acc + xs[k]
    return acc


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def vpu_peak(x, mode: str = "separate", iters: int = ITERS):
    """Kernel #9 on ``x`` (float32): the chains' sums, ``x``'s shape.

    A tensor on a CUDA device launches ``csrc/peak.cu:spira_vpu_peak``
    (built on first use) and adds one to ``vpu_peak.launches``; a tensor on
    the CPU runs :func:`peak_plain`.  Any other device, dtype or mode
    raises."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return peak_plain(x, mode, iters)
    if x.device.type != "cuda":
        raise ValueError(f"vpu_peak runs on cuda or cpu, not {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    fn = _build.entry("peak", "spira_vpu_peak", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(xc.data_ptr(), out.data_ptr(), xc.numel(), iters,
                 MODES.index(mode),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vpu_peak launch failed: CUDA error {err}")
    vpu_peak.launches += 1
    return out


#: Kernel launches since the count was last reset (set it to 0 to reset).
vpu_peak.launches = 0


def ops_per_launch(mode: str, n: int, iters: int = ITERS) -> int:
    """Counted operations of one launch over ``n`` elements: lane-ops for
    the ALU modes (3 a chain-iteration), calls for the special ones."""
    per = LANE_OPS if mode in INSTRUCTIONS else 1
    return per * CHAINS * iters * n


def fill_elements(device, waves: int = WAVES) -> int:
    """Elements of a grid that fills every SM ``waves`` times with
    resident threads (one element a thread)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * THREADS_PER_SM * waves


def probe_input(n: int, device, seed: int = 0):
    """``n`` float32 values uniform in [1, 2) from ``seed``: an input that
    varies by element (every chain stays finite and in the special
    functions' fast paths from it)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) + 1.0).to(device)


def time_modes(x, modes=MODES, iters: int = ITERS,
               repeats: int = timing.REPEATS):
    """``({mode: ms}, {mode: output})``: the median time of one launch on
    ``x`` by CUDA events, and the output of the last timed launch."""
    outs = {}

    def launch(mode):
        outs[mode] = vpu_peak(x, mode, iters)

    ms = {m: timing.cuda_ms(lambda m=m: launch(m), repeats) for m in modes}
    return ms, outs


def rates_from_ms(ms: dict, n: int, iters: int = ITERS) -> dict:
    """``{mode: counted operations per second}`` from :func:`time_modes`."""
    return {m: ops_per_launch(m, n, iters) / (t * 1e-3)
            for m, t in ms.items()}


def sol_rates(rates: dict, alu_per_s: float, source: str) -> sol.Rates:
    """The :class:`sol.Rates` of :func:`rates_from_ms`'s rates: the ALU
    priced at ``alu_per_s`` (the card's issue rate), and each special
    function's weight in ALU-instruction equivalents, the separate mode's
    instruction rate over the function's call rate less the chain's own
    ALU instructions."""
    alu = rates["separate"] * INSTRUCTIONS["separate"] / LANE_OPS
    weights = {op: alu / rates[op] - EXTRA_ALU.get(op, 0) for op in SPECIAL}
    return sol.Rates(alu_per_s=alu_per_s, weights=weights, source=source)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    device = timing.require_cuda("vpu_peak")
    card = timing.card_line()
    issue = sol.issue_rate_per_s(
        torch.cuda.get_device_properties(device).multi_processor_count,
        timing.max_sm_clock_hz())
    for grid, n in (("jax", int(np.prod(JAX_SHAPE))),
                    ("fill", fill_elements(device))):
        ms, _ = time_modes(probe_input(n, device))
        rates = rates_from_ms(ms, n)
        for mode, rate in rates.items():
            timing.record(args.out, probe="vpu_peak", card=card, grid=grid,
                          elements=n, mode=mode, ms=ms[mode],
                          ops_per_s=rate,
                          instructions_per_step=INSTRUCTIONS.get(mode))
    timing.record(args.out, probe="vpu_peak", card=card, grid="fill",
                  issue_rate_per_s=issue,
                  sol_rates=sol_rates(rates, issue,
                                      f"vpu_peak, {card}").as_dict())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
