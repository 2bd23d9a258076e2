"""Per-ray gathers of material rows whose backward is one hand-written
CUDA launch: the wavefront estimator's ``table[idx]`` over the material
tables (:func:`spira_tpu_torch.integrator.bsdf.gather_materials`, the SPD
rows of :mod:`spira_tpu_torch.integrator.spectral`).

The forward is ``table[idx]`` for each table, the same operations as a
plain gather.  The backward of autograd's own ``table[idx]`` on the card is
``index_put_`` with accumulate: it sorts the indices, then sums each row's
run of rays serially in ray order, every term waiting on two dependent
loads; with a scene's few materials one run holds most of a bounce's rays.
:class:`RowGather`'s backward is :func:`row_gather_backward`, one launch of
``csrc/row_gather.cu`` for every table of the call that needs a gradient.
It keeps that order, a chain of float adds a value over the rays in
increasing index, so its bits are ``index_put_``'s (a sum in another order
moves the gradient by more than a reference that differentiates
``table[idx]`` allows); it drops the sort and streams the rays through
shared memory.  No atomics: the same bits on every launch.

* :func:`gather_rows` — the entry: routes a call through
  :class:`RowGather` only when grad mode is on, the index lies on a CUDA
  device and some table requires grad (:func:`kernel_tables` picks the
  tables by dtype and shape); anything else is ``table[idx]``, unchanged.
* :func:`row_gather_plain` — the plain version, ``index_add_`` into
  zeros, table by table.

No TPU kernel is replaced: the JAX package gathers material rows by one-hot
matrix products (``spira_tpu/integrator/bsdf.py:30-47``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils.profiling import annotate

#: the kernel's threads a block and rays a staged tile
#: (``csrc/row_gather.cu``: ``kThreads``, ``kTile``; the launch checks that
#: they agree)
THREADS = 128
TILE = 512
#: the dynamic shared memory one block may take (``kSmemLimit``): an
#: H100's 227 KB a block, less 1 KB
SMEM_LIMIT = 232_448 - 1024
#: the most columns (summed over a call's tables) whose two staged tiles,
#: an int64 index, an int32 row and the columns' floats a ray, fit that
#: shared memory
MAX_COLUMNS = SMEM_LIMIT // (2 * TILE * 4) - 3
#: the most values (rows x columns) a call takes: one chain of adds over
#: every ray a value, 32 a block, so 32 blocks in all
MAX_SLOTS = 1024
#: the most tables one launch takes (``kMaxTables``)
MAX_TABLES = 8

_VP = ctypes.c_void_p
_ARGTYPES = (
    _VP, ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # idx, n, n_tables, rows
    _VP, _VP, _VP,  # cot, grad (pointer arrays), cols
    ctypes.c_int, ctypes.c_int,  # threads, tile
    _VP,  # stream
)


def kernel_tables(tables):
    """The names, in order, of the tables of ``tables`` (name -> tensor,
    rows first) whose gathers' backward :func:`row_gather_backward` takes:
    float32, requiring grad, of two columns or more (``index_put_`` sums a
    one-column table in another order), of the first such table's rows,
    while the columns taken stay within :data:`MAX_COLUMNS`, the values
    within :data:`MAX_SLOTS` and the tables within :data:`MAX_TABLES`.
    Every other table keeps ``table[idx]``."""
    chosen, columns, rows = [], 0, None
    for name, t in tables.items():
        if not (t.requires_grad and t.dtype == torch.float32
                and t.dim() >= 2 and t.shape[0] > 0):
            continue
        cols = t.numel() // t.shape[0]
        if (cols < 2 or (rows is not None and t.shape[0] != rows)
                or columns + cols > MAX_COLUMNS
                or t.shape[0] * (columns + cols) > MAX_SLOTS
                or len(chosen) == MAX_TABLES):
            continue
        chosen.append(name)
        columns += cols
        rows = t.shape[0]
    return chosen


def _routed(idx):
    """Whether gathers by ``idx`` may go through :class:`RowGather`: grad
    mode is on and ``idx`` is int64 on a CUDA device."""
    return (torch.is_grad_enabled() and idx.is_cuda
            and idx.dtype == torch.int64)


def gather_rows(idx, tables):
    """``{name: table[idx]}`` for ``tables`` (name -> tensor, rows
    first) and the (N,) int64 index ``idx``.  With grad mode on, ``idx``
    on a CUDA device and tables that :func:`kernel_tables` takes, those
    gathers go through one :class:`RowGather`; every other gather is
    ``table[idx]``."""
    chosen = kernel_tables(tables) if _routed(idx) else ()
    got = {}
    if chosen:
        got = dict(zip(chosen, RowGather.apply(
            idx, *(tables[name] for name in chosen))))
    return {name: got[name] if name in got else t[idx]
            for name, t in tables.items()}


class RowGather(torch.autograd.Function):
    """``table[idx]`` for each table after ``idx``; the backward writes the
    gradients of the tables that need one by :func:`row_gather_backward`
    (one launch on the card, the plain version elsewhere)."""

    @staticmethod
    def forward(ctx, idx, *tables):
        ctx.save_for_backward(idx)
        ctx.shapes = [t.shape for t in tables]
        ctx.set_materialize_grads(False)
        return tuple(t[idx] for t in tables)

    @staticmethod
    def backward(ctx, *cots):
        (idx,) = ctx.saved_tensors
        wanted = [m for m, (c, need) in enumerate(
            zip(cots, ctx.needs_input_grad[1:])) if need and c is not None]
        grads = [None] * len(cots)
        if wanted:
            got = row_gather_backward(idx, [cots[m] for m in wanted],
                                      [ctx.shapes[m] for m in wanted])
            for m, g in zip(wanted, got):
                grads[m] = g
        return (None, *grads)


def row_gather_plain(idx, cots, shapes):
    """The plain version of :func:`row_gather_backward`: for each table,
    ``torch.zeros(R, C).index_add_(0, idx, cot)`` shaped as the table."""
    n = idx.shape[0]
    return [torch.zeros((s[0], torch.Size(s[1:]).numel()), dtype=cot.dtype,
                        device=cot.device)
            .index_add_(0, idx, cot.reshape(n, -1)).reshape(s)
            for cot, s in zip(cots, shapes)]


def row_gather_backward(idx, cots, shapes):
    """The gradients of the tables of ``shapes`` (rows first, the same rows
    for all) gathered by the (N,) int64 ``idx``, from the (N, ...)
    cotangents ``cots`` of their gathers: ``grad[r]`` the sum of ``cot[i]``
    over ``idx[i] == r`` in increasing ``i``, each shaped as its table.

    On a CUDA device: one launch of ``csrc/row_gather.cu`` (built on first
    use) for all the tables, which adds one to
    ``row_gather_backward.launches``; the columns may not pass
    :data:`MAX_COLUMNS`, the values :data:`MAX_SLOTS`, the tables
    :data:`MAX_TABLES`.  Its sums run in ``index_put_``'s order: its bits
    for tables of two columns or more.  On the CPU:
    :func:`row_gather_plain`."""
    device = idx.device
    if device.type != "cuda":
        return row_gather_plain(idx, cots, shapes)
    n = idx.shape[0]
    rows = {int(s[0]) for s in shapes}
    cols = [int(torch.Size(s[1:]).numel()) for s in shapes]
    if (len(rows) != 1 or not 0 < len(shapes) <= MAX_TABLES
            or sum(cols) > MAX_COLUMNS or min(rows) * sum(cols) > MAX_SLOTS):
        raise ValueError(f"tables of shapes {[tuple(s) for s in shapes]}: "
                         f"the kernel takes 1..{MAX_TABLES} tables of one "
                         f"row count, at most {MAX_COLUMNS} columns "
                         f"(MAX_COLUMNS) and {MAX_SLOTS} values (MAX_SLOTS)")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise ValueError(f"the index must be (N,) int64, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    idx = idx.contiguous()
    cots = [c.contiguous() for c in cots]
    for c, k in zip(cots, cols):
        if (c.device != device or c.dtype != torch.float32
                or c.numel() != n * k):
            raise ValueError(f"a cotangent of {c.dtype} {tuple(c.shape)} on "
                             f"{c.device}: the kernel takes float32 ({n}, "
                             f"{k}) on {device}")
    grads = [torch.empty(s, dtype=torch.float32, device=device)
             for s in shapes]
    if n == 0:
        return [g.zero_() for g in grads]
    arr = ctypes.c_void_p * len(shapes)
    fn = _build.entry("row_gather", "spira_row_gather_backward", _ARGTYPES)
    with annotate("spira.kernel.row_gather_backward"), \
            torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(idx.data_ptr(), n, len(shapes), rows.pop(),
                 arr(*(c.data_ptr() for c in cots)),
                 arr(*(g.data_ptr() for g in grads)),
                 (ctypes.c_int * len(cols))(*cols), THREADS, TILE, stream)
    if err != 0:
        raise RuntimeError(f"row_gather_backward launch failed: CUDA error "
                           f"{err}")
    row_gather_backward.launches += 1
    return grads


#: Kernel launches since the count was last reset (set it to 0 to reset).
row_gather_backward.launches = 0
