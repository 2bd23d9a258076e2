"""The material gathers' backward (``kernels/row_gather.py``) on the CPU:
the plain version (``index_add_`` into zeros) against autograd's gradient
of ``table[idx]``, :class:`RowGather` (whose backward runs the plain
version off the card) against the same, and the route: CPU tensors and
value-only calls keep ``table[idx]`` and count no launch, the shape gate
sends a table it cannot take (one column, other rows, over the caps) to
``table[idx]``, and a routed mesh replay takes the same gradients.

``csrc/row_gather.cu`` itself builds here with g++ (its device qualifiers
defined away, each block's 128 threads as ``std::thread``s meeting at a
``std::barrier`` for ``__syncthreads``): its chains equal the serial sum
in ray order to the bit, which the CPU's ``index_add_`` computes.  Skips
where no C++ compiler is installed; on the card the kernel is held to
``index_put_``'s bits (``tests/test_torch_cuda.py``)."""

import dataclasses
import re
import shutil
import subprocess

import numpy as np

import pytest
import torch

import spira_tpu_torch as sp
from spira_tpu_torch import _build
from spira_tpu_torch.integrator import bsdf
from spira_tpu_torch.kernels import row_gather as rg


def _index(n, rows, seed, weight_row0=0.9):
    """(n,) int64 indices into ``rows`` rows, about ``weight_row0`` of them
    on row 0 (the bunny's rays: its own material and every miss)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, rows, (n,), generator=g)
    on0 = torch.rand(n, generator=g) < weight_row0
    return torch.where(on0, torch.zeros_like(idx), idx)


def _autograd(idx, tables, cots):
    """Autograd's gradients of ``table[idx]`` at ``cots``."""
    leaves = [t.detach().clone().requires_grad_(t.requires_grad)
              for t in tables]
    outs = [t[idx] for t in leaves]
    pairs = [(o, c) for o, c, t in zip(outs, cots, leaves) if t.requires_grad]
    grads = torch.autograd.grad([o for o, _ in pairs], [
        t for t in leaves if t.requires_grad], [c for _, c in pairs])
    got = iter(grads)
    return [next(got) if t.requires_grad else None for t in leaves]


#: a gradient's float-sum tolerance: each value within this share of the
#: sum of its rays' cotangents' magnitudes (the sums run in another order)
SUM_RTOL = 1e-6


def assert_sums_close(got, want, idx, cot):
    """``got`` within :data:`SUM_RTOL` of the magnitudes summed into each
    value of ``want``, the gradient of a table gathered by ``idx`` at
    ``cot``."""
    mag = rg.row_gather_plain(idx, [cot.abs()], [want.shape])[0]
    err = (got - want).abs()
    assert bool((err <= SUM_RTOL * mag).all()), float((err / mag).max())


#: (rows, a table's trailing shape for each table, rays, row 0's share,
#: which tables need a gradient)
CASES = {
    "bunny_rgb": (3, [(3,), (3,)], 4099, 0.9, [True, True]),
    "all_row0": (3, [(3,), (3,), ()], 2048, 1.0, [True, True, True]),
    "one_row": (1, [(3,), ()], 1000, 1.0, [True, True]),
    "no_grad_table": (5, [(3,), (), (3,)], 777, 0.5, [True, False, True]),
    "spectral_spd": (3, [(24,), (24,)], 1500, 0.8, [True, True]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_autograd(case):
    """``torch.zeros(R, C).index_add_(0, idx, g)`` per table equals
    autograd's gradient of ``table[idx]``."""
    rows, trailing, n, w0, need = CASES[case]
    g = torch.Generator().manual_seed(11)
    idx = _index(n, rows, seed=3, weight_row0=w0)
    tables = [torch.rand((rows, *s), generator=g).requires_grad_(r)
              for s, r in zip(trailing, need)]
    cots = [torch.randn((n, *s), generator=g) for s in trailing]
    want = _autograd(idx, tables, cots)
    got = rg.row_gather_plain(idx, [c for c, r in zip(cots, need) if r],
                              [t.shape for t, r in zip(tables, need) if r])
    got = iter(got)
    for w, c, r in zip(want, cots, need):
        if r:
            assert_sums_close(next(got), w, idx, c)


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_gather_function_equals_autograd(case):
    """:class:`RowGather`: the forward is ``table[idx]`` to the bit, the
    backward autograd's gradient for each table that needs one, and none
    for a table that does not or whose gather goes unused."""
    rows, trailing, n, w0, need = CASES[case]
    g = torch.Generator().manual_seed(5)
    idx = _index(n, rows, seed=7, weight_row0=w0)
    tables = [torch.rand((rows, *s), generator=g).requires_grad_(r)
              for s, r in zip(trailing, need)]
    cots = [torch.randn((n, *s), generator=g) for s in trailing]
    outs = rg.RowGather.apply(idx, *tables)
    for o, t in zip(outs, tables):
        assert torch.equal(o, t.detach()[idx])
    wanted = [t for t in tables if t.requires_grad]
    grads = torch.autograd.grad(
        [o for o, t in zip(outs, tables) if t.requires_grad], wanted,
        [c for c, t in zip(cots, tables) if t.requires_grad])
    want = [(w, c) for w, c in zip(_autograd(idx, tables, cots), cots)
            if w is not None]
    for got_g, (w, c) in zip(grads, want):
        assert_sums_close(got_g, w, idx, c)
    # only the first table's gather is used: the others take no gradient
    outs = rg.RowGather.apply(idx, *tables)
    grads = torch.autograd.grad((outs[0] * cots[0]).sum(), wanted,
                                allow_unused=True)
    assert grads[0] is not None and all(x is None for x in grads[1:])


def _materials(device="cpu", grad=("albedo", "emission")):
    mats = sp.create_scene(device=device).materials
    return dataclasses.replace(mats, **{
        f: getattr(mats, f).detach().clone().requires_grad_() for f in grad})


def test_gather_materials_on_the_cpu_builds_no_row_gather():
    """On CPU tensors, with gradients and without, ``gather_materials``
    takes ``table[idx]``'s own autograd (``IndexBackward0``), builds no
    node of the new Function and counts no launch."""
    rg.row_gather_backward.launches = 0
    mats = _materials()
    idx = _index(500, mats.count, seed=1)
    mat = bsdf.gather_materials(mats, idx)
    for name in ("albedo", "emission"):
        assert type(mat[name].grad_fn).__name__ == "IndexBackward0", name
        assert torch.equal(mat[name], getattr(mats, name).detach()[idx])
    (mat["albedo"].sum() + mat["emission"].sum()).backward()
    with torch.no_grad():
        frozen = bsdf.gather_materials(mats, idx)
    assert all(v.grad_fn is None for v in frozen.values())
    assert rg.row_gather_backward.launches == 0


def test_value_only_call_is_not_routed(monkeypatch):
    """A value-only call keeps ``table[idx]`` even where the route is
    open: under ``no_grad`` the tables are never offered to the gate, and
    with no table that requires grad the gate takes none."""
    monkeypatch.setattr(rg, "_routed", lambda i: torch.is_grad_enabled())
    real, asked = rg.kernel_tables, []
    monkeypatch.setattr(rg, "kernel_tables",
                        lambda tables: asked.append(tables) or real(tables))
    rg.row_gather_backward.launches = 0
    idx = _index(64, 3, seed=2)
    with torch.no_grad():
        out = bsdf.gather_materials(_materials(), idx)
    assert not asked and all(v.grad_fn is None for v in out.values())
    out = bsdf.gather_materials(_materials(grad=()), idx)
    assert len(asked) == 1 and all(v.grad_fn is None for v in out.values())
    assert rg.row_gather_backward.launches == 0


def _grad(*shape, dtype=torch.float32):
    return torch.rand(*shape, dtype=dtype).requires_grad_()


@pytest.mark.parametrize("tables, taken", [
    # the bunny step's albedo and emission; a table that needs no gradient
    (dict(a=_grad(3, 3), b=_grad(3, 3), c=torch.rand(3, 3)), ["a", "b"]),
    # one column (index_put_ sums it in another order), 1-D or (R, 1)
    (dict(a=_grad(3), b=_grad(3, 1), c=_grad(3, 2)), ["c"]),
    # another row count than the first table taken; float64
    (dict(a=_grad(3, 3), b=_grad(4, 3), c=_grad(3, 3, dtype=torch.float64)),
     ["a"]),
    # the staged columns' cap (MAX_COLUMNS), and a table that still fits
    (dict(a=_grad(3, rg.MAX_COLUMNS - 2), b=_grad(3, 3), c=_grad(3, 2)),
     ["a", "c"]),
    # the values' cap (MAX_SLOTS): rows x columns
    (dict(a=_grad(rg.MAX_SLOTS // 4, 2), b=_grad(rg.MAX_SLOTS // 4, 2)),
     ["a", "b"]),
    (dict(a=_grad(rg.MAX_SLOTS // 2 + 1, 2)), []),
    # at most MAX_TABLES tables
    ({str(k): _grad(2, 2) for k in range(rg.MAX_TABLES + 2)},
     [str(k) for k in range(rg.MAX_TABLES)]),
])
def test_shape_gate_takes_tables_by_shape(tables, taken):
    """The gate takes float32 tables that require grad, of two columns or
    more and the first one's rows, in order while the columns stay within
    :data:`MAX_COLUMNS`, the values within :data:`MAX_SLOTS` and the
    tables within :data:`MAX_TABLES`."""
    assert rg.kernel_tables(tables) == taken


def test_shape_gate_sends_a_table_above_the_cap_to_table_idx(monkeypatch):
    """With the route open, a table the gate does not take keeps
    ``table[idx]`` (``IndexBackward0``) beside the ones it takes, and the
    gradients of both routes equal autograd's."""
    fits = _grad(3, 3)
    big = _grad(3, rg.MAX_COLUMNS)
    frozen = torch.rand(3, 3)
    monkeypatch.setattr(rg, "_routed", lambda i: torch.is_grad_enabled())
    idx = _index(3000, 3, seed=4)
    out = rg.gather_rows(idx, dict(a=fits, b=big, c=frozen))
    assert type(out["a"].grad_fn).__name__ == "RowGatherBackward"
    assert type(out["b"].grad_fn).__name__ == "IndexBackward0"
    assert out["c"].grad_fn is None
    g = torch.Generator().manual_seed(9)
    ca = torch.randn(3000, 3, generator=g)
    cb = torch.randn(3000, rg.MAX_COLUMNS, generator=g)
    got = torch.autograd.grad([out["a"], out["b"]], [fits, big], [ca, cb])
    want = _autograd(idx, [fits, big], [ca, cb])
    for x, w, c in zip(got, want, (ca, cb)):
        assert_sums_close(x, w, idx, c)


HOST_DRIVER = r"""
#include <barrier>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __launch_bounds__(n)
#define __restrict__
#define __shared__
struct Dim { unsigned x; };
thread_local Dim threadIdx, blockIdx;
std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// cp.async as a plain copy
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// one block's shared memory (the kernel's extern stage[]): the blocks run
// one after another
namespace spira {
float stage[1 << 16];
}
template <class... A>
void host_launch(unsigned blocks, int threads, A... args);
#include "row_gather_host.cu"
template <class... A>
void host_launch(unsigned blocks, int threads, A... args) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    block_barrier = &bar;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        spira::row_gather_backward(args...);
      });
    for (auto& th : pool) th.join();
  }
}
// in: int64 n, n_tables, rows, cols (n_tables); int64 idx (n); float32
// each table's cotangent (n, cols).  out: float32 each gradient.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int64_t head[3];
  fread(head, 8, 3, f);
  const int64_t n = head[0];
  const int nt = static_cast<int>(head[1]), rows = static_cast<int>(head[2]);
  std::vector<int64_t> c64(nt);
  fread(c64.data(), 8, nt, f);
  std::vector<int> cols(c64.begin(), c64.end());
  std::vector<int64_t> idx(n);
  fread(idx.data(), 8, n, f);
  std::vector<std::vector<float>> cot(nt), grad(nt);
  std::vector<const float*> cp(nt);
  std::vector<float*> gp(nt);
  for (int m = 0; m < nt; ++m) {
    cot[m].resize(n * cols[m]);
    fread(cot[m].data(), 4, n * cols[m], f);
    grad[m].assign(rows * cols[m], -1.0f);
    cp[m] = cot[m].data();
    gp[m] = grad[m].data();
  }
  fclose(f);
  const int err = spira_row_gather_backward(
      idx.data(), n, nt, rows, cp.data(), gp.data(), cols.data(),
      spira::kThreads, spira::kTile, nullptr);
  FILE* o = fopen(argv[2], "wb");
  for (int m = 0; m < nt; ++m) fwrite(grad[m].data(), 4, grad[m].size(), o);
  fclose(o);
  return err;
}
"""

HOST_RUNTIME = r"""
#pragma once
#include <cstddef>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""


@pytest.fixture(scope="module")
def host_gather(tmp_path_factory):
    """``spira_row_gather_backward`` built for the host: its launch runs
    the grid's blocks one after another, each on 128 threads."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) on the PATH")
    work = tmp_path_factory.mktemp("row_gather_host")
    src = (_build.CSRC / "row_gather.cu").read_text()
    src, launches = re.subn(
        r"row_gather_backward<<<(.*?), (.*?),.*?>>>\(",
        r"host_launch(\1, \2, ", src, flags=re.S)
    assert launches == 1
    (work / "row_gather_host.cu").write_text(src)
    (work / "cuda_runtime.h").write_text(HOST_RUNTIME)
    (work / "cuda_pipeline.h").write_text("#pragma once\n")
    (work / "driver.cpp").write_text(HOST_DRIVER)
    exe = work / "driver"
    subprocess.run([cxx, "-O2", "-std=c++20", "-pthread",
                    "-ffp-contract=off", f"-I{work}",
                    str(work / "driver.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)

    def run(idx, cots, rows):
        cols = [c[0].numel() for c in cots]
        with open(work / "in.bin", "wb") as f:
            np.array([idx.shape[0], len(cots), rows, *cols],
                     np.int64).tofile(f)
            idx.numpy().astype(np.int64).tofile(f)
            for c in cots:
                c.numpy().astype(np.float32).tofile(f)
        subprocess.run([str(exe), str(work / "in.bin"),
                        str(work / "out.bin")], check=True)
        out = np.fromfile(work / "out.bin", np.float32)
        grads, at = [], 0
        for c, k in zip(cots, cols):
            grads.append(torch.from_numpy(out[at:at + rows * k].copy())
                         .reshape(rows, *c.shape[1:]))
            at += rows * k
        return grads

    return run


#: (rays, rows, trailing shapes, row 0's share, negative indices): the
#: bunny step's gathers at a tenth of its rays, every ray on row 0, a ray
#: count no multiple of the tile, the spectral SPD tables (five blocks of
#: chains), one ray, indices counted from the end, the columns' cap
HOST_CASES = {
    "bunny_step": (23_040, 3, [(3,), (3,)], 0.9, False),
    "all_row0": (5_000, 3, [(3,), (3,)], 1.0, False),
    "ragged": (1_537, 5, [(3,), (2,), (3,)], 0.5, False),
    "spectral_spd": (3_000, 3, [(24,), (24,)], 0.8, False),
    "one_ray": (1, 3, [(3,)], 0.0, False),
    "negative": (2_000, 4, [(3,)], 0.3, True),
    "columns_cap": (700, 2, [(rg.MAX_COLUMNS,)], 0.5, False),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_kernel_sums_each_row_in_ray_order(host_gather, case):
    """The kernel's chains give the serial sum of each row's rays in ray
    order to the bit (the CPU's ``index_add_``; an index counted from the
    end wraps, as ``table[idx]`` reads it)."""
    n, rows, trailing, share, negative = HOST_CASES[case]
    g = torch.Generator().manual_seed(13)
    idx = _index(n, rows, seed=21, weight_row0=share)
    cots = [((torch.randn((n, *s), generator=g) + 0.05) * 1e-3)
            for s in trailing]
    wrapped = idx
    if negative:
        idx = torch.where(torch.rand(n, generator=g) < 0.5, idx - rows, idx)
        wrapped = torch.where(idx < 0, idx + rows, idx)
    got = host_gather(idx, cots, rows)
    want = rg.row_gather_plain(wrapped, cots,
                               [(rows, *s) for s in trailing])
    for x, w in zip(got, want):
        assert torch.equal(x, w), float((x - w).abs().max())


def test_routed_mesh_replay_takes_the_same_gradients(monkeypatch):
    """The mesh step with its gathers routed through :class:`RowGather`
    (its plain backward off the card) against ``table[idx]``'s own route:
    the same image, gradients equal but for float-sum order, one
    Function a bounce of each replayed sample."""
    scene = sp.attach_packed(sp.create_mesh_scene(subdivisions=1,
                                                  device="cpu"))
    cam = sp.default_camera(2.0, device="cpu")
    kw = dict(width=16, height=8, spp=1, grad_spp=2, max_depth=2, seed=5)

    def grads():
        mats = _materials()
        sc = dataclasses.replace(scene, materials=mats)
        img = sp.render_flat_hybrid_grad_mesh(sc, cam, **kw)
        img.mean().backward()
        return img.detach(), mats.albedo.grad, mats.emission.grad

    img0, *want = grads()
    calls = []
    real = rg.RowGather.apply
    monkeypatch.setattr(rg, "_routed", lambda i: torch.is_grad_enabled())
    monkeypatch.setattr(rg.RowGather, "apply",
                        lambda *a: calls.append(len(a)) or real(*a))
    img1, *got = grads()
    assert torch.equal(img0, img1)
    assert calls == [3] * (kw["grad_spp"] * kw["max_depth"])
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
