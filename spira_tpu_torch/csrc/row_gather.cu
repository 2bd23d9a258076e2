// The backward of the wavefront estimator's per-ray gathers of material
// rows, for Hopper (sm_90a): for each of up to kMaxTables tables gathered
// by one index, d table[r, c] = the sum over the rays i with idx[i] == r of
// cot[i, c], in increasing i.
//
// Replaces no Pallas kernel: the JAX package gathers material rows by
// one-hot matrix products (spira_tpu/integrator/bsdf.py:30-47), whose
// transpose XLA computes.  On the card, autograd's backward of table[idx]
// is index_put_ with accumulate: it sorts the indices (a stable radix
// sort), then sums each row's run of rays serially in ray order, from 0.
// Every term of that sum waits on two dependent loads through the sorted
// permutation, and with the bunny's three materials one run holds most of
// a bounce's 230,400 rays: about 23 ms a call.
//
// The order is kept.  A float sum in another order rounds otherwise: a
// tree over the bunny step's rays moved the gradient's norm by 1.4e-4 of
// itself, against a reference that differentiates table[idx] as autograd
// does (PERF.md, PR 21).  So each (table, row, column) value is one chain
// of float adds over the rays in increasing index, from 0.0f, adding a
// ray's cotangent where the ray's row is the chain's: index_put_'s bits
// for every table of two columns or more (one column takes another order
// there, and the wrapper routes such tables to table[idx]).  What goes is
// the sort and the stalled gathers:
//
// * a block holds one chain warp (a lane a value; block b takes the values
//   32 b .. 32 b + 31) and three loader warps;
// * the loaders stage the rays in tiles of kTile in shared memory, double
//   buffered, by asynchronous copies (cp.async: all of a tile's loads in
//   flight at once): each ray's index, then its row as int32 (a negative
//   index counted from the end, as table[idx] reads it; -1 out of range),
//   and its cotangent row of every table side by side;
// * while they fill one buffer, the chain warp walks the other, a ray a
//   step: a broadcast read of the row, a read of the lane's column, an add
//   where the rows match.  No atomics; the bits depend on nothing but the
//   inputs.
//
// What bounds it: the chain, one dependent float add a ray (about 4 cycles
// on an H100), so N adds a call, whatever the number of values (the chains
// run side by side, 32 a block).  Device-memory bytes, N (8 + 4 columns),
// read once from HBM and again from L2 by each further block, are far
// below that.  Shared memory holds 2 kTile (12 + 4 columns) bytes, so the
// wrapper sends tables of more than kSmemLimit's columns, or of more
// values than it allows chains (kernels/row_gather.py: MAX_COLUMNS,
// MAX_SLOTS), to table[idx]'s own backward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (see spira_tpu_torch/_build.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace spira {

constexpr int kChains = 32;    // the chain warp: a value a lane
constexpr int kLoaders = 96;   // three loader warps
constexpr int kThreads = kChains + kLoaders;
constexpr int kTile = 512;     // rays a staged tile
constexpr int kMaxTables = 8;
// the dynamic shared memory a block may take: an H100's 227 KB a block,
// less 1 KB
constexpr int kSmemLimit = 232448 - 1024;
// the default a kernel may take without opting in
constexpr int kSmemDefault = 48 * 1024;

struct GatherTables {
  const float* cot[kMaxTables];  // (N, cols) cotangent of each gather
  float* grad[kMaxTables];       // (rows, cols) gradient of each table
  int cols[kMaxTables];
  int base[kMaxTables];    // the table's first value (slot)
  int offset[kMaxTables];  // its first column in a staged ray
  int n_tables;
  int rows;     // every table's
  int slots;    // rows x the sum of cols
  int columns;  // the sum of cols
};

// a staged tile: kTile int64 indices, kTile int32 rows, kTile x columns
// floats
__device__ inline size_t tile_words(int columns) {
  return static_cast<size_t>(kTile) * (3 + columns);
}

__global__ void __launch_bounds__(kThreads)
    row_gather_backward(const int64_t* __restrict__ idx, int64_t n,
                        GatherTables tb) {
  extern __shared__ float stage[];  // two tiles
  const int warp = threadIdx.x / 32;
  const int64_t tiles = (n + kTile - 1) / kTile;

  // the chain lane's value: table m, row r, staged column col
  const int slot = blockIdx.x * kChains + threadIdx.x;
  const bool chain = warp == 0 && slot < tb.slots;
  int m = 0, r = 0, col = 0;
  if (chain) {
    while (slot >= tb.base[m] + tb.rows * tb.cols[m]) ++m;
    const int v = slot - tb.base[m];
    r = v / tb.cols[m];
    col = tb.offset[m] + (v - r * tb.cols[m]);
  }
  float acc = 0.0f;

  for (int64_t k = 0; k <= tiles; ++k) {
    if (warp > 0 && k < tiles) {
      // stage tile k
      float* buf = stage + (k & 1) * tile_words(tb.columns);
      int64_t* ids = reinterpret_cast<int64_t*>(buf);
      int* rows = reinterpret_cast<int*>(buf + 2 * kTile);
      float* vals = buf + 3 * kTile;
      const int64_t start = k * kTile;
      const int cnt = static_cast<int>(n - start < kTile ? n - start : kTile);
      const int t = threadIdx.x - kChains;
      for (int j = t; j < cnt; j += kLoaders)
        __pipeline_memcpy_async(ids + j, idx + start + j, sizeof(int64_t));
      for (int q = 0; q < tb.n_tables; ++q) {
        const int cols = tb.cols[q];
        const float* src = tb.cot[q] + start * cols;
        for (int e = t; e < cnt * cols; e += kLoaders) {
          const int j = e / cols;
          __pipeline_memcpy_async(
              vals + j * tb.columns + tb.offset[q] + (e - j * cols), src + e,
              sizeof(float));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      // each loader converts the indices it copied
      for (int j = t; j < cnt; j += kLoaders) {
        const int64_t id = ids[j];
        const int64_t row = id < 0 ? id + tb.rows : id;
        rows[j] = row >= 0 && row < tb.rows ? static_cast<int>(row) : -1;
      }
    } else if (chain && k > 0) {
      // walk tile k - 1, a ray at a time, in ray order
      const float* buf = stage + ((k - 1) & 1) * tile_words(tb.columns);
      const int* rows = reinterpret_cast<const int*>(buf + 2 * kTile);
      const float* vals = buf + 3 * kTile + col;
      const int64_t start = (k - 1) * kTile;
      const int cnt = static_cast<int>(n - start < kTile ? n - start : kTile);
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) {
        const float x = vals[j * tb.columns];
        if (rows[j] == r) acc += x;
      }
    }
    __syncthreads();
  }
  if (chain) tb.grad[m][r * tb.cols[m] + (col - tb.offset[m])] = acc;
}

}  // namespace spira

// The gradients of n_tables tables of `rows` rows gathered by idx (n rays,
// int64): cot[m] is the (n, cols[m]) cotangent of table m's gather, grad[m]
// its (rows, cols[m]) gradient, written whole.  threads and tile are the
// wrapper's copies of kThreads and kTile, checked here.  Returns 0 or a
// CUDA error code.
extern "C" int spira_row_gather_backward(
    const int64_t* idx, int64_t n, int n_tables, int rows,
    const float* const* cot, float* const* grad, const int* cols,
    int threads, int tile, void* stream) {
  using namespace spira;
  if (threads != kThreads || tile != kTile || n < 1 || rows < 1 ||
      n_tables < 1 || n_tables > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherTables tb{};
  tb.n_tables = n_tables;
  tb.rows = rows;
  for (int m = 0; m < n_tables; ++m) {
    if (cols[m] < 1) return static_cast<int>(cudaErrorInvalidValue);
    tb.cot[m] = cot[m];
    tb.grad[m] = grad[m];
    tb.cols[m] = cols[m];
    tb.base[m] = tb.slots;
    tb.offset[m] = tb.columns;
    tb.slots += rows * cols[m];
    tb.columns += cols[m];
  }
  const size_t smem =
      2 * static_cast<size_t>(kTile) * (3 + tb.columns) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (smem > static_cast<size_t>(kSmemDefault)) {
    err = cudaFuncSetAttribute(row_gather_backward,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>((tb.slots + kChains - 1) / kChains);
  row_gather_backward<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(idx, n, tb);
  return static_cast<int>(cudaGetLastError());
}
