// Fixed-order float32 scatter-add for Hopper.
//
// Replaces no Pallas kernel: it is the hand kernel of an XLA op, the
// non-unique `p.at[idx].add(v)` with which the reference merges a batch
// into its float32 window planes (tpustream/runtime/window_program.py,
// `_scatter_words`' fast path, :468-482). On the CPU that scatter adds
// duplicates one by one in arrival order, rounding to float32 after
// every add, as numpy's `np.add.at` does. PyTorch's CUDA scatter-adds
// (`index_add_`, `scatter_add_`) add with atomics, in no fixed order, so
// their bits change from run to run. This kernel gives the sequential
// order's bits on the card:
//
//     for i in 0..B-1:  plane[cell[i]] = fl32(plane[cell[i]] + val[i])
//
// The caller (ops/ordered_scatter.py) sorts the cells stably first, so
// each cell's rows form one run in arrival order, and passes the sorted
// cells with their row numbers. Here one thread owns the run that
// starts at its row: it reads the cell's old value once, adds the
// run's values in order with __fadd_rn (round to nearest, never fused
// into an FMA; the file is built without --use_fast_math, so denormals
// are kept), and writes the cell once. Runs own distinct cells, so no
// two threads write one cell and nothing is atomic. The last cell of
// the plane is the sink that masked rows point at: its run, and any
// cell outside the plane, folds nothing.
//
// What bounds it on an H100: bytes, in principle. The call must read
// the sorted cells (8 B a row), the row numbers (8 B), the values (4 B)
// and read and write each distinct cell it touches (4 B each way): at
// B = 131072 rows about 3.7 MB, 1.1 us at 3.35 TB/s. In practice the
// longest run bounds it: its thread adds one value after another, so a
// hot key's run of m rows is a chain of m dependent adds and loads.
// That is the price of the sequential order, accepted for now; a faster
// design would split long runs across a warp only where the sum is
// exact, which a float sum is not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ordered_scatter_add_kernel(const int64_t* __restrict__ cells,
                                           const int64_t* __restrict__ rows,
                                           const float* __restrict__ vals,
                                           float* __restrict__ plane,
                                           int64_t n_rows, int64_t sink) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int64_t cell = cells[i];
  // only the first row of a run folds it
  if (i > 0 && cells[i - 1] == cell) return;
  if (cell < 0 || cell >= sink) return;
  float acc = plane[cell];
  for (int64_t j = i; j < n_rows && cells[j] == cell; ++j) {
    acc = __fadd_rn(acc, vals[rows[j]]);
  }
  plane[cell] = acc;
}

}  // namespace

// The block size the kernel is launched with (ops/ordered_scatter.py
// reads it once, when it binds the library).
extern "C" int ordered_scatter_block_threads() { return kThreads; }

// Plain C entry point, bound with ctypes. cells: the B cells sorted
// stably (int64); rows: each sorted row's position in the batch
// (int64); vals: the batch's B float32 values in arrival order; plane:
// n_cells float32 cells, the last of them the sink, updated in place.
// Makes one launch on `stream` and returns its cudaError_t.
extern "C" int ordered_scatter_add_launch(const void* cells, const void* rows,
                                          const void* vals, void* plane,
                                          int64_t n_rows, int64_t n_cells,
                                          void* stream) {
  if (n_rows < 0 || n_cells < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ordered_scatter_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cells), static_cast<const int64_t*>(rows),
      static_cast<const float*>(vals), static_cast<float*>(plane), n_rows,
      n_cells - 1);
  return static_cast<int>(cudaGetLastError());
}
