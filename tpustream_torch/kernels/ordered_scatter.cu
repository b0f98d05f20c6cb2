// Fixed-order float32 scatter-add for Hopper.
//
// Replaces no Pallas kernel: it is the hand kernel of an XLA op, the
// non-unique `getattr(p.at[idx], op)(val, mode="drop")` with which the
// reference merges a batch into its float32 window planes
// (tpustream/runtime/window_program.py:477-480, the fast path of
// `_scatter_words`). On the CPU that scatter adds duplicates one by one
// in arrival order, rounding to float32 after every add, under XLA's
// flush-to-zero and denormals-are-zero. PyTorch's CUDA scatter-adds add
// with atomics, in no fixed order. This file gives the sequential
// order's bits on the card:
//
//     for i in 0..B-1:  plane[cell[i]] = ftz(ftz(plane[cell[i]]) + ftz(val[i]))
//
// (ftz: a subnormal as a zero of its sign). The last cell of the plane
// is a sink that masked rows point at; it, and any cell outside the
// plane, takes nothing. Every add is `add.rn.ftz.f32`: rounded to
// nearest, operands and sum flushed, never fused into an FMA, never
// reassociated; the file is built without --use_fast_math.
//
// Two bounds. Bytes: the call must read each row's cell (4 B) and value
// (4 B) once and read and write each touched cell once (4 B each way),
// about 1.6 MB at B = 131072 uniform rows, 0.5 us at 3.35 TB/s. The
// chain: a float sum in arrival order is a chain of dependent adds that
// no regrouping keeps the bits of, so a cell that takes m values costs
// at least m add latencies (4 cycles each) on one thread, whatever else
// runs: 131072 values on one cell is about 0.27 ms. Uniform cells are
// bound by bytes (and in practice by the launches' fixed cost); a hot
// cell is bound by its chain.
//
// Design. No sort of the batch: almost every row of a uniform batch is
// the only row of its cell, and needs no order at all. A call runs in
// passes of at most kMaxRows rows, in order (sequential passes keep the
// sequential fold's order), each five launches on one stream:
//
//  0. a memset clears an open-addressing hash table of H >= 2R 64-bit
//     slots (R: the pass's rows), their fill counts and four counters;
//  1. insert: each row's cell takes a slot, a (cell + 1, count) word
//     set by one atomicCAS, or counted by one atomicAdd when the cell
//     is there already (linear probing). A set and a count do not
//     depend on the atomics' order. Equal cells in a warp go in once,
//     through __match_any_sync, so a hot cell costs one atomic a warp;
//  2. slots: each slot with two rows or more (a run) goes on one of
//     three lists by its length: short (up to 32), medium (up to 2048),
//     long; a short or medium run gets its place in a segment array (an
//     aggregated atomicAdd: runs need not be in any order among
//     themselves);
//  3. rows: a row whose cell has one row adds at once (one add, no
//     order question). A short or medium run's rows are written into
//     its segment, in no particular order (warp-aggregated atomics
//     again);
//  4. fold, one launch, each block in one role (long runs first, so
//     their chains start first):
//     - a long run: one block. Its warps take ballots of "this row is
//       in the run" over the pass's rows, 32 rows a word, into a bitmap
//       in shared memory, so walking the bitmap in order visits the
//       run's rows in arrival order. Warps 1-2 stage the values
//       of 64 bitmap words (2048 rows) at a time into a double buffer
//       while thread 0 folds the other buffer;
//     - a medium run: one block. Its row numbers are sorted in shared
//       memory (a bitonic sort, padded to a power of two), its values
//       gathered in that order, and one thread folds them;
//     - a short run: one warp. The lanes rank their rows (32 shuffles),
//       put the values in arrival order in shared memory, and lane 0
//       folds them.
//
// Every fold knows its run's start and length before it starts, and
// reads values already in shared memory, loading the next sixteen
// before it adds the current sixteen, so its chain waits on the add and
// not on a load. Runs own distinct cells, and a single row's cell
// belongs to no run: no two threads write one cell. All scratch is the
// caller's (ordered_scatter_scratch_words); nothing here allocates.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 1 << 17;   // rows a pass: a 16 KB bitmap
constexpr int kShortMax = 32;       // longest run a warp folds
constexpr int kMediumMax = 2048;    // longest run sorted in shared memory
constexpr int kRowThreads = 256;    // insert, slots, rows
constexpr int kFoldThreads = 128;   // a fold block: four warps
constexpr int kFoldWarps = kFoldThreads / kWarp;
constexpr int kStageWords = 64;     // bitmap words a stage: warps 1-2
constexpr int kStageRows = kStageWords * kWarp;
constexpr int kBallotWords = 16;    // bitmap words a warp builds at once
constexpr int kLaunchesPerPass = 5;
constexpr int kMaxDevices = 64;

static_assert(kStageWords == 2 * kWarp, "warps 1-2 stage, a word each");
static_assert(kFoldWarps >= 3, "a long run's block: a folder and two stagers");

// round to nearest, flush subnormal operands and sum to signed zeros
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float add4(float acc, float4 a) {
  acc = add_ftz(acc, a.x);
  acc = add_ftz(acc, a.y);
  acc = add_ftz(acc, a.z);
  return add_ftz(acc, a.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// acc folded with v[0..m) in order; v 16-byte aligned in shared memory.
// The next sixteen values are loaded before the current sixteen are
// added, so the chain waits only on the adds.
__device__ __forceinline__ float fold_values(float acc, const float* v,
                                             int m) {
  int k = 0;
  if (m >= 16) {
    float4 a = ld4(v), b = ld4(v + 4), c = ld4(v + 8), d = ld4(v + 12);
    for (k = 16; k + 16 <= m; k += 16) {
      const float4 na = ld4(v + k), nb = ld4(v + k + 4);
      const float4 nc = ld4(v + k + 8), nd = ld4(v + k + 12);
      acc = add4(add4(add4(add4(acc, a), b), c), d);
      a = na;
      b = nb;
      c = nc;
      d = nd;
    }
    acc = add4(add4(add4(add4(acc, a), b), c), d);
  }
  for (; k < m; ++k) acc = add_ftz(acc, v[k]);
  return acc;
}

// The pass's scratch, carved from the caller's int32 words. The first
// 3H + 4 words (slot words, fills, counters) are cleared each pass.
struct Scratch {
  unsigned long long* slots;  // [H] (cell + 1) << 32 | rows; 0 = empty
  int* fills;     // [H] run rows written so far
  int* counters;  // [4] segment cursor, short / medium / long runs
  int* starts;    // [H] a short or medium run's first position in seg
  int* slot_of;   // [R] each row's slot, -1 for the sink
  int* seg;       // [R] the short and medium runs' rows, run by run
  int* lists;     // [3][R/2 + 1] the runs' slots by class
  int list_cap;
  int H;
  int shift;      // 32 - log2(H)
};

__device__ __forceinline__ int slot_rows(unsigned long long w) {
  return int(w & 0xffffffffull);
}

__device__ __forceinline__ int slot_cell(unsigned long long w) {
  return int(w >> 32) - 1;
}

__host__ __device__ inline int table_slots(int rows) {
  int h = 64;
  while (h < 2 * rows) h <<= 1;
  return h;
}

__host__ inline int64_t scratch_words_for(int rows) {
  const int64_t h = table_slots(rows);
  return 4 * h + 4 + 2 * int64_t(rows) + 3 * (int64_t(rows) / 2 + 1);
}

__host__ inline int64_t cleared_words(int rows) {
  return 3 * int64_t(table_slots(rows)) + 4;
}

__host__ inline Scratch carve(int* base, int rows) {
  Scratch s;
  s.H = table_slots(rows);
  int log2h = 0;
  while ((1 << log2h) < s.H) ++log2h;
  s.shift = 32 - log2h;
  s.slots = reinterpret_cast<unsigned long long*>(base);  // 256-B aligned
  s.fills = base + 2 * s.H;
  s.counters = s.fills + s.H;
  s.starts = s.counters + 4;
  s.slot_of = s.starts + s.H;
  s.seg = s.slot_of + rows;
  s.lists = s.seg + rows;
  s.list_cap = rows / 2 + 1;
  return s;
}

__global__ void insert_kernel(const int* __restrict__ cells, int n, int sink,
                              Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const bool active = i < n;
  const int cell = active ? cells[i] : -1;
  const bool valid = active && cell >= 0 && cell < sink;
  const unsigned vmask = __ballot_sync(kFull, valid);
  if (!valid) {
    if (active) s.slot_of[i] = -1;
    return;
  }
  const unsigned peers = __match_any_sync(vmask, cell);
  const int leader = __ffs(peers) - 1;
  int slot = 0;
  if (lane == leader) {
    const unsigned mask = unsigned(s.H) - 1;
    const unsigned long long key = (unsigned long long)(cell + 1) << 32;
    const unsigned long long rows = unsigned(__popc(peers));
    unsigned h = (unsigned(cell) * 2654435761u) >> s.shift;
    while (true) {
      const unsigned long long prev = atomicCAS(s.slots + h, 0ull, key | rows);
      if (prev == 0ull) break;
      if ((prev & ~0xffffffffull) == key) {
        atomicAdd(s.slots + h, rows);
        break;
      }
      h = (h + 1) & mask;
    }
    slot = int(h);
  }
  s.slot_of[i] = __shfl_sync(peers, slot, leader);
}

__device__ __forceinline__ int run_class(int c) {
  return c <= kShortMax ? 0 : c <= kMediumMax ? 1 : 2;
}

__global__ void slots_kernel(Scratch s) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = h < s.H ? slot_rows(s.slots[h]) : 0;
  const bool run = c >= 2;
  if (__ballot_sync(kFull, run) == 0) return;  // warp-uniform
  // the warp's short and medium runs take consecutive places in seg
  const int mine = run && c <= kMediumMax ? c : 0;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int base = 0;
  if (lane == kWarp - 1) base = atomicAdd(s.counters, incl);
  base = __shfl_sync(kFull, base, kWarp - 1);
  if (mine) s.starts[h] = base + incl - mine;
  const int cls = run ? run_class(c) : -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const unsigned m = __ballot_sync(kFull, cls == k);
    if (m == 0) continue;
    int at = 0;
    if (lane == __ffs(m) - 1) at = atomicAdd(s.counters + 1 + k, __popc(m));
    at = __shfl_sync(kFull, at, __ffs(m) - 1);
    if (cls == k) s.lists[k * s.list_cap + at + __popc(m & lanemask_lt())] = h;
  }
}

__global__ void rows_kernel(const int* __restrict__ cells,
                            const float* __restrict__ vals,
                            float* __restrict__ plane, int n, Scratch s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const int slot = i < n ? s.slot_of[i] : -1;
  const int c = slot >= 0 ? slot_rows(s.slots[slot]) : 0;
  if (c == 1) {
    // the cell's only row: one add, no order to keep
    const int cell = cells[i];
    plane[cell] = add_ftz(plane[cell], vals[i]);
  }
  // a long run's block finds its rows from slot_of: only short and
  // medium runs are written out
  const bool dup = c >= 2 && c <= kMediumMax;
  const unsigned dmask = __ballot_sync(kFull, dup);
  if (!dup) return;
  const unsigned peers = __match_any_sync(dmask, slot);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(s.fills + slot, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  s.seg[s.starts[slot] + base + __popc(peers & lanemask_lt())] = i;
}

// A fold block's shared memory: one role's at a time.
union FoldShared {
  float short_v[kFoldWarps][kWarp];
  struct {
    int rows[kMediumMax];
    float v[kMediumMax];
  } medium;
  struct {
    float v[2][kStageRows];
    int count[2];
    int half;
  } lng;
};

__device__ void fold_short(const float* __restrict__ vals,
                           float* __restrict__ plane, const Scratch& s,
                           FoldShared& sm, int block, int blocks) {
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x & (kWarp - 1);
  const int n_runs = s.counters[1];
  const int* list = s.lists;
  for (int r = block * kFoldWarps + warp; r < n_runs;
       r += blocks * kFoldWarps) {
    const int h = list[r];
    const unsigned long long w = s.slots[h];
    const int m = slot_rows(w);
    const int row = lane < m ? s.seg[s.starts[h] + lane] : INT_MAX;
    // rows are distinct: a row's rank is the count of smaller rows
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kWarp; ++j) rank += __shfl_sync(kFull, row, j) < row;
    if (lane < m) sm.short_v[warp][rank] = vals[row];
    __syncwarp();
    if (lane == 0) {
      const int cell = slot_cell(w);
      plane[cell] = fold_values(plane[cell], sm.short_v[warp], m);
    }
    __syncwarp();
  }
}

__device__ void fold_medium(const float* __restrict__ vals,
                            float* __restrict__ plane, const Scratch& s,
                            FoldShared& sm, int block, int blocks) {
  const int tid = threadIdx.x;
  const int n_runs = s.counters[2];
  const int* list = s.lists + s.list_cap;
  int* rows = sm.medium.rows;
  float* v = sm.medium.v;
  for (int r = block; r < n_runs; r += blocks) {
    const int h = list[r];
    const unsigned long long w = s.slots[h];
    const int m = slot_rows(w);
    const int* seg = s.seg + s.starts[h];
    int p = 2 * kShortMax;  // a medium run has more than kShortMax rows
    while (p < m) p <<= 1;
#pragma unroll 4
    for (int k = tid; k < p; k += blockDim.x) rows[k] = k < m ? seg[k] : INT_MAX;
    __syncthreads();
    // bitonic sort of the run's row numbers, ascending: arrival order
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < p; i += blockDim.x) {
          const int o = i ^ j;
          if (o > i) {
            const int a = rows[i], b = rows[o];
            if ((a > b) == ((i & k) == 0)) {
              rows[i] = b;
              rows[o] = a;
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll 4
    for (int k = tid; k < m; k += blockDim.x) v[k] = vals[rows[k]];
    __syncthreads();
    if (tid == 0) {
      const int cell = slot_cell(w);
      plane[cell] = fold_values(plane[cell], v, m);
    }
    __syncthreads();
  }
}

// Warps 1-2: the values of bitmap words [c * 64, c * 64 + 64), in row
// order, into buf; their count into *count.
__device__ __forceinline__ void stage_words(const float* __restrict__ vals,
                                            const unsigned* bits, int words,
                                            int c, float* buf, int* count,
                                            int* half) {
  const int t = threadIdx.x - kWarp;  // 0..63
  const int lane = t & (kWarp - 1);
  const int w = c * kStageWords + t;
  const unsigned word = w < words ? bits[w] : 0u;
  const int pc = __popc(word);
  int incl = pc;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (t == kWarp - 1) *half = incl;
  asm volatile("bar.sync 1, %0;" ::"n"(kStageWords) : "memory");
  int off = incl - pc + (t >= kWarp ? *half : 0);
  if (t == kStageWords - 1) *count = off + pc;
  if (word == 0u) return;
  const float* src = vals + (size_t(w) << 5);
  float x[kWarp];
#pragma unroll
  for (int j = 0; j < kWarp; ++j) x[j] = (word >> j) & 1u ? __ldg(src + j) : 0.f;
#pragma unroll
  for (int j = 0; j < kWarp; ++j) {
    if ((word >> j) & 1u) buf[off++] = x[j];
  }
}

__device__ void fold_long(const float* __restrict__ vals,
                          float* __restrict__ plane, int n, const Scratch& s,
                          FoldShared& sm, unsigned* bits, int block,
                          int blocks) {
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid & (kWarp - 1);
  const bool stager = tid >= kWarp && tid < kWarp + kStageWords;
  const int words = (n + kWarp - 1) / kWarp;
  const int chunks = (words + kStageWords - 1) / kStageWords;
  const int n_runs = s.counters[3];
  const int* list = s.lists + 2 * s.list_cap;
  for (int r = block; r < n_runs; r += blocks) {
    const int h = list[r];
    const unsigned long long w = s.slots[h];
    // the run's rows as a bitmap, in arrival order: a warp's ballot over
    // 32 consecutive rows of the pass is one word, every word written
    // once, no atomics; kBallotWords loads in flight a warp
    for (int w0 = warp * kBallotWords; w0 < words;
         w0 += kFoldWarps * kBallotWords) {
      int sl[kBallotWords];
#pragma unroll
      for (int u = 0; u < kBallotWords; ++u) {
        const int i = (w0 + u) * kWarp + lane;
        sl[u] = i < n ? s.slot_of[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kBallotWords; ++u) {
        const unsigned b = __ballot_sync(kFull, sl[u] == h);
        if (lane == 0 && w0 + u < words) bits[w0 + u] = b;
      }
    }
    __syncthreads();
    if (stager) {
      stage_words(vals, bits, words, 0, sm.lng.v[0], sm.lng.count, &sm.lng.half);
    }
    __syncthreads();
    const int cell = slot_cell(w);
    float acc = tid == 0 ? plane[cell] : 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (tid == 0) {
        acc = fold_values(acc, sm.lng.v[c & 1], sm.lng.count[c & 1]);
      } else if (stager && c + 1 < chunks) {
        stage_words(vals, bits, words, c + 1, sm.lng.v[(c + 1) & 1],
                    sm.lng.count + ((c + 1) & 1), &sm.lng.half);
      }
      __syncthreads();
    }
    if (tid == 0) plane[cell] = acc;
    __syncthreads();
  }
}

// One launch, three roles by block: [0, g_long) long runs, then
// [g_long, g_long + g_medium) medium runs, then short runs.
__global__ void fold_kernel(const float* __restrict__ vals,
                            float* __restrict__ plane, int n, Scratch s,
                            int g_long, int g_medium) {
  extern __shared__ unsigned s_bits[];  // one bit a row of the pass
  __shared__ __align__(16) FoldShared sm;
  const int b = blockIdx.x;
  if (b < g_long) {
    fold_long(vals, plane, n, s, sm, s_bits, b, g_long);
  } else if (b < g_long + g_medium) {
    fold_medium(vals, plane, s, sm, b - g_long, g_medium);
  } else {
    fold_short(vals, plane, s, sm, b - g_long - g_medium,
               gridDim.x - g_long - g_medium);
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 132;
  }
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

}  // namespace

// Rows a pass takes; a call of more rows runs passes in order.
extern "C" int ordered_scatter_max_rows() { return kMaxRows; }

// Launches a pass makes (the memset included).
extern "C" int ordered_scatter_launches_per_pass() { return kLaunchesPerPass; }

// The int32 scratch words a call of n_rows rows needs.
extern "C" int64_t ordered_scatter_scratch_words(int64_t n_rows) {
  if (n_rows < 0) return -1;
  const int rows = int(n_rows < kMaxRows ? n_rows : kMaxRows);
  return scratch_words_for(rows);
}

// Plain C entry point, bound with ctypes. cells: B int32 cells; vals:
// B float32 values, in arrival order; plane: n_cells float32 cells, the
// last of them the sink, updated in place; scratch: the caller's
// scratch_words int32 words. Launches on `stream`, never waits, and
// returns the first cudaError_t of its launches (0 if none).
extern "C" int ordered_scatter_add_launch(const void* cells, const void* vals,
                                          void* plane, int64_t n_rows,
                                          int64_t n_cells, void* scratch,
                                          int64_t scratch_words,
                                          void* stream) {
  if (n_rows < 0 || n_cells < 1 || n_cells > INT_MAX ||
      scratch_words < ordered_scatter_scratch_words(n_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  const int sink = int(n_cells - 1);
  for (int64_t off = 0; off < n_rows; off += kMaxRows) {
    const int rows = int(n_rows - off < kMaxRows ? n_rows - off : kMaxRows);
    const Scratch s = carve(static_cast<int*>(scratch), rows);
    const int* c = static_cast<const int*>(cells) + off;
    const float* v = static_cast<const float*>(vals) + off;
    float* p = static_cast<float*>(plane);
    cudaError_t err = cudaMemsetAsync(s.slots, 0,
                                      cleared_words(rows) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int row_blocks = (rows + kRowThreads - 1) / kRowThreads;
    insert_kernel<<<row_blocks, kRowThreads, 0, st>>>(c, rows, sink, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    slots_kernel<<<(s.H + kRowThreads - 1) / kRowThreads, kRowThreads, 0, st>>>(s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rows_kernel<<<row_blocks, kRowThreads, 0, st>>>(c, v, p, rows, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const size_t bitmap = size_t((rows + kWarp - 1) / kWarp) * sizeof(unsigned);
    const int g_long = sms, g_medium = 5 * sms, g_short = 2 * sms;
    fold_kernel<<<g_long + g_medium + g_short, kFoldThreads, bitmap, st>>>(
        v, p, rows, s, g_long, g_medium);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
