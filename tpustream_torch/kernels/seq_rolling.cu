// Record-at-a-time keyed rolling reduce (max / min / sum) for Hopper.
//
// Replaces the Pallas kernel tpustream/ops/pallas_rolling.py::
// seq_rolling_reduce (pallas_call at :103). For a flat [K] plane and
// flat [B] keys and values, in arrival order:
//
//     plane[key[i]] = op(plane[key[i]], val[i]);  emis[i] = plane[key[i]];
//
// Rows whose key is negative (padding) fold nothing; their emission is
// their own value. Rows whose key is >= K fold nothing either, emit
// their own value and are counted into *bad_keys, so the caller can
// fail without the host waiting on the card. The plane is updated in
// place.
//
// What bounds it on an H100: bytes. The work must move the keys (4 B a
// row), the values and the emissions (4 or 8 B a row each) and the
// plane rows the batch touches (read and written once each): at
// B = 131072 rows of f64 about 4.5 MB, 1.4 us at 3.35 TB/s. The
// arithmetic is one compare or add a row. In practice the kernel is
// bound by latency: 2P + 2 dependent phases, each of which moves a few
// MB that stay in the 50 MB L2. So it is one cooperative launch, with a
// grid-wide barrier between phases instead of a launch for each: on an
// H100 the host takes longer to issue eight launches than the card
// takes to run them.
//
// Design: the work is spread over rows, not over owners of keys, so it
// costs the same whatever the key skew. A hot key is one long segment
// that every tile scans in parallel. Each phase walks the tiles of
// kTile rows, one block a tile (a block takes several when the grid is
// smaller than the tile count).
//
//  1. Stable LSD radix sort of (key << 32 | row) pairs by key, 8-bit
//     digits, P passes: enough digits for the values 0..K, since
//     padding and out-of-range rows take the key K and sort last. Each
//     pass is two phases. hist_tile counts a tile's digits in shared
//     memory. scatter_tile first finds where each of its digits starts
//     (every block reads the counts of all tiles, so no phase scans
//     them), then ranks its rows stably: each warp walks its own run of
//     rows 32 at a time, groups equal digits with __match_any_sync and
//     keeps its counts in shared memory, so no atomic decides an order.
//  2. reduce_tile gathers each sorted row's value, seeds the first row
//     of every key's segment with plane[key], and reduces the tile to
//     the fold of its last segment and whether a segment starts in it.
//  3. apply_tile folds the aggregates of the tiles before its own, in
//     tile order (reduce-then-scan), scans its tile in registers and
//     shared memory, writes emis[row], and at each segment's last row
//     writes plane[key].
//
// Numbers. max/min give the sequential fold's bits in any order, and
// so does an int64 sum, which wraps in two's complement as the
// reference's does. A float sum adds in a fixed tree order (in row
// order within a thread's kItems rows, then Kogge-Stone across lanes,
// warps and tiles), not in arrival order: the same bits on every
// launch, within (m-1)*eps*sum|v| of the sequential fold for a key with
// m terms.
//
// max/min follow jnp.maximum / jnp.minimum (the reference's rolling
// step): a NaN operand gives NaN, and +0.0 is greater than -0.0. CUDA's
// fmax/fmin drop NaN, so they are not used.
//
// Subnormals are flushed as the reference's compiler (XLA) flushes them:
// its computations read a subnormal operand as a zero of the same sign
// and write a subnormal result as one. So every value a key folds and
// every stored plane value it starts from are flushed when read, and
// every float sum is flushed when formed (a max or a min of flushed
// operands is one of them). PTX has no .ftz for float64, so the flush is
// explicit (ftz below) for both float types. A padding row's emission is
// its own value, unflushed: it is a copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 4;                 // rows per thread
constexpr int kTile = kThreads * kItems;  // rows per block: 1024
constexpr int kRun = kWarp * kItems;      // rows per warp in the sort
constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoKey = 0xffffffffu;  // past the batch; never a key
constexpr int kMaxDevices = 64;

static_assert(kRadix == kThreads, "one thread per digit");

enum Op { kMax = 0, kMin = 1, kSum = 2 };

// A subnormal float as a zero of its sign (XLA's flush); NaN, inf and
// normal floats, and integers, as they are.
template <typename T>
__device__ __forceinline__ T ftz(T x) {
  if constexpr (std::is_integral<T>::value) {
    return x;
  } else {
    const T tiny = sizeof(T) == 8 ? T(DBL_MIN) : T(FLT_MIN);
    return fabs(x) < tiny ? copysign(T(0), x) : x;
  }
}

// The operands come flushed; a float sum is flushed when formed.
template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (std::is_integral<T>::value) {
    // signed overflow is undefined in C++; the reference's int64 sum
    // (and Java's long) wraps in two's complement, so add as unsigned
    if (OP == kSum) {
      return static_cast<T>(static_cast<uint64_t>(a) +
                            static_cast<uint64_t>(b));
    }
    if (OP == kMax) return a < b ? b : a;
    return b < a ? b : a;
  } else {
    if (OP == kSum) return ftz(a + b);
    if (a != a || b != b) return a + b;  // NaN in, NaN out
    if (OP == kMax) {
      if (a > b) return a;
      if (b > a) return b;
      return signbit(a) ? b : a;  // equal: +0.0 wins
    }
    if (a < b) return a;
    if (b < a) return b;
    return signbit(a) ? a : b;  // equal: -0.0 wins
  }
}

// op(identity, v) == v bit for bit
template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if constexpr (std::is_integral<T>::value) {
    static_assert(sizeof(T) == 8, "the integer instantiation is int64");
    return OP == kMax ? T(INT64_MIN) : OP == kMin ? T(INT64_MAX) : T(0);
  } else {
    return OP == kMax ? T(-INFINITY) : OP == kMin ? T(INFINITY) : T(-0.0);
  }
}

// A span of sorted rows: the fold of its rows since the last segment
// start in it (all of them if there is none), and whether one starts.
template <typename T>
struct Seg {
  T v;
  int f;
};

template <typename T, int OP>
__device__ __forceinline__ Seg<T> seg_identity() {
  return Seg<T>{identity<T, OP>(), 0};
}

// a comes before b
template <typename T, int OP>
__device__ __forceinline__ Seg<T> seg_combine(Seg<T> a, Seg<T> b) {
  return Seg<T>{b.f ? b.v : combine<T, OP>(a.v, b.v), a.f | b.f};
}

// inclusive scan over the warp's lanes, in lane order
template <typename T, int OP>
__device__ __forceinline__ Seg<T> warp_scan(Seg<T> s, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    Seg<T> up;
    up.v = __shfl_up_sync(kFull, s.v, d);
    up.f = __shfl_up_sync(kFull, s.f, d);
    if (lane >= d) s = seg_combine<T, OP>(up, s);
  }
  return s;
}

// Each thread's exclusive prefix in thread order, after `carry` (the
// fold of everything before the block). Every thread of the block
// calls it once.
template <typename T, int OP>
__device__ __forceinline__ Seg<T> block_exclusive(Seg<T> mine, Seg<T> carry,
                                                  Seg<T>* s_warp) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const Seg<T> inc = warp_scan<T, OP>(mine, lane);
  if (lane == kWarp - 1) s_warp[warp] = inc;
  __syncthreads();
  Seg<T> pre = carry;
  for (int w = 0; w < warp; ++w) pre = seg_combine<T, OP>(pre, s_warp[w]);
  Seg<T> ex;
  ex.v = __shfl_up_sync(kFull, inc.v, 1);
  ex.f = __shfl_up_sync(kFull, inc.f, 1);
  if (lane > 0) pre = seg_combine<T, OP>(pre, ex);
  return pre;
}

// The sort key of a raw key: itself, or K for padding and keys >= K.
__device__ __forceinline__ uint32_t sort_key(int32_t k, int K) {
  return (k >= 0 && k < K) ? uint32_t(k) : uint32_t(K);
}

// Everything one call works on. Buffers that a phase writes are read by
// later phases of the same launch, so none of them is const or
// __restrict__ (the read-only cache is not kept coherent with writes).
template <typename T>
struct Args {
  const int32_t* keys;
  const T* vals;
  T* plane;
  T* emis;
  int* bad_keys;  // or null
  int B, K, passes, n_tiles;
  uint64_t* pairs_a;
  uint64_t* pairs_b;
  uint32_t* counts;  // [passes][n_tiles][kRadix]
  T* xs;             // seeded values, in sorted order
  T* agg_v;          // per tile
  int* agg_f;        // per tile
};

// Digit counts of one tile: counts[tile * kRadix + d]. The first pass
// reads the raw keys, and also counts the keys >= K into *bad_keys.
template <bool kFirst>
__device__ void hist_tile(const int32_t* keys, const uint64_t* pairs, int B,
                          int K, int shift, int tile, uint32_t* counts,
                          int* bad_keys) {
  __shared__ uint32_t s_cnt[kRadix];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const int base = tile * kTile + warp * kRun + lane;
  int bad = 0;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = base + u * kWarp;
    uint32_t d = kRadix;  // no row
    if (i < B) {
      uint32_t key;
      if (kFirst) {
        const int32_t k = __ldg(keys + i);
        bad += k >= K;
        key = sort_key(k, K);
      } else {
        key = uint32_t(pairs[i] >> 32);
      }
      d = (key >> shift) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < kRadix && lane == __ffs(peers) - 1) {
      atomicAdd(&s_cnt[d], uint32_t(__popc(peers)));
    }
  }
  __syncthreads();
  counts[tile * kRadix + threadIdx.x] = s_cnt[threadIdx.x];
  if (kFirst && bad_keys != nullptr) {
    bad = __reduce_add_sync(kFull, bad);
    if (lane == 0 && bad != 0) atomicAdd(bad_keys, bad);
  }
  __syncthreads();
}

// One stable counting-sort pass of a tile's pairs into pairs_out.
template <bool kFirst>
__device__ void scatter_tile(const int32_t* keys, const uint64_t* pairs_in,
                             int B, int K, int shift, int tile, int n_tiles,
                             const uint32_t* counts, uint64_t* pairs_out) {
  __shared__ uint32_t s_run[kWarps][kRadix];  // per warp and digit
  __shared__ uint32_t s_start[kRadix];
  __shared__ uint32_t s_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;

  // Where this tile's rows of digit `tid` go: after every row of a
  // smaller digit, and after this digit's rows in earlier tiles.
  uint32_t before = 0, total = 0;
#pragma unroll 32  // loads in flight: this loop is latency-bound
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t c = counts[t * kRadix + tid];
    total += c;
    before += t < tile ? c : 0u;
  }
  uint32_t inc = total;
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += up;
  }
  if (lane == kWarp - 1) s_sum[warp] = inc;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_run[w][tid] = 0;
  __syncthreads();
  uint32_t start = inc - total + before;
  for (int w = 0; w < warp; ++w) start += s_sum[w];
  s_start[tid] = start;

  // Each warp ranks the rows of its run among the rows of the same
  // digit before them in the run, 32 rows at a time in row order.
  const int base = tile * kTile + warp * kRun + lane;
  const unsigned lower = (1u << lane) - 1u;
  uint64_t pr[kItems];
  uint32_t dg[kItems], rank[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = base + u * kWarp;
    uint64_t p = 0;
    uint32_t d = kRadix;  // no row
    if (i < B) {
      if (kFirst) {
        p = (uint64_t(sort_key(__ldg(keys + i), K)) << 32) | uint32_t(i);
      } else {
        p = pairs_in[i];
      }
      d = uint32_t(p >> (32 + shift)) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(kFull, d);
    uint32_t r = 0;
    if (d < kRadix) r = s_run[warp][d] + __popc(peers & lower);
    __syncwarp();
    if (d < kRadix && lane == __ffs(peers) - 1) s_run[warp][d] += __popc(peers);
    __syncwarp();
    pr[u] = p;
    dg[u] = d;
    rank[u] = r;
  }
  __syncthreads();
  // per-warp counts -> each warp's start within the tile's digit
  uint32_t run = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_run[w][tid];
    s_run[w][tid] = run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (dg[u] < kRadix) {
      pairs_out[s_start[dg[u]] + s_run[warp][dg[u]] + rank[u]] = pr[u];
    }
  }
  __syncthreads();
}

// Seeded values of a tile's sorted rows into xs, and its aggregate.
template <typename T, int OP>
__device__ void reduce_tile(const Args<T>& a, const uint64_t* pairs,
                            int tile) {
  __shared__ Seg<T> s_warp[kWarps];
  const int B = a.B;
  const int first = tile * kTile + threadIdx.x * kItems;
  uint32_t prev = (first > 0 && first <= B) ? uint32_t(pairs[first - 1] >> 32)
                                            : kNoKey;
  Seg<T> acc = seg_identity<T, OP>();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = first + u;
    if (i < B) {
      const uint64_t p = pairs[i];
      const uint32_t key = uint32_t(p >> 32);
      const int head = key != prev;
      prev = key;
      T x = __ldg(a.vals + uint32_t(p));
      if (key < uint32_t(a.K)) {
        x = ftz(x);
        if (head) x = combine<T, OP>(ftz(a.plane[key]), x);
      }
      a.xs[i] = x;
      acc = seg_combine<T, OP>(acc, Seg<T>{x, head});
    }
  }
  const Seg<T> ex = block_exclusive<T, OP>(acc, seg_identity<T, OP>(), s_warp);
  if (threadIdx.x == kThreads - 1) {
    const Seg<T> tot = seg_combine<T, OP>(ex, acc);
    a.agg_v[tile] = tot.v;
    a.agg_f[tile] = tot.f;
  }
  __syncthreads();
}

// The running values of a tile's sorted rows: emis[row], and plane[key]
// at each segment's last row.
template <typename T, int OP>
__device__ void apply_tile(const Args<T>& a, const uint64_t* pairs,
                           int tile) {
  __shared__ Seg<T> s_warp[kWarps];
  __shared__ Seg<T> s_carry;
  const int lane = threadIdx.x & (kWarp - 1);
  const int B = a.B;

  // the fold of every earlier tile, in tile order, 32 tiles at a time
  if (threadIdx.x < kWarp) {
    Seg<T> carry = seg_identity<T, OP>();
    for (int t0 = 0; t0 < tile; t0 += kWarp) {
      Seg<T> g = seg_identity<T, OP>();
      if (t0 + lane < tile) {
        g.v = a.agg_v[t0 + lane];
        g.f = a.agg_f[t0 + lane];
      }
      g = warp_scan<T, OP>(g, lane);
      Seg<T> all;
      all.v = __shfl_sync(kFull, g.v, kWarp - 1);
      all.f = __shfl_sync(kFull, g.f, kWarp - 1);
      carry = seg_combine<T, OP>(carry, all);
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();

  const int first = tile * kTile + threadIdx.x * kItems;
  uint32_t prev = (first > 0 && first <= B) ? uint32_t(pairs[first - 1] >> 32)
                                            : kNoKey;
  uint32_t key[kItems], row[kItems];
  T x[kItems];
  int head[kItems];
  Seg<T> acc = seg_identity<T, OP>();
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = first + u;
    key[u] = kNoKey;
    row[u] = 0;
    x[u] = identity<T, OP>();
    head[u] = 1;
    if (i < B) {
      const uint64_t p = pairs[i];
      key[u] = uint32_t(p >> 32);
      row[u] = uint32_t(p);
      x[u] = a.xs[i];
      head[u] = key[u] != prev;
      prev = key[u];
      acc = seg_combine<T, OP>(acc, Seg<T>{x[u], head[u]});
    }
  }
  const uint32_t after = first + kItems < B
                             ? uint32_t(pairs[first + kItems] >> 32)
                             : kNoKey;
  Seg<T> run = block_exclusive<T, OP>(acc, s_carry, s_warp);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    if (first + u < B) {
      run = seg_combine<T, OP>(run, Seg<T>{x[u], head[u]});
      if (key[u] < uint32_t(a.K)) {
        a.emis[row[u]] = run.v;
        const uint32_t next = u + 1 < kItems ? key[u + 1] : after;
        if (next != key[u]) a.plane[key[u]] = run.v;
      } else {
        // padding or out of range: its own value, as it was read
        a.emis[row[u]] = __ldg(a.vals + row[u]);
      }
    }
  }
  __syncthreads();
}

// The whole call in one cooperative launch: every block walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of each phase, and the grid
// waits at a barrier between phases. No block leaves before the last
// barrier.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
seq_rolling_kernel(Args<T> a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const uint64_t* src = nullptr;
  uint64_t* dst = a.pairs_a;
  for (int p = 0; p < a.passes; ++p) {
    const int shift = p * kDigitBits;
    uint32_t* cnt = a.counts + size_t(p) * a.n_tiles * kRadix;
    for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      if (p == 0) {
        hist_tile<true>(a.keys, nullptr, a.B, a.K, shift, t, cnt, a.bad_keys);
      } else {
        hist_tile<false>(nullptr, src, a.B, a.K, shift, t, cnt, nullptr);
      }
    }
    grid.sync();
    for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
      if (p == 0) {
        scatter_tile<true>(a.keys, nullptr, a.B, a.K, shift, t, a.n_tiles,
                           cnt, dst);
      } else {
        scatter_tile<false>(nullptr, src, a.B, a.K, shift, t, a.n_tiles,
                            cnt, dst);
      }
    }
    grid.sync();
    src = dst;
    dst = dst == a.pairs_a ? a.pairs_b : a.pairs_a;
  }
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    reduce_tile<T, OP>(a, src, t);
  }
  grid.sync();
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    apply_tile<T, OP>(a, src, t);
  }
}

// Blocks of seq_rolling_kernel<T, OP> that fit on the current device at
// once (a cooperative launch needs them all resident), found once per
// device.
template <typename T, int OP>
cudaError_t resident_blocks(int* out) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *out = cached[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seq_rolling_kernel<T, OP>, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) cached[dev] = per_sm * sms;
  *out = per_sm * sms;
  return cudaSuccess;
}

template <typename T, int OP>
cudaError_t launch_op(Args<T> a, cudaStream_t s) {
  int resident = 0;
  const cudaError_t err = resident_blocks<T, OP>(&resident);
  if (err != cudaSuccess) return err;
  const int grid = a.n_tiles < resident ? a.n_tiles : resident;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(seq_rolling_kernel<T, OP>), dim3(grid),
      dim3(kThreads), params, 0, s);
}

template <typename T>
cudaError_t launch_typed(int op, Args<T> a, cudaStream_t s) {
  switch (op) {
    case kMax:
      return launch_op<T, kMax>(a, s);
    case kMin:
      return launch_op<T, kMin>(a, s);
    case kSum:
      return launch_op<T, kSum>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* keys, const void* vals, void* plane, void* emis,
                  void* bad_keys, int B, int K, int passes, void* pairs_a,
                  void* pairs_b, void* counts, void* xs, void* agg_v,
                  void* agg_f) {
  Args<T> a;
  a.keys = static_cast<const int32_t*>(keys);
  a.vals = static_cast<const T*>(vals);
  a.plane = static_cast<T*>(plane);
  a.emis = static_cast<T*>(emis);
  a.bad_keys = static_cast<int*>(bad_keys);
  a.B = B;
  a.K = K;
  a.passes = passes;
  a.n_tiles = (B + kTile - 1) / kTile;
  a.pairs_a = static_cast<uint64_t*>(pairs_a);
  a.pairs_b = static_cast<uint64_t*>(pairs_b);
  a.counts = static_cast<uint32_t*>(counts);
  a.xs = static_cast<T*>(xs);
  a.agg_v = static_cast<T*>(agg_v);
  a.agg_f = static_cast<int*>(agg_f);
  return a;
}

}  // namespace

// The layout the caller sizes its scratch by (ops/seq_rolling.py
// checks both against its own once, when it binds the library).
extern "C" int seq_rolling_tile_rows() { return kTile; }
extern "C" int seq_rolling_digit_bits() { return kDigitBits; }

// Plain C entry point, bound with ctypes. dtype: 0 = float32,
// 1 = float64, 2 = int64; op: 0 = max, 1 = min, 2 = sum. bad_keys (one int32, or
// null) gains the number of rows whose key is >= K. passes: radix
// passes, enough that K < 2^(8 * passes). Scratch, from the caller:
// pairs_a and pairs_b hold B uint64 each, counts passes * n_tiles * 256
// uint32, xs B values, agg_v n_tiles values and agg_f n_tiles int32,
// with n_tiles = ceil(B / 1024). Makes one cooperative launch on
// `stream` and returns its cudaError_t.
extern "C" int seq_rolling_reduce_launch(
    int dtype, int op, const void* keys, const void* vals, void* plane,
    void* emis, void* bad_keys, int B, int K, int passes, void* pairs_a,
    void* pairs_b, void* counts, void* xs, void* agg_v, void* agg_f,
    void* stream) {
  if (B < 0 || K < 0 || passes < 1 || kDigitBits * passes > 32 ||
      (kDigitBits * passes < 32 &&
       (int64_t(K) >> (kDigitBits * passes)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_typed<float>(
        op, make_args<float>(keys, vals, plane, emis, bad_keys, B, K, passes,
                             pairs_a, pairs_b, counts, xs, agg_v, agg_f),
        s);
  } else if (dtype == 1) {
    err = launch_typed<double>(
        op, make_args<double>(keys, vals, plane, emis, bad_keys, B, K,
                              passes, pairs_a, pairs_b, counts, xs, agg_v,
                              agg_f),
        s);
  } else if (dtype == 2) {
    err = launch_typed<int64_t>(
        op, make_args<int64_t>(keys, vals, plane, emis, bad_keys, B, K,
                               passes, pairs_a, pairs_b, counts, xs, agg_v,
                               agg_f),
        s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
