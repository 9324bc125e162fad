// The deterministic X^T side of the fused passes, ell_rmatvec and
// ell_colsum: a segmented column reduce over a design's column-sorted
// copy, with the row gather inside.
//
//   mode kLinear: g_j  = sum over the entries e of column j of v_e a[row_e]
//   mode kSquare: g_j  = sum v_e^2 a[row_e]
//   mode kPair:   g2_j = sum v_e^2 a[row_e], g1_j = sum v_e a[row_e]
//                 (fused_hdiag: each entry squared on its own, both sums
//                 f64 in every compute type, each rounded once)
//
// Replaces the X^T side of photon_ml_tpu/kernels/fused.py's three Pallas
// passes and the scatter of kernels/ell.py::ell_scatter_add under
// ell_rmatvec and ell_colsum. Its scheme is that of the lab's
// onehot_reduce (lab.cu, the port of benchmarks/sparse_kernel_lab.py::
// pallas_onehot_reduce), on the design's copy (kernels/colsort.py): the
// ELL cut into blocks of ROW_BLOCK rows; in each block every valid slot as
// one entry (global column, slot counted from the block's first slot,
// value), sorted stably by column, so a column's entries in a block are
// one run with its rows in order; each block padded at its tail (column
// d) to whole tiles of kTile entries. An entry's row is the block's first
// row + slot / k. Values are f64, f32 or bf16 (widened to f32), a is the
// compute type A.
//
// What bounds it on Hopper: memory traffic. The copy streams once (4 + 4 +
// sizeof(V) bytes an entry, evict-first loads); each entry also gathers
// a[row], 8 or 4 bytes at a row far from the last one (within a column,
// rows are about n / (entries per column) apart), so a gather that misses
// the L2 costs a whole 32-byte sector of HBM. Over all n rows at once, a
// is too large to stay in the 50 MB L2 (two partitions) while gigabytes
// of copy stream through it: at n = 2^22 in f64 (a 32 MB vector) the
// gathers' sectors were about twice the copy's own bytes. The row blocks
// bound the window: the blocks run in order, so one block's gathers fall
// in ROW_BLOCK rows of a (16 MB of f64 at 2^21), which stay in L2 while
// the block's entries stream past, and a is read from HBM about once. What
// is left bounds it on the L2: each gather still moves a 32-byte sector
// from L2 to the SM for 8 or 4 bytes. An f64 pass at n = 2^22 (1.6e8
// entries) moves 5.2 GB of gathered sectors and 2.6 GB of copy through
// the L2, and took 1.6 ms on an H100 SXM (about 4.8 TB/s). What the blocks
// cost: a launch of tiles and one of chains each, each block's tile
// padding, and a second read and write of every column a later block
// names; where a already stays in L2 (an f32 a of 16 MB) they cost more
// than they save. A design of at most ROW_BLOCK rows is one block, whose
// launches and bits are those of the single sort.
//
// Every column is written once per launch, with no atomics, by sums in a
// fixed order, so the outputs have the same bits from call to call:
//   1. the caller's stream clears the outputs (columns no entry names stay
//      0);
//   2. per block, in block order, a block of threads per tile: each thread
//      loads 4 entries (16-byte loads of columns and slots, 8, 16 or 32
//      bytes of values), gathers a[row] through the read-only path, forms
//      its updates, and sums each run of equal columns by a segmented
//      inclusive scan: in order over its 4 entries, then across the warp
//      by shuffles, then across the 8 warps in warp order through shared
//      memory. A run inside the tile has one writer and goes straight to
//      the output. The tile's first run, where it continues the previous
//      tile's last column in the same block, goes to edge[2t]; its last
//      run, where the next tile continues it (and it is not also the
//      first), to edge[2t + 1]; edges are f64;
//   3. then a warp per column whose run crosses a tile edge in that block
//      (a line of `chains`: column, first tile, last tile; built with the
//      copy) adds edge[2 first + 1] and edge[2t] of the tiles after it, in
//      tile order per lane and then a fixed shuffle tree, in f64, and
//      writes the column once;
//   4. the first block stores each column's sum, each later block adds
//      its sum to it. kPair in an f32 compute type over several blocks
//      keeps the sums in (2, d) f64 scratch and rounds each column once in
//      a last narrowing pass.

#pragma once

#include <type_traits>

#include "ell_common.cuh"

namespace photon {
namespace colsort {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // entries per tile
constexpr int kPer = kTile / kThreads;  // entries per thread: 4
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPer == 4, "one 16-byte load of columns and of slots per thread");

enum Mode { kLinear = 0, kSquare = 1, kPair = 2 };

// The sums a mode carries per entry, and their type: kPair two in f64,
// the others one in the compute type A.
template <typename A, int MODE>
struct Sums {
  static constexpr int kN = MODE == kPair ? 2 : 1;
  using S = typename std::conditional<MODE == kPair, double, A>::type;
};

// A span of a segmented sum: the sums since the span's last run start (or
// over the whole span, if no run starts in it), and whether one starts.
template <typename S, int N>
struct Seg {
  S v[N];
  int head;
};

// a, then b
template <typename S, int N>
__device__ __forceinline__ Seg<S, N> combine(const Seg<S, N>& a, const Seg<S, N>& b) {
  Seg<S, N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out.v[i] = b.head ? b.v[i] : a.v[i] + b.v[i];
  }
  out.head = a.head | b.head;
  return out;
}

template <typename S, int N>
__device__ __forceinline__ Seg<S, N> shfl_up(const Seg<S, N>& x, int off) {
  Seg<S, N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out.v[i] = __shfl_up_sync(kFull, x.v[i], off);
  }
  out.head = __shfl_up_sync(kFull, x.head, off);
  return out;
}

// A line of the copy's block table (kernels/colsort.py BLOCK_FIELDS): first
// row, first tile, end tile, first chain, end chain, then two fields the
// reduce does not read.
constexpr int kBlockFields = 7;

// What the reduce takes: the copy (cols, slots, vals: ntiles * kTile
// entries; chains: nchains lines of (column, first tile, last tile); the
// block table on the host), the (n,) vector a, the (d,) output(s) and
// 2 * ntiles * N doubles of edge scratch, followed for wide sums (kPair
// over several blocks in f32) by 2 * d doubles.
template <typename V, typename A>
struct Reduce {
  const int32_t* cols;
  const int32_t* slots;
  const V* vals;
  const int32_t* chains;
  const long long* blocks;
  long long nblocks;
  const A* a;
  A* out0;
  A* out1;
  double* scratch;
  int k;
  int d;
};

// One block's launch: its tiles and chains (global indices), a from the
// block's first row, and whether it adds to the sums of the blocks before.
template <typename V, typename A>
struct ReduceArgs {
  const int32_t* cols;
  const int32_t* slots;
  const V* vals;
  const int32_t* chains;
  const A* a;
  A* out0;
  A* out1;
  double* edge;
  double* wide0;  // the f64 sums of wide kPair, else null
  double* wide1;
  long long tile_begin;
  long long tile_end;
  long long chain_begin;
  long long chain_end;
  int k;
  int d;
  int add;
};

// Write one column's sum: stored by the first block, added by the others.
template <typename V, typename A, int N, typename S>
__device__ __forceinline__ void put(const ReduceArgs<V, A>& p, long long col,
                                    const S (&sum)[N]) {
  if constexpr (N == 2 && !std::is_same<A, double>::value) {
    if (p.wide0 != nullptr) {
      p.wide0[col] = p.add ? p.wide0[col] + (double)sum[0] : (double)sum[0];
      p.wide1[col] = p.add ? p.wide1[col] + (double)sum[1] : (double)sum[1];
      return;
    }
  }
  p.out0[col] = p.add ? p.out0[col] + (A)sum[0] : (A)sum[0];
  if constexpr (N == 2) {
    p.out1[col] = p.add ? p.out1[col] + (A)sum[1] : (A)sum[1];
  }
}

template <typename V, typename A, int MODE>
__global__ void __launch_bounds__(kThreads)
colsort_reduce_tiles_kernel(ReduceArgs<V, A> p) {
  using S = typename Sums<A, MODE>::S;
  constexpr int N = Sums<A, MODE>::kN;
  using Span = Seg<S, N>;
  __shared__ Span warp_sum[kWarps];
  const long long t = p.tile_begin + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = t * kTile;
  const long long s = base + kPer * tid;
  const int4 c4 = __ldcs(reinterpret_cast<const int4*>(p.cols + s));
  const int4 l4 = __ldcs(reinterpret_cast<const int4*>(p.slots + s));
  A v[kPer];
  load_cs<kPer>(p.vals + s, v);
  const int32_t c[kPer] = {c4.x, c4.y, c4.z, c4.w};
  const unsigned slot[kPer] = {(unsigned)l4.x, (unsigned)l4.y, (unsigned)l4.z,
                               (unsigned)l4.w};
  const unsigned d = (unsigned)p.d;
  const unsigned k = (unsigned)p.k;
  // the updates; a padding entry (column d) adds nothing and reads no row
  S u[kPer][N];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const A aj = (unsigned)c[j] < d ? __ldg(p.a + slot[j] / k) : A(0);
    if constexpr (MODE == kLinear) {
      u[j][0] = v[j] * aj;
    } else if constexpr (MODE == kSquare) {
      u[j][0] = v[j] * v[j] * aj;
    } else {
      u[j][0] = (S)(v[j] * v[j] * aj);
      u[j][1] = (S)(v[j] * aj);
    }
  }
  // the tile's first and last columns, and whether its neighbours in the
  // block continue them (never the padding)
  const int32_t first = __ldg(p.cols + base), last = __ldg(p.cols + base + kTile - 1);
  const bool left_open =
      (unsigned)first < d && t > p.tile_begin && __ldg(p.cols + base - 1) == first;
  const bool right_open = (unsigned)last < d && t + 1 < p.tile_end &&
                          __ldg(p.cols + base + kTile) == last;
  // the columns just before and just after this thread's 4 entries
  int32_t prev = __shfl_up_sync(kFull, c[kPer - 1], 1);
  int32_t next = __shfl_down_sync(kFull, c[0], 1);
  if (lane == 0 && tid > 0) {
    prev = __ldg(p.cols + s - 1);
  }
  if (lane == 31 && tid < kThreads - 1) {
    next = __ldg(p.cols + s + kPer);
  }
  bool head[kPer], end[kPer];
  head[0] = tid == 0 || prev != c[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j) {
    head[j] = c[j] != c[j - 1];
    end[j - 1] = head[j];
  }
  end[kPer - 1] = tid == kThreads - 1 || next != c[kPer - 1];
  // segmented inclusive sums of the thread's entries, in order
  S acc[kPer][N];
  bool started[kPer];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[0][i] = u[0][i];
  }
  started[0] = head[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc[j][i] = head[j] ? u[j][i] : acc[j - 1][i] + u[j][i];
    }
    started[j] = started[j - 1] || head[j];
  }
  // across the warp: inclusive scan of the threads' spans
  Span inc;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    inc.v[i] = acc[kPer - 1][i];
  }
  inc.head = started[kPer - 1] ? 1 : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Span o = shfl_up(inc, off);
    if (lane >= off) {
      inc = combine(o, inc);
    }
  }
  Span before = shfl_up(inc, 1);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      before.v[i] = S(0);
    }
    before.head = 0;
  }
  if (lane == 31) {
    warp_sum[warp] = inc;
  }
  __syncthreads();
  // across the warps, in warp order
  Span prefix;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    prefix.v[i] = S(0);
  }
  prefix.head = 0;
  for (int w = 0; w < warp; ++w) {
    prefix = combine(prefix, warp_sum[w]);
  }
  prefix = combine(prefix, before);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!end[j] || (unsigned)c[j] >= d) {
      continue;
    }
    // the run that ends here: within the tile it is its column's only
    // run (the copy is sorted), so its column says whether it is the
    // tile's first or last run
    S sum[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sum[i] = started[j] ? acc[j][i] : prefix.v[i] + acc[j][i];
    }
    if (left_open && c[j] == first) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        p.edge[(2 * t) * N + i] = (double)sum[i];
      }
    } else if (right_open && c[j] == last) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        p.edge[(2 * t + 1) * N + i] = (double)sum[i];
      }
    } else {
      put(p, c[j], sum);
    }
  }
}

template <typename V, typename A, int MODE>
__global__ void __launch_bounds__(kThreads)
colsort_reduce_chains_kernel(ReduceArgs<V, A> p) {
  constexpr int N = Sums<A, MODE>::kN;
  const long long chain = p.chain_begin + (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= p.chain_end) {
    return;
  }
  const long long col = __ldg(p.chains + 3 * chain);
  const long long first = __ldg(p.chains + 3 * chain + 1);
  const long long last = __ldg(p.chains + 3 * chain + 2);
  double acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = lane == 0 ? __ldg(p.edge + (2 * first + 1) * N + i) : 0.0;
  }
  for (long long t = first + 1 + lane; t <= last; t += 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc[i] += __ldg(p.edge + (2 * t) * N + i);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
  }
  if (lane == 0) {
    put(p, col, acc);
  }
}

// wide kPair's last pass: each column's f64 sums rounded once
template <typename A>
__global__ void __launch_bounds__(kThreads)
colsort_narrow_kernel(const double* wide0, const double* wide1, A* out0, A* out1, int d) {
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < d;
       j += (long long)gridDim.x * kThreads) {
    out0[j] = (A)wide0[j];
    out1[j] = (A)wide1[j];
  }
}

// The reduce on the caller's stream: the output(s) (or wide sums) cleared,
// each block's tiles then chains in block order, then for wide sums the
// narrowing pass. Returns the first CUDA error.
template <typename V, typename A, int MODE>
int launch_reduce(const Reduce<V, A>& r, cudaStream_t s) {
  constexpr int N = Sums<A, MODE>::kN;
  const long long ntiles = r.nblocks > 0 ? r.blocks[(r.nblocks - 1) * kBlockFields + 2] : 0;
  const bool wide = MODE == kPair && !std::is_same<A, double>::value && r.nblocks > 1;
  double* wide0 = wide ? r.scratch + 2 * ntiles * N : nullptr;
  double* wide1 = wide ? wide0 + r.d : nullptr;
  int code;
  if (wide) {
    code = (int)cudaMemsetAsync(wide0, 0, 2 * (size_t)r.d * sizeof(double), s);
  } else {
    code = (int)cudaMemsetAsync(r.out0, 0, (size_t)r.d * sizeof(A), s);
    if (code == 0 && MODE == kPair) {
      code = (int)cudaMemsetAsync(r.out1, 0, (size_t)r.d * sizeof(A), s);
    }
  }
  for (long long b = 0; code == 0 && b < r.nblocks; ++b) {
    const long long* line = r.blocks + b * kBlockFields;
    const ReduceArgs<V, A> p{r.cols,   r.slots, r.vals,  r.chains,  r.a + line[0],
                             r.out0,   r.out1,  r.scratch, wide0,   wide1,
                             line[1],  line[2], line[3], line[4],   r.k,
                             r.d,      b > 0 ? 1 : 0};
    if (p.tile_end > p.tile_begin) {
      colsort_reduce_tiles_kernel<V, A, MODE>
          <<<(unsigned)(p.tile_end - p.tile_begin), kThreads, 0, s>>>(p);
      code = (int)cudaGetLastError();
    }
    if (code == 0 && p.chain_end > p.chain_begin) {
      colsort_reduce_chains_kernel<V, A, MODE>
          <<<(unsigned)((p.chain_end - p.chain_begin + kWarps - 1) / kWarps), kThreads, 0, s>>>(
              p);
      code = (int)cudaGetLastError();
    }
  }
  if (code == 0 && wide) {
    const unsigned grid = (unsigned)((r.d + kThreads - 1) / kThreads);
    colsort_narrow_kernel<A><<<grid < 1024u ? grid : 1024u, kThreads, 0, s>>>(
        wide0, wide1, r.out0, r.out1, r.d);
    code = (int)cudaGetLastError();
  }
  return code;
}

}  // namespace colsort
}  // namespace photon
