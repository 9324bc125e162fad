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
// pallas_onehot_reduce), on the design's copy (kernels/colsort.py): every
// valid slot of the ELL as one entry (global column, row, value), sorted
// stably by column, so a column's entries are one run with its rows in
// order; padded at the tail (column d) to whole tiles of kTile entries.
// Values are f64, f32 or bf16 (widened to f32), a is the compute type A.
//
// Every column is written once, with no atomics, by sums in a fixed order,
// so the outputs have the same bits from call to call:
//   1. the caller's stream clears the outputs (columns no entry names stay
//      0);
//   2. a block per tile: each thread loads 4 entries (16-byte loads of
//      columns and rows, 8, 16 or 32 bytes of values), gathers a[row]
//      through the read-only path, forms its updates, and sums each run of
//      equal columns by a segmented inclusive scan: in order over its 4
//      entries, then across the warp by shuffles, then across the 8 warps
//      in warp order through shared memory. A run inside the tile has one
//      writer and goes straight to the output. The tile's first run, where
//      it continues the previous tile's last column, goes to edge[2t]; its
//      last run, where the next tile continues it (and it is not also the
//      first), to edge[2t + 1]; edges are f64;
//   3. a warp per column whose run crosses a tile edge (a line of `chains`:
//      column, first tile, last tile; built with the copy) adds edge[2
//      first + 1] and edge[2t] of the tiles after it, in tile order per
//      lane and then a fixed shuffle tree, in f64, and writes the column
//      once.
// Bound on Hopper: HBM bytes, the copy read once (4 + 4 + sizeof(V) per
// entry), a (n,) read and the (d,) output(s) written; the a[row] gathers
// hit a (n,) vector that is L2-resident up to n = 2^22 in f64 and are in
// row order within a column.

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

static_assert(kPer == 4, "one 16-byte load of columns and of rows per thread");

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

// What the reduce takes: the copy (cols, rows, vals: ntiles * kTile
// entries; chains: nchains lines of (column, first tile, last tile)), the
// (n,) vector a, the (d,) output(s) and 2 * ntiles * N doubles of scratch.
template <typename V, typename A>
struct ReduceArgs {
  const int32_t* cols;
  const int32_t* rows;
  const V* vals;
  const int32_t* chains;
  const A* a;
  A* out0;
  A* out1;
  double* edge;
  long long ntiles;
  long long nchains;
  int d;
};

template <typename V, typename A, int MODE>
__global__ void __launch_bounds__(kThreads)
colsort_reduce_tiles_kernel(ReduceArgs<V, A> p) {
  using S = typename Sums<A, MODE>::S;
  constexpr int N = Sums<A, MODE>::kN;
  using Span = Seg<S, N>;
  __shared__ Span warp_sum[kWarps];
  const long long t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = t * kTile;
  const long long s = base + kPer * tid;
  const int4 c4 = __ldcs(reinterpret_cast<const int4*>(p.cols + s));
  const int4 r4 = __ldcs(reinterpret_cast<const int4*>(p.rows + s));
  A v[kPer];
  load_cs<kPer>(p.vals + s, v);
  const int32_t c[kPer] = {c4.x, c4.y, c4.z, c4.w};
  const int32_t r[kPer] = {r4.x, r4.y, r4.z, r4.w};
  const unsigned d = (unsigned)p.d;
  // the updates; a padding entry (column d) adds nothing and reads no row
  S u[kPer][N];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const A aj = (unsigned)c[j] < d ? __ldg(p.a + r[j]) : A(0);
    if constexpr (MODE == kLinear) {
      u[j][0] = v[j] * aj;
    } else if constexpr (MODE == kSquare) {
      u[j][0] = v[j] * v[j] * aj;
    } else {
      u[j][0] = (S)(v[j] * v[j] * aj);
      u[j][1] = (S)(v[j] * aj);
    }
  }
  // the tile's first and last columns, and whether its neighbours continue
  // them (never the padding)
  const int32_t first = __ldg(p.cols + base), last = __ldg(p.cols + base + kTile - 1);
  const bool left_open = (unsigned)first < d && t > 0 && __ldg(p.cols + base - 1) == first;
  const bool right_open = (unsigned)last < d && t + 1 < p.ntiles &&
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
      p.out0[c[j]] = (A)sum[0];
      if constexpr (N == 2) {
        p.out1[c[j]] = (A)sum[1];
      }
    }
  }
}

template <typename V, typename A, int MODE>
__global__ void __launch_bounds__(kThreads)
colsort_reduce_chains_kernel(ReduceArgs<V, A> p) {
  constexpr int N = Sums<A, MODE>::kN;
  const long long chain = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= p.nchains) {
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
    p.out0[col] = (A)acc[0];
    if constexpr (N == 2) {
      p.out1[col] = (A)acc[1];
    }
  }
}

// The reduce on the caller's stream: the output(s) cleared, the tiles,
// then the chains. Returns the first CUDA error.
template <typename V, typename A, int MODE>
int launch_reduce(const ReduceArgs<V, A>& p, cudaStream_t s) {
  int code = (int)cudaMemsetAsync(p.out0, 0, (size_t)p.d * sizeof(A), s);
  if (code == 0 && MODE == kPair) {
    code = (int)cudaMemsetAsync(p.out1, 0, (size_t)p.d * sizeof(A), s);
  }
  if (code != 0 || p.ntiles == 0) {
    return code;
  }
  colsort_reduce_tiles_kernel<V, A, MODE><<<(unsigned)p.ntiles, kThreads, 0, s>>>(p);
  code = (int)cudaGetLastError();
  if (code != 0 || p.nchains == 0) {
    return code;
  }
  colsort_reduce_chains_kernel<V, A, MODE>
      <<<(unsigned)((p.nchains + kWarps - 1) / kWarps), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace colsort
}  // namespace photon
