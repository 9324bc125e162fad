// The sparse kernel lab's three kernels, over the lab's layouts.
//
// Replaces the Pallas kernels of benchmarks/sparse_kernel_lab.py:
//   lane_gather    pallas_lane_gather   (body lane_gather_kernel)
//   onehot_gather  pallas_onehot_gather (body onehot_gather_kernel)
//   onehot_reduce  pallas_onehot_reduce (body onehot_reduce_kernel)
// The TPU kernels gather and reduce by column with one-hot products on the
// MXU, a TPU way to gather that Hopper has no use for: these kernels
// compute the same functions with plain loads, shared memory and warp
// sums. All data is float32, ids int32, as in the lab.
//
// lane_gather: out[r, j] = tbl[r, idx[r, j]] over (R, 128) tables, with
// take_along_axis's contract (an id in [-128, 0) counts from the row's end,
// any other id outside [0, 128) reads NaN). Bound: bytes, three (R, 128)
// arrays of 4 bytes; at the lab's 8192 rows that is 12 MiB, a few
// microseconds, so the launch shows. Design: a warp per row; each lane
// loads 4 floats and 4 ids with 16-byte loads, the row goes to the warp's
// 512 bytes of shared memory, and each lane gathers its 4 entries there.
//
// The column-sorted tiles (kernels/lab.py::column_sorted_tiles): entries
// sorted stably by column, 512 columns to a block, each block padded to
// whole tiles of 1024 entries; cols holds the column within the tile's
// block, 512 (the miss) in a padding slot; tile_block[t] is tile t's
// block. Within a block a column is one run of entries.
//
// onehot_gather: e[t, i] = vals[t, i] * w[tile_block[t] * 512 + cols[t, i]]
// (w read as 0 past d and at a miss). Bound: bytes, 12 per padded entry
// (cols and vals read, e written) and w once. Design: a block per tile,
// never per column block (Zipf data puts half the lab's tiles in block 0):
// the tile's 2 KB of w go to shared memory with coalesced loads, then
// each thread takes 4 entries with 16-byte loads and gathers from there.
// e is one product per entry, so it has the plain version's bits.
//
// onehot_reduce: g[b * 512 + c] = sum of upd[t, i] over the tiles t of
// block b and the entries i with cols[t, i] = c. Bound: bytes, 8 per
// padded entry (cols and upd read) and g written once. The TPU kernel
// carries a block's sums across its sequential grid; Hopper's blocks run
// in parallel and in no order, and a block per column block would again
// put half the work on one SM. Design, with no global atomics and every
// sum in a fixed order, so g has the same bits from call to call:
//   1. the caller's stream clears g (cudaMemsetAsync): blocks with no
//      tiles and columns no entry names stay 0;
//   2. a block per tile loads 4 entries per thread (16-byte loads) and
//      sums each run of equal columns with a segmented inclusive scan:
//      in each thread's 4 entries, then across the warp by shuffles, then
//      across the 8 warps through shared memory. A run that lies inside
//      the tile has one writer and goes straight to g. The tile's first
//      run, where it continues the previous tile's last column, goes to
//      edge[2t]; its last run, where the next tile continues it (and it
//      is not also the first), to edge[2t + 1];
//   3. a warp per crossing column (a line of `chains`: global column,
//      first tile, last tile; built with the layout) adds edge[2 first +
//      1] and edge[2 t] for the tiles after it, in tile order per lane
//      and then a fixed shuffle tree, in double, and writes the column
//      once. The Zipf head column of the lab's default shape crosses
//      about 594 tiles.
// Nothing is allocated here; the launches go on the caller's stream and do
// not synchronise. Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // lane_gather's row width
constexpr int kBlockCols = 512;  // columns per block; also the miss
constexpr int kTile = 1024;  // entries per tile
constexpr int kPer = kTile / kThreads;  // entries per thread: 4
constexpr unsigned kFull = 0xffffffffu;

static_assert(kPer == 4, "one 16-byte load of ids and of values per thread");

// -- lane_gather --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ idx,
                   float* __restrict__ out, long long rows) {
  __shared__ __align__(16) float row[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + warp;
  if (r >= rows) {
    return;
  }
  const long long base = r * kLanes + 4 * lane;
  const float4 t = __ldcs(reinterpret_cast<const float4*>(tbl + base));
  const int4 c = __ldcs(reinterpret_cast<const int4*>(idx + base));
  *reinterpret_cast<float4*>(&row[warp][4 * lane]) = t;
  __syncwarp();
  const int ids[4] = {c.x, c.y, c.z, c.w};
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int id = ids[j] < 0 ? ids[j] + kLanes : ids[j];
    // NaN with PyTorch's and JAX's bits (0x7fc00000)
    v[j] = (unsigned)id < (unsigned)kLanes ? row[warp][id] : __int_as_float(0x7fc00000);
  }
  __stcs(reinterpret_cast<float4*>(out + base), make_float4(v[0], v[1], v[2], v[3]));
}

// -- onehot_gather ------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                     const int32_t* __restrict__ tile_block, const float* __restrict__ w,
                     float* __restrict__ e, int d) {
  __shared__ float wb[kBlockCols];
  const long long base = (long long)blockIdx.x * kTile + kPer * threadIdx.x;
  // the entries' loads are in flight while the block's w is staged
  const int4 c = __ldcs(reinterpret_cast<const int4*>(cols + base));
  const float4 v = __ldcs(reinterpret_cast<const float4*>(vals + base));
  const long long w0 = (long long)__ldg(tile_block + blockIdx.x) * kBlockCols;
  for (int i = threadIdx.x; i < kBlockCols; i += kThreads) {
    wb[i] = w0 + i < d ? __ldg(w + w0 + i) : 0.0f;
  }
  __syncthreads();
  // a miss, or any id outside the block, reads 0
  const auto at = [&](int32_t col) {
    return (unsigned)col < (unsigned)kBlockCols ? wb[col] : 0.0f;
  };
  __stcs(reinterpret_cast<float4*>(e + base),
         make_float4(v.x * at(c.x), v.y * at(c.y), v.z * at(c.z), v.w * at(c.w)));
}

// -- onehot_reduce ------------------------------------------------------------

// A span of a segmented sum: the sum since the span's last run start (or
// over the whole span, if no run starts in it), and whether one starts.
struct Seg {
  float v;
  int head;
};

// a, then b
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return {b.head ? b.v : a.v + b.v, a.head | b.head};
}

__global__ void __launch_bounds__(kThreads)
onehot_reduce_tiles_kernel(const int32_t* __restrict__ cols, const float* __restrict__ upd,
                           const int32_t* __restrict__ tile_block, float* __restrict__ g,
                           float* __restrict__ edge, long long ntiles) {
  __shared__ Seg warp_sum[kWarps];
  const long long t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = t * kTile;
  const long long s = base + kPer * tid;
  const int4 c4 = __ldcs(reinterpret_cast<const int4*>(cols + s));
  const float4 u4 = __ldcs(reinterpret_cast<const float4*>(upd + s));
  const int32_t c[kPer] = {c4.x, c4.y, c4.z, c4.w};
  const float u[kPer] = {u4.x, u4.y, u4.z, u4.w};
  const int32_t b = __ldg(tile_block + t);
  // the tile's first and last columns, and whether its neighbours in the
  // same block continue them (never the miss)
  const int32_t first = __ldg(cols + base), last = __ldg(cols + base + kTile - 1);
  const bool left_open = first != kBlockCols && t > 0 && __ldg(tile_block + t - 1) == b
                         && __ldg(cols + base - 1) == first;
  const bool right_open = last != kBlockCols && t + 1 < ntiles
                          && __ldg(tile_block + t + 1) == b
                          && __ldg(cols + base + kTile) == last;
  // the columns just before and just after this thread's 4 entries
  int32_t prev = __shfl_up_sync(kFull, c[kPer - 1], 1);
  int32_t next = __shfl_down_sync(kFull, c[0], 1);
  if (lane == 0 && tid > 0) {
    prev = __ldg(cols + s - 1);
  }
  if (lane == 31 && tid < kThreads - 1) {
    next = __ldg(cols + s + kPer);
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
  float r[kPer];
  bool started[kPer];
  r[0] = u[0];
  started[0] = head[0];
#pragma unroll
  for (int j = 1; j < kPer; ++j) {
    r[j] = head[j] ? u[j] : r[j - 1] + u[j];
    started[j] = started[j - 1] || head[j];
  }
  // across the warp: inclusive scan of the threads' spans
  Seg inc = {r[kPer - 1], started[kPer - 1] ? 1 : 0};
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg o = {__shfl_up_sync(kFull, inc.v, off), __shfl_up_sync(kFull, inc.head, off)};
    if (lane >= off) {
      inc = combine(o, inc);
    }
  }
  Seg before = {__shfl_up_sync(kFull, inc.v, 1), __shfl_up_sync(kFull, inc.head, 1)};
  if (lane == 0) {
    before = {0.0f, 0};
  }
  if (lane == 31) {
    warp_sum[warp] = inc;
  }
  __syncthreads();
  // across the warps, in warp order
  Seg prefix = {0.0f, 0};
  for (int i = 0; i < warp; ++i) {
    prefix = combine(prefix, warp_sum[i]);
  }
  prefix = combine(prefix, before);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (!end[j] || (unsigned)c[j] >= (unsigned)kBlockCols) {
      continue;
    }
    // the run that ends here: within the tile, it is the only run of its
    // column (the tile is sorted), so its column says whether it is the
    // tile's first or last run
    const float sum = started[j] ? r[j] : prefix.v + r[j];
    if (left_open && c[j] == first) {
      edge[2 * t] = sum;
    } else if (right_open && c[j] == last) {
      edge[2 * t + 1] = sum;
    } else {
      g[(long long)b * kBlockCols + c[j]] = sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
onehot_reduce_chains_kernel(const int32_t* __restrict__ chains, long long nchains,
                            const float* __restrict__ edge, float* __restrict__ g) {
  const long long chain = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (chain >= nchains) {
    return;
  }
  const long long col = __ldg(chains + 3 * chain);
  const long long first = __ldg(chains + 3 * chain + 1);
  const long long last = __ldg(chains + 3 * chain + 2);
  double acc = lane == 0 ? (double)__ldg(edge + 2 * first + 1) : 0.0;
  for (long long t = first + 1 + lane; t <= last; t += 32) {
    acc += (double)__ldg(edge + 2 * t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) {
    g[col] = (float)acc;
  }
}

unsigned blocks_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int photon_lab_lane_gather(const void* tbl, const void* idx, void* out, long long rows,
                           void* stream) {
  lane_gather_kernel<<<blocks_for(rows, kWarps), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows);
  return (int)cudaGetLastError();
}

int photon_lab_onehot_gather(const void* cols, const void* vals, const void* tile_block,
                             const void* w, void* e, long long ntiles, int d,
                             void* stream) {
  onehot_gather_kernel<<<(unsigned)ntiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const int32_t*>(tile_block), static_cast<const float*>(w),
      static_cast<float*>(e), d);
  return (int)cudaGetLastError();
}

// g (width floats) is cleared here; edge holds 2 * ntiles floats of scratch
int photon_lab_onehot_reduce(const void* cols, const void* upd, const void* tile_block,
                             const void* chains, void* g, long long nchains,
                             long long ntiles, void* edge, long long width, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(g, 0, (size_t)width * sizeof(float), st);
  if (err != cudaSuccess || ntiles == 0) {
    return (int)err;
  }
  onehot_reduce_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(upd),
      static_cast<const int32_t*>(tile_block), static_cast<float*>(g),
      static_cast<float*>(edge), ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || nchains == 0) {
    return (int)err;
  }
  onehot_reduce_chains_kernel<<<blocks_for(nchains, kWarps), kThreads, 0, st>>>(
      static_cast<const int32_t*>(chains), nchains, static_cast<const float*>(edge),
      static_cast<float*>(g));
  return (int)cudaGetLastError();
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
