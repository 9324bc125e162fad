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
// put half the work on one SM (Zipf data puts half the lab's tiles in
// block 0). Design, with no global atomics and every sum in a fixed
// order, so g has the same bits from call to call:
//   1. a block per chunk of `chunk` consecutive tiles (the last chunk may
//      be shorter), a warp per tile (4 warps; warp w takes the chunk's
//      tiles w, w + 4, ...) and 32 consecutive entries a lane. The warp
//      copies its tile into shared memory with coalesced cp.async (a
//      swizzled layout, so each lane then reads its 8 vectors without
//      bank conflicts), and meanwhile reads the tile's neighbours (their
//      blocks, the previous tile's last column, the next tile's first).
//      A lane walks its entries in order and writes each run that starts
//      and ends in it at once; the run open at the lane's start gets the
//      earlier lanes' part from a segmented scan across the warp by
//      shuffles. A tile's first run, when the previous tile continues it,
//      and its last, when the next tile does, go to shared memory; then
//      one thread walks the chunk's tiles in order: the TPU grid's
//      sequential carry, moved inside the block, in double. A run that
//      began and ends in the chunk goes to g; one that continues from the
//      previous chunk (the chunk's first run) leaves its part in edge[2c];
//      one that continues into the next chunk (its last run, if it is not
//      also the first) in edge[2c + 1];
//   2. every column of g is written exactly once, zeros included, so g
//      needs no clearing: the columns between two consecutive columns of
//      a tile are zeroed by the lane that ends the first one's run; a
//      tile's columns before its first named column, back to where the
//      previous tile's range ended, and after its last named column, up
//      to the next tile's first column (or to the next tile's block, or
//      to `width` after the last tile), by the tile's warp. So blocks no
//      tile names, and the columns past d, are zeroed by the tile before
//      them (by tile 0 before the first tile's block);
//   3. a thread per line of `chains` (a column whose run crosses a tile
//      edge: global column, first tile, last tile; built with the layout)
//      whose run crosses a chunk edge: it adds edge[2 cf + 1] and edge[2 k]
//      for the chunks k after the first chunk cf, up to the last, in
//      chunk order, in double, and writes the column once; a run over
//      more than kLaneSpan chunks is summed by a warp of its own instead
//      (in chunk order per lane, then a fixed shuffle tree). A chunk of 4
//      tiles cuts the Zipf head column's chain of the lab's default shape
//      from about 594 partials to about 149. This launch is a programmatic
//      dependent of the tiles pass (Hopper's griddepcontrol), so it is
//      scheduled while the tiles pass drains and waits for it on the card.
// Order of a column's sum: within a lane in entry order, across the
// lanes of the tile's warp, along the chunk in double, then across chunks
// in double; a function of the layout and `chunk` alone.
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
constexpr int kLaneEntries = kTile / 32;  // onehot_reduce: a warp per tile, 32 a lane
constexpr int kReduceWarps = 4;           // onehot_reduce's warps per block
constexpr int kVecs = kTile / 4;          // 16-byte vectors of a tile's cols (or upd)
constexpr int kMaxChunk = 64;  // tiles per onehot_reduce block, at most
constexpr int kLaneSpan = 16;  // chunks a thread sums alone in the chains pass

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

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg);
// both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// where a tile's 16-byte vector v sits in shared memory: lane l reads
// vectors 8l .. 8l + 7 (its 32 entries), and any 8 consecutive lanes find
// the i-th of theirs in 8 different bank groups; 32 consecutive vectors,
// as the copy writes them, stay 8 to a bank-group permutation too
__device__ __forceinline__ int swizzle(int v) {
  return v ^ ((v >> 3) & 7);
}

// g[lo, hi) = 0 by the whole warp
__device__ __forceinline__ void zero_range(float* __restrict__ g, long long lo, long long hi,
                                           int lane) {
  for (long long i = lo + lane; i < hi; i += 32) {
    g[i] = 0.0f;
  }
}

__global__ void __launch_bounds__(32 * kReduceWarps)
onehot_reduce_tiles_kernel(const int32_t* __restrict__ cols, const float* __restrict__ upd,
                           const int32_t* __restrict__ tile_block, float* __restrict__ g,
                           double* __restrict__ edge, long long ntiles, int chunk,
                           long long width) {
  // per tile of the chunk: the part of its first run when the previous
  // tile continues it, of its last run when the next tile continues it,
  // its first run's global column, and flags (1: continued from the
  // previous tile, 2: continued by the next, 4: one column)
  __shared__ float s_in[kMaxChunk], s_out[kMaxChunk];
  __shared__ long long s_first_col[kMaxChunk];
  __shared__ int s_flags[kMaxChunk];
  // each warp's tile, staged
  __shared__ int4 s_cols[kReduceWarps][kVecs];
  __shared__ float4 s_upd[kReduceWarps][kVecs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long c = blockIdx.x;
  const long long t0 = c * chunk;
  const long long t1 = t0 + chunk < ntiles ? t0 + chunk : ntiles;
  const int4* tc = s_cols[warp];
  const float4* tu = s_upd[warp];
  // the chains pass may be scheduled once every block has started; it
  // waits for this grid to finish before it reads edge
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (long long t = t0 + warp; t < t1; t += kReduceWarps) {
    const int m = (int)(t - t0);
    // the tile, coalesced, into shared memory; the tile's neighbours meanwhile
    const int4* gc = reinterpret_cast<const int4*>(cols + t * kTile);
    const float4* gu = reinterpret_cast<const float4*>(upd + t * kTile);
#pragma unroll
    for (int r = 0; r < kVecs / 32; ++r) {
      const int v = lane + 32 * r;
      cp_async16(&s_cols[warp][swizzle(v)], gc + v);
      cp_async16(&s_upd[warp][swizzle(v)], gu + v);
    }
    const int32_t b = __ldg(tile_block + t);
    const int32_t prev_block = t > 0 ? __ldg(tile_block + t - 1) : -1;
    const int32_t next_block = t + 1 < ntiles ? __ldg(tile_block + t + 1) : -1;
    const int32_t prev_last = t > 0 ? __ldg(cols + t * kTile - 1) : kBlockCols;
    const int32_t next_head = t + 1 < ntiles ? __ldg(cols + (t + 1) * kTile) : kBlockCols;
    cp_async_wait_all();
    __syncwarp();
    // the lane's 32 consecutive entries are vectors 8 lane .. 8 lane + 7
    const int32_t lane_first = tc[swizzle(8 * lane)].x;
    const int32_t lane_last = tc[swizzle(8 * lane + 7)].w;
    const int32_t first = __shfl_sync(kFull, lane_first, 0);
    const int32_t last = __shfl_sync(kFull, lane_last, 31);
    const long long col0 = (long long)b * kBlockCols;
    const bool prev_same = prev_block == b, next_same = next_block == b;
    const int32_t next_first = next_same ? next_head : kBlockCols;
    // whether the previous tile's last run continues here, and whether
    // this tile's last run continues in the next (never the miss)
    const bool cont_in = first != kBlockCols && prev_same && prev_last == first;
    const bool cont_out = last != kBlockCols && next_first == last;
    // the columns this tile zeroes where no entry names them: [lo, hi)
    const long long lo = t == 0 ? 0 : !prev_same ? col0 : col0 + first;
    const long long hi = next_block < 0 ? width
                         : !next_same   ? (long long)next_block * kBlockCols
                                        : col0 + next_first;
    // a run of `col` that ends in the tile, with its sum over the tile:
    // the tile's first or last run to the chunk's pass when a
    // neighbouring tile continues it, any other to g (never a miss)
    const auto emit = [&](int32_t col, float sum) {
      if (col == kBlockCols) {
        return;
      }
      if (cont_in && col == first) {
        s_in[m] = sum;
      } else if (cont_out && col == last) {
        s_out[m] = sum;
      } else {
        g[col0 + col] = sum;
      }
    };
    // the columns strictly between two consecutive columns of the tile
    const auto zero_gap = [&](int32_t from, int32_t to) {
      if (to != kBlockCols) {
        for (int32_t i = from + 1; i < to; ++i) {
          g[col0 + i] = 0.0f;
        }
      }
    };
    // the lane's pass, in entry order: a run that starts and ends in the
    // lane is written at once; the lane's first run, when an earlier lane
    // began it, waits for that lane's part
    const int32_t before = __shfl_up_sync(kFull, lane_last, 1);
    const int32_t after = __shfl_down_sync(kFull, lane_first, 1);
    const bool lane_cont = lane > 0 && before == lane_first;
    bool split = false;  // a run starts inside the lane
    float first_part = 0.0f;
    int32_t named = -1;  // the lane's last named column
    int32_t cur = lane_first;
    float acc = -0.0f;  // -0 + x is x, -0 included
#pragma unroll
    for (int i = 0; i < kLaneEntries / 4; ++i) {
      const int4 c4 = tc[swizzle(8 * lane + i)];
      const float4 u4 = tu[swizzle(8 * lane + i)];
      const int32_t cl[4] = {c4.x, c4.y, c4.z, c4.w};
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cl[j] != cur) {
          if (lane_cont && !split) {
            first_part = acc;
          } else {
            emit(cur, acc);
          }
          zero_gap(cur, cl[j]);
          named = cur;
          split = true;
          cur = cl[j];
          acc = u[j];
        } else {
          acc += u[j];
        }
      }
    }
    if (cur != kBlockCols) {
      named = cur;
    }
    // across the warp: the part of the run open at each lane's start
    Seg inc = {acc, (split || !lane_cont) ? 1 : 0};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Seg o = {__shfl_up_sync(kFull, inc.v, off), __shfl_up_sync(kFull, inc.head, off)};
      if (lane >= off) {
        inc = combine(o, inc);
      }
    }
    const float open_part = __shfl_up_sync(kFull, inc.v, 1);
    if (lane_cont && split) {
      emit(lane_first, open_part + first_part);
    }
    if (lane == 31 || after != cur) {
      emit(cur, lane_cont && !split ? open_part + acc : acc);
      if (lane < 31) {
        zero_gap(cur, after);
      }
    }
    // the tile's columns before its first named one and after its last
    const int32_t last_named = __reduce_max_sync(kFull, named);
    if (first == kBlockCols) {
      zero_range(g, lo, hi, lane);
    } else {
      zero_range(g, lo, col0 + first, lane);
      zero_range(g, col0 + last_named + 1, hi, lane);
    }
    if (lane == 0) {
      s_flags[m] = (cont_in ? 1 : 0) | (cont_out ? 2 : 0) | (first == last ? 4 : 0);
      s_first_col[m] = col0 + first;
    }
    __syncwarp();  // the warp's next tile overwrites the staged one
  }
  __syncthreads();
  if (threadIdx.x != 0) {
    return;
  }
  // the chunk's pass, in tile order, in double: a run carried from tile
  // to tile; one that began before the chunk or goes on after it leaves
  // its part in edge
  const int n = (int)(t1 - t0);
  double carry = 0.0;
  bool carry_open = false;
  for (int m = 0; m < n; ++m) {
    const int f = s_flags[m];
    const bool cin = f & 1, cout = f & 2, single = f & 4;
    if (cin) {
      const double s = m == 0 ? (double)s_in[m] : carry + (double)s_in[m];
      const bool open = m == 0 || carry_open;
      if (single && cout) {
        if (m + 1 < n) {
          carry = s, carry_open = open;
        } else {
          edge[2 * c + (open ? 0 : 1)] = s;
        }
        continue;
      }
      if (open) {
        edge[2 * c] = s;
      } else {
        g[s_first_col[m]] = (float)s;
      }
    }
    if (cout) {
      if (m + 1 < n) {
        carry = s_out[m], carry_open = false;
      } else {
        edge[2 * c + 1] = s_out[m];
      }
    }
  }
}

// A thread per line of `chains`: when its run crosses a chunk edge and
// spans at most kLaneSpan chunks, it sums the partials alone, in chunk
// order (loads in batches of 8); the block's longer runs go one to a warp,
// in line order, summed by the whole warp. Launched as a programmatic
// dependent of the tiles pass: it waits for that grid before reading edge.
__global__ void __launch_bounds__(kThreads)
onehot_reduce_chains_kernel(const int32_t* __restrict__ chains, long long nchains,
                            const double* __restrict__ edge, int chunk,
                            float* __restrict__ g) {
  __shared__ unsigned s_mask[kWarps];
  __shared__ int s_long[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long block_line = (long long)blockIdx.x * kThreads;
  const long long line = block_line + tid;
  int32_t col = 0;
  long long first = 0, last = 0;
  if (line < nchains) {
    col = __ldg(chains + 3 * line);
    first = __ldg(chains + 3 * line + 1) / chunk;
    last = __ldg(chains + 3 * line + 2) / chunk;
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // a run that stays in one chunk was written by the tiles pass
  const bool longer = last - first > kLaneSpan;
  if (first != last && !longer) {
    double acc = __ldcg(edge + 2 * first + 1);
    long long k = first + 1;
    for (; k + 7 <= last; k += 8) {
      double part[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        part[i] = __ldcg(edge + 2 * (k + i));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc += part[i];
      }
    }
    for (; k <= last; ++k) {
      acc += __ldcg(edge + 2 * k);
    }
    g[col] = (float)acc;
  }
  // the block's longer runs, in line order, one to a warp
  const unsigned mask = __ballot_sync(kFull, longer);
  if (lane == 0) {
    s_mask[warp] = mask;
  }
  __syncthreads();
  int total = 0, at = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = __popc(s_mask[w]);
    at += w < warp ? n : 0;
    total += n;
  }
  if (longer) {
    s_long[at + __popc(mask & ((1u << lane) - 1u))] = tid;
  }
  __syncthreads();
  for (int j = warp; j < total; j += kWarps) {
    const long long l = block_line + s_long[j];
    const long long f = __ldg(chains + 3 * l + 1) / chunk;
    const long long e = __ldg(chains + 3 * l + 2) / chunk;
    double acc = lane == 0 ? __ldcg(edge + 2 * f + 1) : 0.0;
    for (long long k = f + 1 + lane; k <= e; k += 32) {
      acc += __ldcg(edge + 2 * k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFull, acc, off);
    }
    if (lane == 0) {
      g[__ldg(chains + 3 * l)] = (float)acc;
    }
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

// g: width floats, every one written; edge: 2 * ceil(ntiles / chunk)
// doubles of scratch; ntiles > 0
int photon_lab_onehot_reduce(const void* cols, const void* upd, const void* tile_block,
                             const void* chains, void* g, long long nchains,
                             long long ntiles, void* edge, long long width, int chunk,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  onehot_reduce_tiles_kernel<<<blocks_for(ntiles, chunk), 32 * kReduceWarps, 0, st>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(upd),
      static_cast<const int32_t*>(tile_block), static_cast<float*>(g),
      static_cast<double*>(edge), ntiles, chunk, width);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchains == 0) {
    return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks_for(nchains, kThreads));
  config.blockDim = dim3(kThreads);
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, onehot_reduce_chains_kernel,
                           static_cast<const int32_t*>(chains), nchains,
                           static_cast<const double*>(edge), chunk, static_cast<float*>(g));
  if (err != cudaSuccess) {
    return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
