// Fused GLM objective passes over a padded-ELL design: one sweep of the
// stored (indices, values) per pass.
//
// Replaces photon_ml_tpu/kernels/fused.py::fused_value_grad_curvature
// (Pallas body _vgc_kernel), ::fused_hessian_vector (_hvp_kernel) and
// ::fused_hessian_diagonal (_hdiag_kernel):
//
//   vgc:   z_i = sum_k v_ik w[c_ik] + off_i
//          val = sum_i ew_i l(z_i, y_i)          asum = sum_i a_i
//          a_i = ew_i l'(z_i, y_i)               grad_j = sum_{c_ik=j} v_ik a_i
//          c_i = ew_i l''(z_i, y_i)
//   hvp:   zv_i = sum_k v_ik v[c_ik] + shift     u_i = c_i zv_i
//          hv_j = sum_{c_ik=j} v_ik u_i          usum = sum_i u_i
//   hdiag: z_i, c_i as in vgc                    csum = sum_i c_i
//          dx2_j = sum_{c_ik=j} v_ik^2 c_i       dx_j = sum_{c_ik=j} v_ik c_i
//
// Same contract as the Pallas kernels: a slot whose column id is >= d (the
// padding id is d; ids compared as unsigned, so a negative id too) reads 0
// and adds nothing; duplicate ids, within a row and across rows, sum; the
// compute type is result_type(values, w, labels, offsets, ew): (f64 values,
// f64), (f32, f32), (bf16 values, f32). The loss is a template parameter
// covering the four PointwiseLosses of photon_ml_tpu/ops/losses.py;
// logistic's softplus follows the port's logaddexp(x, 0) = max(x, 0) +
// log1p(exp(-|x|)). hdiag squares each slot's value on its own (a duplicate
// id adds v^2 per slot, not (sum v)^2), as the Pallas kernel's per-slot
// group totals do; bf16 values are widened to f32 before the square. The
// scalars (val, asum; usum; csum) are summed in a fixed order, so they have
// the same bits from run to run: TRON compares them across trial points.
// The (d,) outputs take atomics, whose order, and so a column's last bits,
// vary.
//
// Bound on Hopper: HBM bytes. A pass reads the design once,
// n*k*(4 + itemsize), reads the (d,) vector and writes the (d,) output,
// 2*d*itemsize, and reads one (n,) row vector, n*itemsize (hvp: c); vgc
// reads two more and writes the curvature, 3*n*itemsize more; hdiag reads
// three (n,) row vectors and writes two (d,) outputs. The gathers and the
// atomics hit the (d,) vectors in the 50 MB L2.
//
// The three passes share one body (fused_pass). What held the first design
// (a warp per row) back, and what this one does about each point:
//   1. Global atomics per slot (hdiag: two). In the Criteo layout the
//      intercept and the 13 integer-field columns are named by every row,
//      so every row's atomics into them serialise in L2. Now each slot's
//      update (vgc, hvp: v times its row's a_i or u_i; hdiag: the pair
//      v^2 c_i, v c_i) goes through photon::TileCombiner (ell_common.cuh)
//      with one place() per slot: a column named once in the tile takes
//      one global atomic per sum, a repeated column is summed in shared
//      memory and takes one global atomic per sum per tile, and a column
//      that finds no table slot in 16 probes takes direct global atomics.
//      The table (capacity the next power of two at least twice the tile's
//      slots: 26 KB in f64, 43 KB for hdiag's pairs) is dynamic shared
//      memory; a tile above 48 KB (hdiag in f64 with 1-slot granules) sets
//      cudaFuncAttributeMaxDynamicSharedMemorySize before its launch.
//      hdiag's global sums are f64 in every compute type (launch_hdiag).
//   2. A warp per row: at k = 40, 37.5% of lane steps idle, each step an
//      id load and then the gather that waits on it, scalar loads with no
//      streaming hint. Now a block takes a tile of R = max(1, floor(1024 /
//      k)) whole rows (25 at k = 40) in granules (ell_tile.cuh): each thread
//      issues its 16-byte streaming loads of 4 slots, then their gathers
//      through __ldg, then the products; one partial per granule, and one
//      thread per row adds them in granule order.
//   3. The design read twice (the scatter reloaded each row's ids and
//      values). Now each thread keeps its slots in registers from the loads
//      to the scatter. A row longer than one round (k > 1024) is the only
//      case that reads the design twice: its scatter re-reads the slots of
//      the earlier rounds, which are L2 hits.
//   4. Eight rows per block, so 524,288 per-block scalar partials at
//      n = 2^22 for one 256-thread block to add up. Now 25 rows per block at
//      k = 40 (167,773 partials at n = 2^22, 2,622 at 2^16), added by one
//      1024-thread block with four running sums per thread. That second
//      launch stays: at n = 2^16 it adds a few microseconds, and summing in
//      the first kernel's last block would need a counter in global memory
//      kept from call to call.
//   5. The wrapper's host path (kernels/fused.py): each C entry point is
//      resolved with its signature once, the scalars' sums and the
//      partials (hdiag: the outputs too) are one allocation, and the
//      outputs are cleared here.
// The row terms (for vgc the offset, the loss terms, curvature[i], the
// row's share of val and asum, and a_i; for hvp the shift, u_i and its
// share of usum; for hdiag the offset, c_i and its share of csum) are
// computed by the thread that adds the row's sum; it leaves the row's
// scale in shared memory for the scatter, and the block's scalar partials
// are summed in a fixed order (block_sum). k = 0 with n > 0 gives every
// row's terms from the offsets alone.
//
// Nothing is allocated here; the launches go on the caller's stream and do
// not synchronise. Each pass clears its (d,) outputs on that stream first
// (cudaMemsetAsync: one host call, where a zeroed tensor costs the wrapper
// a dispatched fill). Each entry point returns the first CUDA error, or
// cudaGetLastError().

#include "ell_tile.cuh"

namespace {

constexpr int kThreads = photon::tile::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

template <typename A>
__device__ __forceinline__ A sigmoid(A t) {
  return A(1) / (A(1) + exp(-t));
}

// l(z, y), l'(z, y), l''(z, y) — the formulas of the port's ops/losses.py
template <int LOSS, typename A>
__device__ __forceinline__ void loss_terms(A z, A y, A& l, A& d1, A& d2) {
  if constexpr (LOSS == kLogistic) {
    const A s = A(2) * y - A(1);
    const A x = -s * z;
    l = fmax(x, A(0)) + log1p(exp(-fabs(x)));
    d1 = -s * sigmoid(x);
    const A p = sigmoid(z);
    d2 = p * (A(1) - p);
  } else if constexpr (LOSS == kSquared) {
    const A r = z - y;
    l = A(0.5) * (r * r);
    d1 = r;
    d2 = A(1);
  } else if constexpr (LOSS == kPoisson) {
    const A e = exp(z);
    l = e - y * z;
    d1 = e - y;
    d2 = e;
  } else {  // kSmoothedHinge
    const A s = A(2) * y - A(1);
    const A m = s * z;
    const A one_m = A(1) - m;
    l = m >= A(1) ? A(0) : (m <= A(0) ? A(0.5) - m : A(0.5) * (one_m * one_m));
    const A dldm = m >= A(1) ? A(0) : (m <= A(0) ? A(-1) : m - A(1));
    d1 = s * dldm;
    d2 = (m > A(0) && m < A(1)) ? A(1) : A(0);
  }
}

// Sum of x over the block in a fixed order; the result is valid in thread
// 0. `shared` holds one value per warp.
template <typename A>
__device__ __forceinline__ A block_sum(A x, A* shared) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    shared[warp] = x;
  }
  __syncthreads();
  A total = A(0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) {
      total += shared[i];
    }
  }
  __syncthreads();
  return total;
}

// -- the passes: tiles of whole rows ----------------------------------------

// The row terms of vgc: returns the row's scale a_i and adds the row's
// ew l and a_i to s[0], s[1].
template <typename A, int LOSS>
struct VgcRows {
  static constexpr int kScalars = 2;
  const A* __restrict__ labels;
  const A* __restrict__ offsets;
  const A* __restrict__ ew;
  A* __restrict__ curvature;

  __device__ __forceinline__ A operator()(long long row, A margin, A* s) const {
    A l, d1, d2;
    loss_terms<LOSS, A>(margin + offsets[row], labels[row], l, d1, d2);
    const A e = ew[row];
    const A a = e * d1;
    curvature[row] = e * d2;
    s[0] += e * l;
    s[1] += a;
    return a;
  }
};

// The row terms of hvp: returns u_i = c_i (zv_i + shift) and adds it to s[0].
template <typename A>
struct HvpRows {
  static constexpr int kScalars = 1;
  const A* __restrict__ curvature;
  const A* __restrict__ shift;

  __device__ __forceinline__ A operator()(long long row, A margin, A* s) const {
    const A u = curvature[row] * (margin + __ldg(shift));
    s[0] += u;
    return u;
  }
};

// The row terms of hdiag: returns c_i = ew_i l''(z_i, y_i) and adds it to
// s[0].
template <typename A, int LOSS>
struct HdiagRows {
  static constexpr int kScalars = 1;
  const A* __restrict__ labels;
  const A* __restrict__ offsets;
  const A* __restrict__ ew;

  __device__ __forceinline__ A operator()(long long row, A margin, A* s) const {
    A l, d1, d2;
    loss_terms<LOSS, A>(margin + offsets[row], labels[row], l, d1, d2);
    const A c = ew[row] * d2;
    s[0] += c;
    return c;
  }
};

// What a valid slot of value v in a row of scale s adds to the output:
// v s to one (d,) output (Out = A*: grad, hv), or v^2 s and v s to two
// (Out = Pair<double*>: dx2, dx), each slot squared on its own.
template <typename A>
__device__ __forceinline__ A slot_update(A* /*out*/, A v, A s) {
  return v * s;
}
template <typename A, typename W>
__device__ __forceinline__ photon::Pair<A> slot_update(photon::Pair<W*> /*out*/, A v, A s) {
  return {v * v * s, v * s};
}

// The update type, in the compute type A, of a pass with output Out: A for
// one output, Pair<A> for two (Pair<W*>, whose W may be wider than A).
template <typename A, typename Out>
struct UpdateOfOut {
  using type = A;
};
template <typename A, typename W>
struct UpdateOfOut<A, photon::Pair<W*>> {
  using type = photon::Pair<A>;
};
template <typename A, typename Out>
using UpdateOf = typename UpdateOfOut<A, Out>::type;

// What every pass takes: the design, the (d,) vector t gathered by the row
// sums (w or v), the (d,) output(s) (grad, hv, or dx2 and dx), the
// per-block scalar partials, and the tiling the host chose.
template <typename V, typename A, typename Out>
struct PassArgs {
  const int32_t* indices;
  const V* values;
  const A* t;
  Out out;
  A* partials;
  long long n;
  int k;
  int d;
  int rows_per_tile;
  int capacity;
};

// Scatter the thread's granules of the round that starts at granule g0:
// each valid slot's update (slot_update of its value and its row's scale,
// row_scale[g / kg]) into out, combined by column in the tile's table,
// which is clear with a barrier since.
template <int GS, typename A, typename Out>
__device__ __forceinline__ void scatter_round(
    photon::TileCombiner<UpdateOf<A, Out>>& table,
    const int32_t (&c)[photon::tile::kGranules<GS>][GS],
    const A (&v)[photon::tile::kGranules<GS>][GS], long long g0, long long granules,
    int kg, const A* row_scale, Out out, int d) {
  constexpr int U = photon::tile::kGranules<GS>;
  UpdateOf<A, Out> u[U][GS];
  int h[U][GS];
  bool owner[U][GS];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    // a tile's granules number at most max(1024, kg): int
    const int g = (int)g0 + j * kThreads + threadIdx.x;
    const A scale = g < granules ? row_scale[g / kg] : A(0);
#pragma unroll
    for (int e = 0; e < GS; ++e) {
      h[j][e] = -1;
      owner[j][e] = false;
      if ((unsigned)c[j][e] < (unsigned)d) {
        u[j][e] = slot_update(out, v[j][e], scale);
        h[j][e] = table.place(c[j][e], owner[j][e]);
        if (h[j][e] < 0) {
          photon::add_at(out, c[j][e], u[j][e]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int e = 0; e < GS; ++e) {
      if (h[j][e] >= 0) {
        table.add(h[j][e], owner[j][e], c[j][e], u[j][e], out);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int e = 0; e < GS; ++e) {
      if (h[j][e] >= 0) {
        table.flush(h[j][e], owner[j][e], c[j][e], u[j][e], out);
      }
    }
  }
}

// One tile of rows_per_tile rows: the row sums of t, the row terms (Rows),
// the block's scalar partials, then the scatter of the rows' scaled slots.
// Dynamic shared memory: the table, then one partial per granule of a
// round, then one running sum (later the scale) per row.
template <int GS, typename V, typename A, typename Out, typename Rows>
__device__ __forceinline__ void fused_pass(const PassArgs<V, A, Out>& p, const Rows& rows_of) {
  namespace tile = photon::tile;
  using Table = photon::TileCombiner<UpdateOf<A, Out>>;
  constexpr int U = tile::kGranules<GS>;
  constexpr int kRound = tile::kRoundGranules<GS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ A scratch[kWarps];
  Table table(smem, p.capacity);
  A* part = reinterpret_cast<A*>(smem + Table::bytes(p.capacity));
  A* row_acc = part + kRound;
  const int kg = p.k / GS;
  const long long r0 = (long long)blockIdx.x * p.rows_per_tile;
  const int rows = (int)min((long long)p.rows_per_tile, p.n - r0);
  const long long granules = (long long)rows * kg;
  const int32_t* tile_ids = p.indices + r0 * p.k;
  const V* tile_vals = p.values + r0 * p.k;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_acc[r] = A(0);
  }
  // the first round's loads are in flight while the table clears
  table.clear();
  int32_t c[U][GS];
  A v[U][GS];
  long long g_last = 0;
  for (long long g0 = 0; g0 < granules; g0 += kRound) {
    tile::load_round<GS>(tile_ids, tile_vals, g0, granules, c, v);
    tile::round_partials<GS>(c, v, p.t, p.d, part);
    __syncthreads();
    tile::add_row_partials<kRound>(part, g0, granules, kg, row_acc);
    __syncthreads();
    g_last = g0;
  }
  A s[Rows::kScalars];
#pragma unroll
  for (int i = 0; i < Rows::kScalars; ++i) {
    s[i] = A(0);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_acc[r] = rows_of(r0 + r, row_acc[r], s);
  }
#pragma unroll
  for (int i = 0; i < Rows::kScalars; ++i) {
    const A total = block_sum<A>(s[i], scratch);
    if (threadIdx.x == 0) {
      p.partials[(long long)blockIdx.x * Rows::kScalars + i] = total;
    }
  }
  // block_sum ends in a barrier: every row's scale is in row_acc
  if (granules == 0) {
    return;
  }
  // the last round's slots are still in registers; a row longer than a
  // round re-reads the earlier rounds (L2 hits): the only second read
  scatter_round<GS>(table, c, v, g_last, granules, kg, row_acc, p.out, p.d);
  for (long long g0 = 0; g0 < g_last; g0 += kRound) {
    __syncthreads();
    table.clear();
    __syncthreads();
    tile::load_round<GS>(tile_ids, tile_vals, g0, granules, c, v);
    scatter_round<GS>(table, c, v, g0, granules, kg, row_acc, p.out, p.d);
  }
}

// Three kernels with one body, so that a trace names each pass.
template <int GS, typename V, typename A, typename Out, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_vgc_kernel(PassArgs<V, A, Out> p, Rows rows_of) {
  fused_pass<GS>(p, rows_of);
}

template <int GS, typename V, typename A, typename Out, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_hvp_kernel(PassArgs<V, A, Out> p, Rows rows_of) {
  fused_pass<GS>(p, rows_of);
}

template <int GS, typename V, typename A, typename Out, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_hdiag_kernel(PassArgs<V, A, Out> p, Rows rows_of) {
  fused_pass<GS>(p, rows_of);
}

// out[j] = sum over blocks b of partials[b * width + j], j < width, in a
// fixed order (one block; four running sums per thread keep four loads in
// flight).
template <typename A>
__global__ void __launch_bounds__(kFinishThreads)
sum_partials_kernel(const A* __restrict__ partials, long long blocks,
                    int width, A* __restrict__ out) {
  __shared__ A shared[kFinishThreads / 32];
  for (int j = 0; j < width; ++j) {
    A acc[4] = {A(0), A(0), A(0), A(0)};
    long long b = threadIdx.x;
    for (; b + 3 * kFinishThreads < blocks; b += 4 * kFinishThreads) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] += partials[(b + q * kFinishThreads) * width + j];
      }
    }
    for (; b < blocks; b += kFinishThreads) {
      acc[0] += partials[b * width + j];
    }
    const A total = block_sum<A>((acc[0] + acc[1]) + (acc[2] + acc[3]), shared);
    if (threadIdx.x == 0) {
      out[j] = total;
    }
  }
}

// -- host side ---------------------------------------------------------------

// capacity of a tile's table: the next power of two at least twice the
// slots of one round of the tile (at least 64, for the clear's words)
int table_capacity(int k) {
  const long long tile_slots = (long long)photon::tile::rows_per_tile(k) * k;
  const long long slots =
      tile_slots < photon::tile::kRoundSlots ? tile_slots : photon::tile::kRoundSlots;
  int capacity = 64;
  while (capacity < 2 * slots) {
    capacity <<= 1;
  }
  return capacity;
}

long long tile_blocks(long long n, int k) {
  const int rows = photon::tile::rows_per_tile(k);
  return (n + rows - 1) / rows;
}

template <typename T, typename A>
constexpr size_t tile_smem(int capacity, int round_granules, int rows) {
  return photon::TileCombiner<T>::bytes(capacity) + (size_t)(round_granules + rows) * sizeof(A);
}
// A launch takes 48 KB of dynamic shared memory, more after
// cudaFuncSetAttribute, up to 227 KB less the static scratch. The largest
// tile (k = 1: 1024 rows, 1-slot granules) of hdiag in f64 is 58 KB.
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(tile_smem<photon::Pair<double>, double>(2 * photon::tile::kRoundSlots,
                                                      photon::tile::kRoundSlots,
                                                      photon::tile::kRoundSlots) +
                  kWarps * sizeof(double) <= 227 * 1024,
              "the largest tile passes the shared memory of a block");

// clear the (d,) output(s) on the stream
template <typename A>
int clear(A* out, int d, cudaStream_t s) {
  return (int)cudaMemsetAsync(out, 0, (size_t)d * sizeof(A), s);
}
template <typename W>
int clear(photon::Pair<W*> out, int d, cudaStream_t s) {
  const int code = clear(out.first, d, s);
  return code != 0 ? code : clear(out.second, d, s);
}

// One pass on the caller's stream: the (d,) output(s) cleared, the tile
// kernel with 4-slot granules (k % 4 == 0 and aligned bases) or 1-slot
// ones, then the fixed-order sum of its Rows::kScalars partials per block
// into sums.
template <typename V, typename A, typename Out, typename Rows>
int launch_pass(void (*kernel4)(PassArgs<V, A, Out>, Rows),
                void (*kernel1)(PassArgs<V, A, Out>, Rows), PassArgs<V, A, Out> p,
                Rows rows_of, A* sums, cudaStream_t s) {
  namespace tile = photon::tile;
  // a 4-slot granule of values is 32, 16 or 8 bytes: aligned to 16 or 8
  constexpr unsigned kValueAlign = 4 * sizeof(V) < 16 ? 4 * sizeof(V) : 16;
  const bool vec = p.k % 4 == 0 && photon::aligned(p.indices, 16) &&
                   photon::aligned(p.values, kValueAlign);
  p.rows_per_tile = tile::rows_per_tile(p.k);
  p.capacity = table_capacity(p.k);
  const long long blocks = tile_blocks(p.n, p.k);
  const size_t smem = tile_smem<UpdateOf<A, Out>, A>(
      p.capacity, vec ? tile::kRoundGranules<4> : tile::kRoundGranules<1>, p.rows_per_tile);
  int code = clear(p.out, p.d, s);
  if (code != 0) {
    return code;
  }
  void (*kernel)(PassArgs<V, A, Out>, Rows) = vec ? kernel4 : kernel1;
  if (smem > kDefaultSmem) {
    code = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
    if (code != 0) {
      return code;
    }
  }
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(p, rows_of);
  code = (int)cudaGetLastError();
  if (code != 0) {
    return code;
  }
  sum_partials_kernel<A><<<1, kFinishThreads, 0, s>>>(p.partials, blocks, Rows::kScalars, sums);
  return (int)cudaGetLastError();
}

template <typename V, typename A, int LOSS>
int launch_vgc_loss(const PassArgs<V, A, A*>& p, const A* y, const A* off, const A* ew,
                    A* curvature, A* sums, cudaStream_t s) {
  using Rows = VgcRows<A, LOSS>;
  return launch_pass<V, A, A*, Rows>(fused_vgc_kernel<4, V, A, A*, Rows>,
                                     fused_vgc_kernel<1, V, A, A*, Rows>, p,
                                     Rows{y, off, ew, curvature}, sums, s);
}

template <typename V, typename A>
int launch_vgc(const void* indices, const void* values, const void* labels,
               const void* offsets, const void* ew, const void* w, void* grad,
               void* curvature, void* partials, void* out, long long n, int k,
               int d, int loss, void* stream) {
  const PassArgs<V, A, A*> p{static_cast<const int32_t*>(indices),
                             static_cast<const V*>(values), static_cast<const A*>(w),
                             static_cast<A*>(grad), static_cast<A*>(partials), n, k, d, 0, 0};
  const A* y = static_cast<const A*>(labels);
  const A* off = static_cast<const A*>(offsets);
  const A* e = static_cast<const A*>(ew);
  A* c = static_cast<A*>(curvature);
  A* sums = static_cast<A*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLogistic:
      return launch_vgc_loss<V, A, kLogistic>(p, y, off, e, c, sums, s);
    case kSquared:
      return launch_vgc_loss<V, A, kSquared>(p, y, off, e, c, sums, s);
    case kPoisson:
      return launch_vgc_loss<V, A, kPoisson>(p, y, off, e, c, sums, s);
    default:
      return launch_vgc_loss<V, A, kSmoothedHinge>(p, y, off, e, c, sums, s);
  }
}

template <typename V, typename A>
int launch_hvp(const void* indices, const void* values, const void* curvature,
               const void* shift, const void* v, void* hv, void* partials,
               void* out, long long n, int k, int d, void* stream) {
  using Rows = HvpRows<A>;
  const PassArgs<V, A, A*> p{static_cast<const int32_t*>(indices),
                             static_cast<const V*>(values), static_cast<const A*>(v),
                             static_cast<A*>(hv), static_cast<A*>(partials), n, k, d, 0, 0};
  const Rows rows_of{static_cast<const A*>(curvature), static_cast<const A*>(shift)};
  return launch_pass<V, A, A*, Rows>(fused_hvp_kernel<4, V, A, A*, Rows>,
                                     fused_hvp_kernel<1, V, A, A*, Rows>, p, rows_of,
                                     static_cast<A*>(out), static_cast<cudaStream_t>(stream));
}

template <typename V, typename A, int LOSS>
int launch_hdiag_loss(const PassArgs<V, A, photon::Pair<double*>>& p, const A* y,
                      const A* off, const A* ew, A* csum, cudaStream_t s) {
  using Out = photon::Pair<double*>;
  using Rows = HdiagRows<A, LOSS>;
  return launch_pass<V, A, Out, Rows>(fused_hdiag_kernel<4, V, A, Out, Rows>,
                                      fused_hdiag_kernel<1, V, A, Out, Rows>, p,
                                      Rows{y, off, ew}, csum, s);
}

// dx2, dx = the f64 sums rounded to f32, once
__global__ void __launch_bounds__(kThreads)
narrow_sums_kernel(photon::Pair<double*> wide, float* __restrict__ dx2,
                   float* __restrict__ dx, int d) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < d) {
    dx2[j] = (float)wide.first[j];
    dx[j] = (float)wide.second[j];
  }
}

// hdiag's (d,) sums accumulate in f64 whatever the compute type: in f32, a
// column named by every row takes one global atomic per tile (167,773 at
// n = 2^22), and a running f32 sum of that many positive terms drifts by
// about 1e-5 of itself. In f64 they go straight to dx2 and dx; in f32 to
// `wide` (2 d doubles), rounded to f32 after the pass.
template <typename V, typename A>
int launch_hdiag(const void* indices, const void* values, const void* labels,
                 const void* offsets, const void* ew, const void* w, void* dx2,
                 void* dx, void* wide, void* partials, void* out, long long n, int k,
                 int d, int loss, void* stream) {
  constexpr bool kWide = sizeof(A) < sizeof(double);
  double* sums2 = static_cast<double*>(kWide ? wide : dx2);
  double* sums1 = kWide ? static_cast<double*>(wide) + d : static_cast<double*>(dx);
  const PassArgs<V, A, photon::Pair<double*>> p{
      static_cast<const int32_t*>(indices), static_cast<const V*>(values),
      static_cast<const A*>(w), {sums2, sums1}, static_cast<A*>(partials), n, k, d, 0, 0};
  const A* y = static_cast<const A*>(labels);
  const A* off = static_cast<const A*>(offsets);
  const A* e = static_cast<const A*>(ew);
  A* csum = static_cast<A*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  switch (loss) {
    case kLogistic:
      code = launch_hdiag_loss<V, A, kLogistic>(p, y, off, e, csum, s);
      break;
    case kSquared:
      code = launch_hdiag_loss<V, A, kSquared>(p, y, off, e, csum, s);
      break;
    case kPoisson:
      code = launch_hdiag_loss<V, A, kPoisson>(p, y, off, e, csum, s);
      break;
    default:
      code = launch_hdiag_loss<V, A, kSmoothedHinge>(p, y, off, e, csum, s);
      break;
  }
  if constexpr (kWide) {
    if (code == 0 && d > 0) {
      narrow_sums_kernel<<<(unsigned)(((long long)d + kThreads - 1) / kThreads), kThreads, 0,
                           s>>>(
          p.out, static_cast<float*>(dx2), static_cast<float*>(dx), d);
      code = (int)cudaGetLastError();
    }
  }
  return code;
}

}  // namespace

extern "C" {

// scratch `partials` holds 2 * photon_fused_tile_blocks(n, k) (vgc) or
// photon_fused_tile_blocks(n, k) (hvp, hdiag) elements of the compute type;
// hdiag's `wide` holds 2 * d doubles for the f32 compute type (unused in
// f64)
long long photon_fused_tile_blocks(long long n, int k) {
  return tile_blocks(n, k);
}

#define PHOTON_FUSED_ENTRIES(SUFFIX, V, A)                                     \
  int photon_fused_vgc_##SUFFIX(                                               \
      const void* indices, const void* values, const void* labels,             \
      const void* offsets, const void* ew, const void* w, void* grad,          \
      void* curvature, void* partials, void* out, long long n, int k, int d,   \
      int loss, void* stream) {                                                \
    return launch_vgc<V, A>(indices, values, labels, offsets, ew, w, grad,     \
                            curvature, partials, out, n, k, d, loss, stream);  \
  }                                                                            \
  int photon_fused_hvp_##SUFFIX(                                               \
      const void* indices, const void* values, const void* curvature,          \
      const void* shift, const void* v, void* hv, void* partials, void* out,   \
      long long n, int k, int d, void* stream) {                               \
    return launch_hvp<V, A>(indices, values, curvature, shift, v, hv,          \
                            partials, out, n, k, d, stream);                   \
  }                                                                            \
  int photon_fused_hdiag_##SUFFIX(                                             \
      const void* indices, const void* values, const void* labels,             \
      const void* offsets, const void* ew, const void* w, void* dx2, void* dx, \
      void* wide, void* partials, void* out, long long n, int k, int d,        \
      int loss, void* stream) {                                                \
    return launch_hdiag<V, A>(indices, values, labels, offsets, ew, w, dx2,    \
                              dx, wide, partials, out, n, k, d, loss, stream); \
  }

PHOTON_FUSED_ENTRIES(f64, double, double)
PHOTON_FUSED_ENTRIES(f32, float, float)
PHOTON_FUSED_ENTRIES(bf16_f32, __nv_bfloat16, float)

#undef PHOTON_FUSED_ENTRIES

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
