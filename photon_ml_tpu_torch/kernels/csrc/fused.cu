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
// group totals do; bf16 values are widened to f32 before the square. Every
// sum is taken in a fixed order, so every output has the same bits from
// run to run: the scalars (val, asum; usum; csum), which TRON compares
// across trial points, and the (d,) outputs, so that a training run on the
// card equals itself and its own resume.
//
// Each pass is two steps on the caller's stream:
//   1. the row pass (fused_pass, one body for the three): a block takes a
//      tile of R = max(1, floor(1024 / k)) whole rows (25 at k = 40) in
//      granules (ell_tile.cuh): each thread issues its 16-byte streaming
//      loads of 4 slots, then their gathers through __ldg, then the
//      products; one partial per granule, and one thread per row adds them
//      in granule order. That thread computes the row terms (vgc: the
//      offset, the loss terms, curvature[i], the row's share of val and
//      asum, and a_i; hvp: the shift, u_i and its share of usum; hdiag: the
//      offset, c_i and its share of csum) and writes the row's scale (a_i,
//      u_i or c_i) to the (n,) scratch `scale`; the block's scalar partials
//      are summed in a fixed order (block_sum), and one 1024-thread block
//      adds the blocks' partials in a fixed order (sum_partials_kernel).
//      k = 0 with n > 0 gives every row's terms from the offsets alone;
//   2. the X^T side: the column-sorted reduce of colsort.cuh over the
//      design's column-sorted copy (kernels/colsort.py), block of rows
//      after block of rows so that its scale[row] gathers stay in L2; it
//      gathers them itself and writes each column once per block with no
//      atomics (vgc, hvp: v scale; hdiag: the pair v^2 scale, v scale,
//      summed in f64 in every compute type and rounded once).
// Until this design the X^T side was a scatter of each slot's update
// through a shared-memory combiner with global atomics, one read of the
// design; a column's last bits then changed from run to run, and TRON
// amplified them into other iteration counts.
//
// Bound on Hopper: HBM bytes. The least traffic reads the design once,
// n*k*(4 + itemsize), the (d,) vector and writes the (d,) output(s), plus
// the (n,) row vectors. This design reads the design twice, once as the ELL
// and once as the copy (column, slot in its block and value: 4 + 4 +
// itemsize per valid slot), and writes and reads the (n,) scale: the price
// of a fixed order.
//
// Nothing is allocated here; the launches go on the caller's stream and do
// not synchronise. Each entry point returns the first CUDA error, or
// cudaGetLastError().

#include "colsort.cuh"
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

// What every pass takes: the design, the (d,) vector t gathered by the row
// sums (w or v), the (n,) scale each row leaves for the X^T side, the
// per-block scalar partials, and the tiling the host chose.
template <typename V, typename A>
struct PassArgs {
  const int32_t* indices;
  const V* values;
  const A* t;
  A* scale;
  A* partials;
  long long n;
  int k;
  int d;
  int rows_per_tile;
};

// One tile of rows_per_tile rows: the row sums of t, the row terms (Rows),
// each row's scale, and the block's scalar partials. Dynamic shared
// memory: one partial per granule of a round, then one running sum per
// row.
template <int GS, typename V, typename A, typename Rows>
__device__ __forceinline__ void fused_pass(const PassArgs<V, A>& p, const Rows& rows_of) {
  namespace tile = photon::tile;
  constexpr int U = tile::kGranules<GS>;
  constexpr int kRound = tile::kRoundGranules<GS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ A scratch[kWarps];
  A* part = reinterpret_cast<A*>(smem);
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
  int32_t c[U][GS];
  A v[U][GS];
  for (long long g0 = 0; g0 < granules; g0 += kRound) {
    tile::load_round<GS>(tile_ids, tile_vals, g0, granules, c, v);
    tile::round_partials<GS>(c, v, p.t, p.d, part);
    __syncthreads();
    tile::add_row_partials<kRound>(part, g0, granules, kg, row_acc);
    __syncthreads();
  }
  A s[Rows::kScalars];
#pragma unroll
  for (int i = 0; i < Rows::kScalars; ++i) {
    s[i] = A(0);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    p.scale[r0 + r] = rows_of(r0 + r, row_acc[r], s);
  }
#pragma unroll
  for (int i = 0; i < Rows::kScalars; ++i) {
    const A total = block_sum<A>(s[i], scratch);
    if (threadIdx.x == 0) {
      p.partials[(long long)blockIdx.x * Rows::kScalars + i] = total;
    }
  }
}

// Three kernels with one body, so that a trace names each pass.
template <int GS, typename V, typename A, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_vgc_kernel(PassArgs<V, A> p, Rows rows_of) {
  fused_pass<GS>(p, rows_of);
}

template <int GS, typename V, typename A, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_hvp_kernel(PassArgs<V, A> p, Rows rows_of) {
  fused_pass<GS>(p, rows_of);
}

template <int GS, typename V, typename A, typename Rows>
__global__ void __launch_bounds__(kThreads)
fused_hdiag_kernel(PassArgs<V, A> p, Rows rows_of) {
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

long long tile_blocks(long long n, int k) {
  const int rows = photon::tile::rows_per_tile(k);
  return (n + rows - 1) / rows;
}

// The design's column-sorted copy, as the entry points take it
// (kernels/colsort.py::DesignColumns): entries, the chains, the block table
// (in host memory) and the reduce's f64 scratch (colsort.py
// reduce_scratch).
struct Copy {
  const void* cols;
  const void* slots;
  const void* vals;
  const void* chains;
  const void* blocks;
  void* scratch;
  long long nblocks;
};

// One pass on the caller's stream: the row kernel with 4-slot granules (k
// % 4 == 0 and aligned bases) or 1-slot ones, the fixed-order sum of its
// Rows::kScalars partials per block into sums, then the column-sorted
// reduce of the rows' scales into out0 (and out1 for kPair).
template <int MODE, typename V, typename A, typename Rows>
int launch_pass(void (*kernel4)(PassArgs<V, A>, Rows), void (*kernel1)(PassArgs<V, A>, Rows),
                PassArgs<V, A> p, Rows rows_of, A* sums, const Copy& copy, A* out0, A* out1,
                cudaStream_t s) {
  namespace tile = photon::tile;
  // a 4-slot granule of values is 32, 16 or 8 bytes: aligned to 16 or 8
  constexpr unsigned kValueAlign = 4 * sizeof(V) < 16 ? 4 * sizeof(V) : 16;
  const bool vec = p.k % 4 == 0 && photon::aligned(p.indices, 16) &&
                   photon::aligned(p.values, kValueAlign);
  p.rows_per_tile = tile::rows_per_tile(p.k);
  const long long blocks = tile_blocks(p.n, p.k);
  // at most 2 * 1024 values of A: 16 KB, under the default 48 KB
  const size_t smem =
      (size_t)((vec ? tile::kRoundGranules<4> : tile::kRoundGranules<1>) + p.rows_per_tile) *
      sizeof(A);
  void (*kernel)(PassArgs<V, A>, Rows) = vec ? kernel4 : kernel1;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(p, rows_of);
  int code = (int)cudaGetLastError();
  if (code != 0) {
    return code;
  }
  sum_partials_kernel<A><<<1, kFinishThreads, 0, s>>>(p.partials, blocks, Rows::kScalars, sums);
  code = (int)cudaGetLastError();
  if (code != 0) {
    return code;
  }
  const photon::colsort::Reduce<V, A> r{
      static_cast<const int32_t*>(copy.cols),    static_cast<const int32_t*>(copy.slots),
      static_cast<const V*>(copy.vals),          static_cast<const int32_t*>(copy.chains),
      static_cast<const long long*>(copy.blocks), copy.nblocks,
      p.scale,                                   out0,
      out1,                                      static_cast<double*>(copy.scratch),
      p.k,                                       p.d};
  return photon::colsort::launch_reduce<V, A, MODE>(r, s);
}

template <typename V, typename A>
PassArgs<V, A> pass_args(const void* indices, const void* values, const void* t, void* scale,
                         void* partials, long long n, int k, int d) {
  return {static_cast<const int32_t*>(indices), static_cast<const V*>(values),
          static_cast<const A*>(t), static_cast<A*>(scale), static_cast<A*>(partials),
          n, k, d, 0};
}

template <typename V, typename A, int LOSS>
int launch_vgc_loss(const PassArgs<V, A>& p, const A* y, const A* off, const A* ew,
                    A* curvature, A* sums, const Copy& copy, A* grad, cudaStream_t s) {
  using Rows = VgcRows<A, LOSS>;
  return launch_pass<photon::colsort::kLinear>(
      fused_vgc_kernel<4, V, A, Rows>, fused_vgc_kernel<1, V, A, Rows>, p,
      Rows{y, off, ew, curvature}, sums, copy, grad, static_cast<A*>(nullptr), s);
}

template <typename V, typename A>
int launch_vgc(const void* indices, const void* values, const void* labels,
               const void* offsets, const void* ew, const void* w, void* grad,
               void* curvature, void* scale, void* partials, void* out, const Copy& copy,
               long long n, int k, int d, int loss, void* stream) {
  const PassArgs<V, A> p = pass_args<V, A>(indices, values, w, scale, partials, n, k, d);
  const A* y = static_cast<const A*>(labels);
  const A* off = static_cast<const A*>(offsets);
  const A* e = static_cast<const A*>(ew);
  A* c = static_cast<A*>(curvature);
  A* sums = static_cast<A*>(out);
  A* g = static_cast<A*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLogistic:
      return launch_vgc_loss<V, A, kLogistic>(p, y, off, e, c, sums, copy, g, s);
    case kSquared:
      return launch_vgc_loss<V, A, kSquared>(p, y, off, e, c, sums, copy, g, s);
    case kPoisson:
      return launch_vgc_loss<V, A, kPoisson>(p, y, off, e, c, sums, copy, g, s);
    default:
      return launch_vgc_loss<V, A, kSmoothedHinge>(p, y, off, e, c, sums, copy, g, s);
  }
}

template <typename V, typename A>
int launch_hvp(const void* indices, const void* values, const void* curvature,
               const void* shift, const void* v, void* hv, void* scale, void* partials,
               void* out, const Copy& copy, long long n, int k, int d, void* stream) {
  using Rows = HvpRows<A>;
  const PassArgs<V, A> p = pass_args<V, A>(indices, values, v, scale, partials, n, k, d);
  const Rows rows_of{static_cast<const A*>(curvature), static_cast<const A*>(shift)};
  return launch_pass<photon::colsort::kLinear>(
      fused_hvp_kernel<4, V, A, Rows>, fused_hvp_kernel<1, V, A, Rows>, p, rows_of,
      static_cast<A*>(out), copy, static_cast<A*>(hv), static_cast<A*>(nullptr),
      static_cast<cudaStream_t>(stream));
}

template <typename V, typename A, int LOSS>
int launch_hdiag_loss(const PassArgs<V, A>& p, const A* y, const A* off, const A* ew, A* csum,
                      const Copy& copy, A* dx2, A* dx, cudaStream_t s) {
  using Rows = HdiagRows<A, LOSS>;
  return launch_pass<photon::colsort::kPair>(
      fused_hdiag_kernel<4, V, A, Rows>, fused_hdiag_kernel<1, V, A, Rows>, p,
      Rows{y, off, ew}, csum, copy, dx2, dx, s);
}

template <typename V, typename A>
int launch_hdiag(const void* indices, const void* values, const void* labels,
                 const void* offsets, const void* ew, const void* w, void* dx2, void* dx,
                 void* scale, void* partials, void* out, const Copy& copy, long long n, int k,
                 int d, int loss, void* stream) {
  const PassArgs<V, A> p = pass_args<V, A>(indices, values, w, scale, partials, n, k, d);
  const A* y = static_cast<const A*>(labels);
  const A* off = static_cast<const A*>(offsets);
  const A* e = static_cast<const A*>(ew);
  A* csum = static_cast<A*>(out);
  A* o2 = static_cast<A*>(dx2);
  A* o1 = static_cast<A*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kLogistic:
      return launch_hdiag_loss<V, A, kLogistic>(p, y, off, e, csum, copy, o2, o1, s);
    case kSquared:
      return launch_hdiag_loss<V, A, kSquared>(p, y, off, e, csum, copy, o2, o1, s);
    case kPoisson:
      return launch_hdiag_loss<V, A, kPoisson>(p, y, off, e, csum, copy, o2, o1, s);
    default:
      return launch_hdiag_loss<V, A, kSmoothedHinge>(p, y, off, e, csum, copy, o2, o1, s);
  }
}

}  // namespace

extern "C" {

// scratch `partials` holds 2 * photon_fused_tile_blocks(n, k) (vgc) or
// photon_fused_tile_blocks(n, k) (hvp, hdiag) elements of the compute
// type, `scale` n of them; the copy's `scratch` holds what
// kernels/colsort.py::reduce_scratch allocates (2 * ntiles doubles per sum,
// and 2 * d more for hdiag over several blocks in f32); `blocks` is in host
// memory
long long photon_fused_tile_blocks(long long n, int k) {
  return tile_blocks(n, k);
}

#define PHOTON_COPY_PARAMS                                                   \
  const void *cols, const void *slots, const void *cvals, const void *chains, \
      const void *blocks, void *scratch, long long nblocks
#define PHOTON_COPY Copy{cols, slots, cvals, chains, blocks, scratch, nblocks}

#define PHOTON_FUSED_ENTRIES(SUFFIX, V, A)                                          \
  int photon_fused_vgc_##SUFFIX(                                                    \
      const void* indices, const void* values, const void* labels,                  \
      const void* offsets, const void* ew, const void* w, void* grad,               \
      void* curvature, void* scale, void* partials, void* out, PHOTON_COPY_PARAMS,  \
      long long n, int k, int d, int loss, void* stream) {                          \
    return launch_vgc<V, A>(indices, values, labels, offsets, ew, w, grad,          \
                            curvature, scale, partials, out, PHOTON_COPY, n, k, d,  \
                            loss, stream);                                          \
  }                                                                                 \
  int photon_fused_hvp_##SUFFIX(                                                    \
      const void* indices, const void* values, const void* curvature,               \
      const void* shift, const void* v, void* hv, void* scale, void* partials,      \
      void* out, PHOTON_COPY_PARAMS, long long n, int k, int d, void* stream) {     \
    return launch_hvp<V, A>(indices, values, curvature, shift, v, hv, scale,        \
                            partials, out, PHOTON_COPY, n, k, d, stream);           \
  }                                                                                 \
  int photon_fused_hdiag_##SUFFIX(                                                  \
      const void* indices, const void* values, const void* labels,                  \
      const void* offsets, const void* ew, const void* w, void* dx2, void* dx,      \
      void* scale, void* partials, void* out, PHOTON_COPY_PARAMS, long long n,      \
      int k, int d, int loss, void* stream) {                                       \
    return launch_hdiag<V, A>(indices, values, labels, offsets, ew, w, dx2, dx,     \
                              scale, partials, out, PHOTON_COPY, n, k, d, loss,     \
                              stream);                                              \
  }

PHOTON_FUSED_ENTRIES(f64, double, double)
PHOTON_FUSED_ENTRIES(f32, float, float)
PHOTON_FUSED_ENTRIES(bf16_f32, __nv_bfloat16, float)

#undef PHOTON_FUSED_ENTRIES
#undef PHOTON_COPY
#undef PHOTON_COPY_PARAMS

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
