// ell_matvec: margins of a padded-ELL design, z_i = sum_k v_ik * w[c_ik].
//
// Replaces photon_ml_tpu/kernels/ell.py::ell_matvec (Pallas body
// _matvec_kernel). Same contract: a slot whose column id is >= d (the
// padding id is d) reads 0 — the JAX path's w.at[idx].get(mode="fill")
// (photon_ml_tpu/ops/sparse.py:439); the ids are compared as unsigned, so a
// negative id reads 0 too, and w is never padded. Accumulation is in the
// compute type result_type(values, w):
//   (f64, f64) -> f64   the scoring driver's case
//   (f32, f32) -> f32
//   (bf16, f32) -> f32
//
// Bound on Hopper: HBM bytes. The design is read once,
// n*k*(4 + itemsize(values)) bytes, against 2 FLOPs per slot. At
// d = 2^20 f64 the w table (8 MiB) stays in the 50 MB L2, so the gathers
// are L2 hits and only the streamed (indices, values) go to HBM. What set
// the pace of a warp-per-row kernel was latency: at k = 40 a warp took
// slots 0-31 and then 32-39 on 8 lanes, each step an id load and then a
// gather that waits on it, with little in flight per warp.
//
// Design: each block takes a tile of whole rows, a contiguous span of the
// design, through the granule loads, gathers and fixed-order row sums of
// ell_tile.cuh (4-slot granules when k % 4 == 0 and the bases are aligned,
// else 1-slot; 4 or 8 granules per thread per round): 16-byte streaming
// loads of ids and values, then the gathers of w through the read-only
// path, then one partial per granule into shared memory, which one thread
// per row adds in granule order. The block writes its rows, once each,
// with no atomics. The order of every sum is fixed, so the result has the
// same bits from run to run, and a row's sum those of the fused passes'
// margins (fused.cu). A row longer than a round spans several rounds, each
// added to the row's running sum in order. Nothing is allocated here; the
// launch goes on the caller's stream and does not synchronise. Each entry
// point returns cudaGetLastError().

#include "ell_tile.cuh"

namespace {

namespace tile = photon::tile;
constexpr int kThreads = tile::kThreads;

// granules per thread per round: fewer when a granule is 4 slots. A tile
// here keeps no slots for a scatter, so it holds more than a fused pass's
template <int GS>
constexpr int kUnroll = GS == 1 ? 8 : 4;

template <typename V, typename A, int GS>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const int32_t* __restrict__ indices,
                  const V* __restrict__ values,
                  const A* __restrict__ w,
                  A* __restrict__ out,
                  long long n, int k, int d, int rows_per_tile) {
  constexpr int U = kUnroll<GS>;
  constexpr int kRound = kThreads * U;  // granules per round
  __shared__ A part[kRound];
  __shared__ A row_acc[kRound];         // rows_per_tile <= kRound
  const int kg = k / GS;                // granules per row
  const long long r0 = (long long)blockIdx.x * rows_per_tile;
  const int rows = (int)min((long long)rows_per_tile, n - r0);
  const long long granules = (long long)rows * kg;
  const int32_t* tile_ids = indices + r0 * k;
  const V* tile_vals = values + r0 * k;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_acc[r] = A(0);
  }
  for (long long g0 = 0; g0 < granules; g0 += kRound) {
    int32_t c[U][GS];
    A v[U][GS];
    tile::load_round(tile_ids, tile_vals, g0, granules, c, v);
    tile::round_partials(c, v, w, d, part);
    __syncthreads();
    tile::add_row_partials<kRound>(part, g0, granules, kg, row_acc);
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    out[r0 + r] = row_acc[r];
  }
}

template <typename V, typename A, int GS>
void launch_tiles(const int32_t* indices, const V* values, const A* w, A* out,
                  long long n, int k, int d, cudaStream_t stream) {
  constexpr int kRound = kThreads * kUnroll<GS>;
  const int kg = k / GS;
  const int rows_per_tile = kg == 0 ? kRound : (kg >= kRound ? 1 : kRound / kg);
  const long long blocks = (n + rows_per_tile - 1) / rows_per_tile;
  ell_matvec_kernel<V, A, GS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indices, values, w, out, n, k, d, rows_per_tile);
}

// w is in the compute type A: (f64, f64), (f32, f32), (bf16 values, f32)
template <typename V, typename A>
int launch(const void* indices, const void* values, const void* w, void* out,
           long long n, int k, int d, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const V* v = static_cast<const V*>(values);
  const A* ww = static_cast<const A*>(w);
  A* o = static_cast<A*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a 4-slot granule of values is 32, 16 or 8 bytes: aligned to 16 or 8
  constexpr unsigned kValueAlign = 4 * sizeof(V) < 16 ? 4 * sizeof(V) : 16;
  if (k % 4 == 0 && photon::aligned(ix, 16) && photon::aligned(v, kValueAlign)) {
    launch_tiles<V, A, 4>(ix, v, ww, o, n, k, d, s);
  } else {
    launch_tiles<V, A, 1>(ix, v, ww, o, n, k, d, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int photon_ell_matvec_f64(const void* indices, const void* values,
                          const void* w, void* out, long long n, int k, int d,
                          void* stream) {
  return launch<double, double>(indices, values, w, out, n, k, d, stream);
}

int photon_ell_matvec_f32(const void* indices, const void* values,
                          const void* w, void* out, long long n, int k, int d,
                          void* stream) {
  return launch<float, float>(indices, values, w, out, n, k, d, stream);
}

int photon_ell_matvec_bf16_f32(const void* indices, const void* values,
                               const void* w, void* out, long long n, int k,
                               int d, void* stream) {
  return launch<__nv_bfloat16, float>(indices, values, w, out, n, k, d, stream);
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
