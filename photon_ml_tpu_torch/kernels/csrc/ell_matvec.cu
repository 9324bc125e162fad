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
// design, cut into granules of GS slots (GS = 4 when k % 4 == 0 and the
// bases are aligned, so a granule never crosses a row; else GS = 1). Each
// thread first issues all the loads of its U granules, 16-byte ids and
// 32, 16 or 8 bytes of values per granule under the streaming hint (each
// warp on one contiguous span, so every lane works whatever k is), then all
// their gathers of w through the read-only path, then the products: one
// partial per granule, in slot order, into shared memory. After a barrier
// one thread per row adds its row's partials in granule order and the
// block writes its rows, once each, with no atomics. The order of every
// sum is fixed, so the result has the same bits from run to run. A row
// longer than a tile's granule budget spans several rounds, each added to
// the row's running sum in order. Offsets are 64-bit (n*k passes 2^31 at
// depth). Nothing is allocated here; the launch goes on the caller's
// stream and does not synchronise. Each entry point returns
// cudaGetLastError().

#include "ell_common.cuh"

namespace {

constexpr int kThreads = 256;

// granules per thread per round: fewer when a granule is 4 slots
template <int GS>
constexpr int kUnroll = GS == 1 ? 8 : 4;

template <typename V, typename W, typename Acc, int GS>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const int32_t* __restrict__ indices,
                  const V* __restrict__ values,
                  const W* __restrict__ w,
                  Acc* __restrict__ out,
                  long long n, int k, int d, int rows_per_tile) {
  constexpr int U = kUnroll<GS>;
  constexpr int kRound = kThreads * U;  // granules per round
  __shared__ Acc part[kRound];
  __shared__ Acc row_acc[kRound];       // rows_per_tile <= kRound
  const int kg = k / GS;                // granules per row
  const long long r0 = (long long)blockIdx.x * rows_per_tile;
  const int rows = (int)min((long long)rows_per_tile, n - r0);
  const long long granules = (long long)rows * kg;
  const int32_t* tile_ids = indices + r0 * k;
  const V* tile_vals = values + r0 * k;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_acc[r] = Acc(0);
  }
  for (long long g0 = 0; g0 < granules; g0 += kRound) {
    int32_t c[U][GS];
    Acc v[U][GS];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long g = g0 + j * kThreads + threadIdx.x;
      if (g < granules) {
        photon::load_cs<GS>(tile_ids + g * GS, c[j]);
        photon::load_cs<GS>(tile_vals + g * GS, v[j]);
      } else {
#pragma unroll
        for (int e = 0; e < GS; ++e) {
          c[j][e] = -1;
          v[j][e] = Acc(0);
        }
      }
    }
    Acc wc[U][GS];
#pragma unroll
    for (int j = 0; j < U; ++j) {
#pragma unroll
      for (int e = 0; e < GS; ++e) {
        wc[j][e] = (unsigned)c[j][e] < (unsigned)d ? Acc(__ldg(w + c[j][e])) : Acc(0);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      Acc s = v[j][0] * wc[j][0];
#pragma unroll
      for (int e = 1; e < GS; ++e) {
        s += v[j][e] * wc[j][e];
      }
      part[j * kThreads + threadIdx.x] = s;
    }
    __syncthreads();
    // each row meeting this round adds its granules of it, in order
    const long long g_end = min(g0 + kRound, granules);
    const int r_first = (int)(g0 / kg);
    const int r_last = (int)((g_end - 1) / kg);
    for (int r = r_first + threadIdx.x; r <= r_last; r += kThreads) {
      const long long lo = max((long long)r * kg, g0);
      const long long hi = min((long long)(r + 1) * kg, g_end);
      Acc s = row_acc[r];
      for (long long g = lo; g < hi; ++g) {
        s += part[g - g0];
      }
      row_acc[r] = s;
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    out[r0 + r] = row_acc[r];
  }
}

template <typename V, typename W, typename Acc, int GS>
void launch_tiles(const int32_t* indices, const V* values, const W* w, Acc* out,
                  long long n, int k, int d, cudaStream_t stream) {
  constexpr int kRound = kThreads * kUnroll<GS>;
  const int kg = k / GS;
  const int rows_per_tile = kg == 0 ? kRound : (kg >= kRound ? 1 : kRound / kg);
  const long long blocks = (n + rows_per_tile - 1) / rows_per_tile;
  ell_matvec_kernel<V, W, Acc, GS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indices, values, w, out, n, k, d, rows_per_tile);
}

template <typename V, typename W, typename Acc>
int launch(const void* indices, const void* values, const void* w, void* out,
           long long n, int k, int d, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const V* v = static_cast<const V*>(values);
  const W* ww = static_cast<const W*>(w);
  Acc* o = static_cast<Acc*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a 4-slot granule of values is 32, 16 or 8 bytes: aligned to 16 or 8
  constexpr unsigned kValueAlign = 4 * sizeof(V) < 16 ? 4 * sizeof(V) : 16;
  if (k % 4 == 0 && photon::aligned(ix, 16) && photon::aligned(v, kValueAlign)) {
    launch_tiles<V, W, Acc, 4>(ix, v, ww, o, n, k, d, s);
  } else {
    launch_tiles<V, W, Acc, 1>(ix, v, ww, o, n, k, d, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int photon_ell_matvec_f64(const void* indices, const void* values,
                          const void* w, void* out, long long n, int k, int d,
                          void* stream) {
  return launch<double, double, double>(indices, values, w, out, n, k, d, stream);
}

int photon_ell_matvec_f32(const void* indices, const void* values,
                          const void* w, void* out, long long n, int k, int d,
                          void* stream) {
  return launch<float, float, float>(indices, values, w, out, n, k, d, stream);
}

int photon_ell_matvec_bf16_f32(const void* indices, const void* values,
                               const void* w, void* out, long long n, int k,
                               int d, void* stream) {
  return launch<__nv_bfloat16, float, float>(indices, values, w, out, n, k, d, stream);
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
