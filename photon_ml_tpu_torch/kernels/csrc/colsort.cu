// The column-sorted reduce (colsort.cuh) on its own: ell_rmatvec's and
// ell_colsum's X^T on a CUDA design (kernels/ell.py), and the reduce's
// entry for the checks that hold it to its plain version
// (kernels/colsort.py::column_reduce). The fused passes launch the same
// kernels from fused.cu, after their row pass.
//
// Each entry point clears the output(s) and launches the tiles and the
// chains on the caller's stream; nothing is allocated here and nothing
// synchronises. It returns the first CUDA error, or cudaGetLastError().

#include "colsort.cuh"

namespace {

template <typename V, typename A, int MODE>
int reduce(const void* cols, const void* rows, const void* vals, const void* chains,
           const void* a, void* out0, void* out1, void* edge, long long ntiles,
           long long nchains, int d, void* stream) {
  const photon::colsort::ReduceArgs<V, A> p{
      static_cast<const int32_t*>(cols), static_cast<const int32_t*>(rows),
      static_cast<const V*>(vals),       static_cast<const int32_t*>(chains),
      static_cast<const A*>(a),          static_cast<A*>(out0),
      static_cast<A*>(out1),             static_cast<double*>(edge),
      ntiles,                            nchains,
      d};
  return photon::colsort::launch_reduce<V, A, MODE>(p, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

#define PHOTON_COLSORT_ENTRY(MODE_NAME, MODE, SUFFIX, V, A)                          \
  int photon_colsort_reduce_##MODE_NAME##_##SUFFIX(                                  \
      const void* cols, const void* rows, const void* vals, const void* chains,      \
      const void* a, void* out0, void* out1, void* edge, long long ntiles,           \
      long long nchains, int d, void* stream) {                                      \
    return reduce<V, A, MODE>(cols, rows, vals, chains, a, out0, out1, edge, ntiles, \
                              nchains, d, stream);                                   \
  }
#define PHOTON_COLSORT_ENTRIES(SUFFIX, V, A)                                  \
  PHOTON_COLSORT_ENTRY(linear, photon::colsort::kLinear, SUFFIX, V, A)        \
  PHOTON_COLSORT_ENTRY(square, photon::colsort::kSquare, SUFFIX, V, A)        \
  PHOTON_COLSORT_ENTRY(pair, photon::colsort::kPair, SUFFIX, V, A)

PHOTON_COLSORT_ENTRIES(f64, double, double)
PHOTON_COLSORT_ENTRIES(f32, float, float)
PHOTON_COLSORT_ENTRIES(bf16_f32, __nv_bfloat16, float)

#undef PHOTON_COLSORT_ENTRIES
#undef PHOTON_COLSORT_ENTRY

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
