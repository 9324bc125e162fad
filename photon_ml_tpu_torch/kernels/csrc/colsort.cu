// The column-sorted reduce (colsort.cuh) on its own: ell_rmatvec's and
// ell_colsum's X^T on a CUDA design (kernels/ell.py), and the reduce's
// entry for the checks that hold it to its plain version
// (kernels/colsort.py::column_reduce). The fused passes launch the same
// kernels from fused.cu, after their row pass.
//
// Each entry point clears the output(s) and launches each block's tiles and
// chains on the caller's stream; nothing is allocated here and nothing
// synchronises. It returns the first CUDA error, or cudaGetLastError().

#include "colsort.cuh"

namespace {

template <typename V, typename A, int MODE>
int reduce(const void* cols, const void* slots, const void* vals, const void* chains,
           const void* blocks, const void* a, void* out0, void* out1, void* scratch,
           long long nblocks, int k, int d, void* stream) {
  const photon::colsort::Reduce<V, A> r{
      static_cast<const int32_t*>(cols),    static_cast<const int32_t*>(slots),
      static_cast<const V*>(vals),          static_cast<const int32_t*>(chains),
      static_cast<const long long*>(blocks), nblocks,
      static_cast<const A*>(a),             static_cast<A*>(out0),
      static_cast<A*>(out1),                static_cast<double*>(scratch),
      k,                                    d};
  return photon::colsort::launch_reduce<V, A, MODE>(r, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// `blocks` is the copy's block table in host memory (nblocks lines of
// kBlockFields int64); `scratch` holds 2 * ntiles doubles per sum, and 2 *
// d more for kPair over several blocks in f32 (kernels/colsort.py
// reduce_scratch)
#define PHOTON_COLSORT_ENTRY(MODE_NAME, MODE, SUFFIX, V, A)                              \
  int photon_colsort_reduce_##MODE_NAME##_##SUFFIX(                                      \
      const void* cols, const void* slots, const void* vals, const void* chains,         \
      const void* blocks, const void* a, void* out0, void* out1, void* scratch,          \
      long long nblocks, int k, int d, void* stream) {                                   \
    return reduce<V, A, MODE>(cols, slots, vals, chains, blocks, a, out0, out1, scratch, \
                              nblocks, k, d, stream);                                    \
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
