// ell_scatter_add: column sums of a padded-ELL update table,
// g_j = sum over slots (i, k) with c_ik = j of upd_ik.
//
// Replaces photon_ml_tpu/kernels/ell.py::ell_scatter_add (Pallas body
// _scatter_kernel), the shared core of ell_rmatvec (upd = v_ik * a_i) and
// ell_colsum (upd = v_ik * c_i or v_ik^2 * c_i); the wrapper forms upd
// outside the kernel, as the JAX package does. Same contract: a slot whose
// column id is >= d (the padding id is d) adds nothing — the ids are
// compared as unsigned, so a negative id adds nothing too; duplicate ids,
// within a row or across rows, sum. Types: upd f64 -> f64, f32 -> f32.
//
// Bound on Hopper: HBM bytes, n*k*(4 + itemsize) of (ids, upd) read once
// and d*itemsize written once, against one add per slot. At d = 2^20 the
// output (8 MiB in f64) stays in the 50 MB L2, where the atomics resolve.
//
// Design (a simple, correct first version): one thread per (row, slot),
// coalesced loads of ids and updates, one atomicAdd into the output, which
// the caller zeroes on the same stream (native f64 atomicAdd exists from
// sm_60). The Pallas kernel's group-total trick for duplicates is not
// needed: atomics sum them. The order of the adds, and so the last bits of
// a column's sum, changes from run to run. Hot columns (in the Criteo
// layout every row writes the intercept and the 13 integer-field columns)
// serialise their atomics; that contention is left for a later redesign
// (privatised per-block accumulators or a column-sorted segment reduce).
// Offsets are 64-bit (n*k passes 2^31 at depth). The launch goes on the
// caller's stream, allocates nothing and does not synchronise; each entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_scatter_add_kernel(const int32_t* __restrict__ indices,
                       const T* __restrict__ upd,
                       T* __restrict__ out,
                       long long slots, int d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < slots) {
    const int32_t c = indices[t];
    if ((unsigned)c < (unsigned)d) {
      atomicAdd(out + c, upd[t]);
    }
  }
}

template <typename T>
int launch(const void* indices, const void* upd, void* out, long long slots,
           int d, void* stream) {
  const long long blocks = (slots + kThreads - 1) / kThreads;
  ell_scatter_add_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indices), static_cast<const T*>(upd),
      static_cast<T*>(out), slots, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int photon_ell_scatter_add_f64(const void* indices, const void* upd, void* out,
                               long long slots, int d, void* stream) {
  return launch<double>(indices, upd, out, slots, d, stream);
}

int photon_ell_scatter_add_f32(const void* indices, const void* upd, void* out,
                               long long slots, int d, void* stream) {
  return launch<float>(indices, upd, out, slots, d, stream);
}

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
