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
// are L2 hits and only the streamed (indices, values) go to HBM.
//
// Design (a simple, correct first version): GROUP lanes own one row, with
// GROUP the smallest power of two >= k, at most 32 — one warp per row for
// k > 16, 32/GROUP rows per warp below. Lanes stride over the row's slots,
// so the loads of indices and values along the row are coalesced, each
// lane gathers its w[c], and a __shfl_xor_sync butterfly within the group
// finishes the row. Row offsets are 64-bit (n*k passes 2^31 at depth).
// Nothing is staged in shared memory and nothing is allocated here; the
// launch goes on the caller's stream and does not synchronise. Each entry
// point returns cudaGetLastError() so the caller can raise on a refused
// launch. Left for later: 16-byte vector loads, cp.async staging and an L2
// persistence window for w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename V, typename W, typename Acc, int GROUP>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const int32_t* __restrict__ indices,
                  const V* __restrict__ values,
                  const W* __restrict__ w,
                  Acc* __restrict__ out,
                  long long n, int k, int d) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / GROUP;
  const int lane = (int)(t % GROUP);
  Acc acc = Acc(0);
  if (row < n) {
    const long long base = row * (long long)k;
    for (int s = lane; s < k; s += GROUP) {
      const int32_t c = indices[base + s];
      const Acc wc = ((unsigned)c < (unsigned)d) ? Acc(w[c]) : Acc(0);
      acc += to_acc(values[base + s]) * wc;
    }
  }
  // every lane of the warp takes part in the butterfly (full mask); the
  // xor partners of a group stay inside the group
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < n && lane == 0) {
    out[row] = acc;
  }
}

template <typename V, typename W, typename Acc, int GROUP>
void launch_group(const int32_t* indices, const V* values, const W* w,
                  Acc* out, long long n, int k, int d, cudaStream_t stream) {
  const long long threads = n * GROUP;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  ell_matvec_kernel<V, W, Acc, GROUP>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(indices, values, w, out, n, k, d);
}

template <typename V, typename W, typename Acc>
int launch(const void* indices, const void* values, const void* w, void* out,
           long long n, int k, int d, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const V* v = static_cast<const V*>(values);
  const W* ww = static_cast<const W*>(w);
  Acc* o = static_cast<Acc*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) {
    launch_group<V, W, Acc, 1>(ix, v, ww, o, n, k, d, s);
  } else if (k <= 2) {
    launch_group<V, W, Acc, 2>(ix, v, ww, o, n, k, d, s);
  } else if (k <= 4) {
    launch_group<V, W, Acc, 4>(ix, v, ww, o, n, k, d, s);
  } else if (k <= 8) {
    launch_group<V, W, Acc, 8>(ix, v, ww, o, n, k, d, s);
  } else if (k <= 16) {
    launch_group<V, W, Acc, 16>(ix, v, ww, o, n, k, d, s);
  } else {
    launch_group<V, W, Acc, 32>(ix, v, ww, o, n, k, d, s);
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
