// Fused GLM objective passes over a padded-ELL design: one sweep of the
// stored (indices, values) per pass.
//
// Replaces photon_ml_tpu/kernels/fused.py::fused_value_grad_curvature
// (Pallas body _vgc_kernel) and ::fused_hessian_vector (_hvp_kernel):
//
//   vgc: z_i = sum_k v_ik w[c_ik] + off_i
//        val = sum_i ew_i l(z_i, y_i)          asum = sum_i a_i
//        a_i = ew_i l'(z_i, y_i)               grad_j = sum_{c_ik=j} v_ik a_i
//        c_i = ew_i l''(z_i, y_i)
//   hvp: zv_i = sum_k v_ik v[c_ik] + shift     u_i = c_i zv_i
//        hv_j = sum_{c_ik=j} v_ik u_i          usum = sum_i u_i
//
// Same contract as the Pallas kernels: a slot whose column id is >= d (the
// padding id is d; ids compared as unsigned) reads 0 and adds nothing;
// duplicate ids sum; the compute type is result_type(values, w, labels,
// offsets, ew): (f64 values, f64), (f32, f32), (bf16 values, f32). The
// loss is a template parameter covering the four PointwiseLosses of
// photon_ml_tpu/ops/losses.py; logistic's softplus follows the port's
// logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).
//
// Bound on Hopper: HBM bytes. A pass reads the design once,
// n*k*(4 + itemsize(values)), plus the (n,) row vectors and the (d,)
// coefficient vector, and writes the (d,) back-projection and, for vgc,
// the (n,) curvature weights; the gathers and the atomics hit the (d,)
// vectors in the 50 MB L2.
//
// Design (a simple, correct first version): ell_matvec's row mapping —
// GROUP lanes own one row (8 for k <= 8, else 32), stride over its slots
// with coalesced loads, gather w[c], and a __shfl_xor_sync butterfly hands
// the row's margin to every lane of the group, so each lane computes the
// loss terms of its row itself (the same bits on every lane). Each lane
// then re-reads its slots (now L1/L2 hits) and atomicAdds v_ik * a_i into
// the gradient, which the caller zeroes on the same stream. The scalars
// (val, asum; usum) become one partial per block, reduced in a fixed order
// (warp butterfly, then warp 0 over the block's warps), and a second
// single-block launch sums the partials in a fixed order: the value TRON
// compares across trial points does not change from run to run. The
// gradient's atomics do: their order, and so a column's last bits, vary.
// Hot columns (the intercept, the integer fields of the Criteo layout)
// serialise their atomics; that is left for a later redesign. Nothing is
// allocated here; the launches go on the caller's stream and do not
// synchronise. Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Sum of x over the block in a fixed order; the result is valid in thread 0.
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

// Row margin sum_k v_ik t[c_ik] over the group's lanes, on every lane.
template <typename V, typename A, int GROUP>
__device__ __forceinline__ A row_dot(const int32_t* __restrict__ indices,
                                     const V* __restrict__ values,
                                     const A* __restrict__ table, bool live,
                                     long long base, int lane, int k, int d) {
  A acc = A(0);
  if (live) {
    for (int s = lane; s < k; s += GROUP) {
      const int32_t c = indices[base + s];
      const A tc = ((unsigned)c < (unsigned)d) ? table[c] : A(0);
      acc += to_acc(values[base + s]) * tc;
    }
  }
  // every lane of the warp takes part (full mask); xor partners of a group
  // stay inside the group, and addition commutes, so every lane of the
  // group ends with the same bits
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

// Scatter v_ik * scale into out over the lane's slots of the row.
template <typename V, typename A, int GROUP>
__device__ __forceinline__ void row_scatter(const int32_t* __restrict__ indices,
                                            const V* __restrict__ values,
                                            A* __restrict__ out, A scale,
                                            long long base, int lane, int k,
                                            int d) {
  for (int s = lane; s < k; s += GROUP) {
    const int32_t c = indices[base + s];
    if ((unsigned)c < (unsigned)d) {
      atomicAdd(out + c, to_acc(values[base + s]) * scale);
    }
  }
}

template <typename V, typename A, int GROUP, int LOSS>
__global__ void __launch_bounds__(kThreads)
fused_vgc_kernel(const int32_t* __restrict__ indices,
                 const V* __restrict__ values,
                 const A* __restrict__ labels,
                 const A* __restrict__ offsets,
                 const A* __restrict__ ew,
                 const A* __restrict__ w,
                 A* __restrict__ grad,
                 A* __restrict__ curvature,
                 A* __restrict__ partials,
                 long long n, int k, int d) {
  __shared__ A shared[kWarps];
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / GROUP;
  const int lane = (int)(t % GROUP);
  const bool live = row < n;
  const long long base = row * (long long)k;
  A z = row_dot<V, A, GROUP>(indices, values, w, live, base, lane, k, d);
  A val = A(0);
  A asum = A(0);
  if (live) {
    z += offsets[row];
    A l, d1, d2;
    loss_terms<LOSS, A>(z, labels[row], l, d1, d2);
    const A e = ew[row];
    const A a = e * d1;
    if (lane == 0) {
      curvature[row] = e * d2;
      val = e * l;
      asum = a;
    }
    row_scatter<V, A, GROUP>(indices, values, grad, a, base, lane, k, d);
  }
  val = block_sum<A>(val, shared);
  asum = block_sum<A>(asum, shared);
  if (threadIdx.x == 0) {
    partials[2 * (long long)blockIdx.x] = val;
    partials[2 * (long long)blockIdx.x + 1] = asum;
  }
}

template <typename V, typename A, int GROUP>
__global__ void __launch_bounds__(kThreads)
fused_hvp_kernel(const int32_t* __restrict__ indices,
                 const V* __restrict__ values,
                 const A* __restrict__ curvature,
                 const A* __restrict__ shift,
                 const A* __restrict__ v,
                 A* __restrict__ hv,
                 A* __restrict__ partials,
                 long long n, int k, int d) {
  __shared__ A shared[kWarps];
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t / GROUP;
  const int lane = (int)(t % GROUP);
  const bool live = row < n;
  const long long base = row * (long long)k;
  A zv = row_dot<V, A, GROUP>(indices, values, v, live, base, lane, k, d);
  A usum = A(0);
  if (live) {
    zv += *shift;
    const A u = curvature[row] * zv;
    if (lane == 0) {
      usum = u;
    }
    row_scatter<V, A, GROUP>(indices, values, hv, u, base, lane, k, d);
  }
  usum = block_sum<A>(usum, shared);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = usum;
  }
}

// out[j] = sum over blocks b of partials[b * width + j], j < width, in a
// fixed order (one block).
template <typename A>
__global__ void __launch_bounds__(kFinishThreads)
sum_partials_kernel(const A* __restrict__ partials, long long blocks,
                    int width, A* __restrict__ out) {
  __shared__ A shared[kFinishThreads / 32];
  for (int j = 0; j < width; ++j) {
    A acc = A(0);
    for (long long b = threadIdx.x; b < blocks; b += kFinishThreads) {
      acc += partials[b * width + j];
    }
    acc = block_sum<A>(acc, shared);
    if (threadIdx.x == 0) {
      out[j] = acc;
    }
  }
}

long long grid_blocks(long long n, int group) {
  return (n * group + kThreads - 1) / kThreads;
}

template <typename V, typename A, int GROUP>
void launch_vgc_group(const int32_t* ix, const V* vals, const A* y,
                      const A* off, const A* ew, const A* w, A* grad,
                      A* curv, A* partials, long long n, int k, int d,
                      int loss, cudaStream_t s) {
  const unsigned blocks = (unsigned)grid_blocks(n, GROUP);
  switch (loss) {
    case kLogistic:
      fused_vgc_kernel<V, A, GROUP, kLogistic><<<blocks, kThreads, 0, s>>>(
          ix, vals, y, off, ew, w, grad, curv, partials, n, k, d);
      break;
    case kSquared:
      fused_vgc_kernel<V, A, GROUP, kSquared><<<blocks, kThreads, 0, s>>>(
          ix, vals, y, off, ew, w, grad, curv, partials, n, k, d);
      break;
    case kPoisson:
      fused_vgc_kernel<V, A, GROUP, kPoisson><<<blocks, kThreads, 0, s>>>(
          ix, vals, y, off, ew, w, grad, curv, partials, n, k, d);
      break;
    default:
      fused_vgc_kernel<V, A, GROUP, kSmoothedHinge><<<blocks, kThreads, 0, s>>>(
          ix, vals, y, off, ew, w, grad, curv, partials, n, k, d);
      break;
  }
}

template <typename V, typename A>
int launch_vgc(const void* indices, const void* values, const void* labels,
               const void* offsets, const void* ew, const void* w, void* grad,
               void* curvature, void* partials, void* out, long long n, int k,
               int d, int loss, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const V* vals = static_cast<const V*>(values);
  const A* y = static_cast<const A*>(labels);
  const A* off = static_cast<const A*>(offsets);
  const A* e = static_cast<const A*>(ew);
  const A* ww = static_cast<const A*>(w);
  A* g = static_cast<A*>(grad);
  A* c = static_cast<A*>(curvature);
  A* p = static_cast<A*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = k <= 8 ? 8 : 32;
  if (group == 8) {
    launch_vgc_group<V, A, 8>(ix, vals, y, off, e, ww, g, c, p, n, k, d, loss, s);
  } else {
    launch_vgc_group<V, A, 32>(ix, vals, y, off, e, ww, g, c, p, n, k, d, loss, s);
  }
  int code = (int)cudaGetLastError();
  if (code != 0) {
    return code;
  }
  sum_partials_kernel<A><<<1, kFinishThreads, 0, s>>>(
      p, grid_blocks(n, group), 2, static_cast<A*>(out));
  return (int)cudaGetLastError();
}

template <typename V, typename A>
int launch_hvp(const void* indices, const void* values, const void* curvature,
               const void* shift, const void* v, void* hv, void* partials,
               void* out, long long n, int k, int d, void* stream) {
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const V* vals = static_cast<const V*>(values);
  const A* c = static_cast<const A*>(curvature);
  const A* sh = static_cast<const A*>(shift);
  const A* vv = static_cast<const A*>(v);
  A* h = static_cast<A*>(hv);
  A* p = static_cast<A*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = k <= 8 ? 8 : 32;
  const unsigned blocks = (unsigned)grid_blocks(n, group);
  if (group == 8) {
    fused_hvp_kernel<V, A, 8><<<blocks, kThreads, 0, s>>>(ix, vals, c, sh, vv, h, p, n, k, d);
  } else {
    fused_hvp_kernel<V, A, 32><<<blocks, kThreads, 0, s>>>(ix, vals, c, sh, vv, h, p, n, k, d);
  }
  int code = (int)cudaGetLastError();
  if (code != 0) {
    return code;
  }
  sum_partials_kernel<A><<<1, kFinishThreads, 0, s>>>(
      p, (long long)blocks, 1, static_cast<A*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch `partials` holds 2 * photon_fused_blocks(n, k) (vgc) or
// photon_fused_blocks(n, k) (hvp) elements of the compute type
long long photon_fused_blocks(long long n, int k) {
  return grid_blocks(n, k <= 8 ? 8 : 32);
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
  }

PHOTON_FUSED_ENTRIES(f64, double, double)
PHOTON_FUSED_ENTRIES(f32, float, float)
PHOTON_FUSED_ENTRIES(bf16_f32, __nv_bfloat16, float)

#undef PHOTON_FUSED_ENTRIES

const char* photon_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
