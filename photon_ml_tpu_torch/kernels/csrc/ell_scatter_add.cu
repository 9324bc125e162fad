// ell_scatter_add: column sums of a padded-ELL update table,
// g_j = sum over slots (i, k) with c_ik = j of upd_ik.
//
// Replaces photon_ml_tpu/kernels/ell.py::ell_scatter_add (Pallas body
// _scatter_kernel), which takes any per-slot update table (the sparse
// kernel lab's A2 forms upd = v_ik * a_i outside the kernel). On CUDA
// tensors the port's ell_rmatvec and ell_colsum go through the fixed-order
// column-sorted reduce (colsort.cuh) instead. Same contract: a slot whose
// column id is >= d (the padding id is d) adds nothing — the ids are
// compared as unsigned, so a negative id adds nothing too; duplicate ids,
// within a row or across rows, sum. Types: upd f64 -> f64, f32 -> f32.
//
// Bound on Hopper: HBM bytes, n*k*(4 + itemsize) of (ids, upd) read once
// and d*itemsize written once, against one add per slot. What sets the
// pace instead is atomics to one address, which serialise in L2: in the
// Criteo layout the intercept and the 13 integer-field columns are named
// by every row, and a Zipf head category by a fifth of them. The Pallas
// kernel never meets this, since its accumulator stays in VMEM across a
// sequential grid; Hopper's blocks run in no order.
//
// Design: each block takes a tile of kTileSlots consecutive slots (25.6
// rows at k = 40; the contract does not depend on rows), loads its ids and
// updates with coalesced vector loads under the streaming hint (16 bytes
// of updates and 8 or 16 bytes of ids per load, each warp on one
// contiguous span), and combines equal column ids in a shared-memory table
// (photon::TileCombiner, ell_common.cuh): an id named once in the tile
// goes to the output with one global atomicAdd, as before; the slots of a
// repeated id are summed in shared memory first and reach the output with
// one global atomicAdd per tile. A hot column then takes one global atomic
// per tile instead of one per row, and a tile of all-distinct columns pays
// one shared CAS per slot on top of its global atomics. Everything is
// driven by the data: no list of hot columns, no state between calls, no
// pre-pass. The last, partial tile, and bases not aligned for vector
// loads, take scalar loads. The order of the adds, and so the last bits of
// a column's sum, changes from run to run. The output is zeroed by the
// caller on the same stream; nothing is allocated here, the table is the
// block's dynamic shared memory (26 KB in f64), the launch goes on the
// caller's stream and does not synchronise, and each entry point returns
// cudaGetLastError(). Offsets are 64-bit (n*k passes 2^31 at depth).

#include "ell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kTileSlots = kThreads * kSlotsPerThread;
constexpr int kTableSize = 2 * kTileSlots;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_scatter_add_kernel(const int32_t* __restrict__ indices,
                       const T* __restrict__ upd,
                       T* __restrict__ out,
                       long long slots, int d, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  photon::TileCombiner<T> table(smem, kTableSize);
  // slots per vector load: 16 bytes of updates
  constexpr int V = 16 / (int)sizeof(T);
  const long long base = (long long)blockIdx.x * kTileSlots;
  int32_t c[kSlotsPerThread];
  T u[kSlotsPerThread];
  if (vec && base + kTileSlots <= slots) {
#pragma unroll
    for (int j = 0; j < kSlotsPerThread / V; ++j) {
      const long long s = base + (long long)(j * kThreads + threadIdx.x) * V;
      photon::load_cs<V>(indices + s, c + j * V);
      photon::load_cs<V>(upd + s, u + j * V);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSlotsPerThread; ++j) {
      const long long s = base + j * kThreads + threadIdx.x;
      c[j] = s < slots ? __ldcs(indices + s) : -1;
      u[j] = s < slots ? __ldcs(upd + s) : T(0);
    }
  }
  // the loads above are in flight while the table clears
  table.clear();
  __syncthreads();
  int h[kSlotsPerThread];
  bool owner[kSlotsPerThread];
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    h[j] = -1;
    owner[j] = false;
    if ((unsigned)c[j] < (unsigned)d) {
      h[j] = table.place(c[j], owner[j]);
      if (h[j] < 0) {
        atomicAdd(out + c[j], u[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    if (h[j] >= 0) {
      table.add(h[j], owner[j], c[j], u[j], out);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlotsPerThread; ++j) {
    if (h[j] >= 0) {
      table.flush(h[j], owner[j], c[j], u[j], out);
    }
  }
}

template <typename T>
int launch(const void* indices, const void* upd, void* out, long long slots,
           int d, void* stream) {
  constexpr size_t smem = photon::TileCombiner<T>::bytes(kTableSize);
  static_assert(smem <= 48 * 1024, "a table above 48 KB needs cudaFuncSetAttribute");
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = photon::aligned(indices, 4 * V) && photon::aligned(upd, 16);
  const long long blocks = (slots + kTileSlots - 1) / kTileSlots;
  ell_scatter_add_kernel<T><<<(unsigned)blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indices), static_cast<const T*>(upd),
      static_cast<T*>(out), slots, d, vec);
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
