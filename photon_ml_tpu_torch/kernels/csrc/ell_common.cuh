// Shared pieces of the padded-ELL kernels: streaming vector loads of the
// design, and a per-tile combiner that sums updates by column id in shared
// memory before they reach global memory.
//
// The design (ids, values) is read once per pass and is far larger than
// the 50 MB L2, so its loads carry the streaming hint (ld.global.cs, evict
// first): they do not push the (d,) vectors that the gathers and the
// scatters hit out of L2. The (d,) vectors are read through the read-only
// path (__ldg). No L2 access-policy window is set: it would belong to the
// caller's stream and change every later kernel on it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace photon {

__device__ __forceinline__ int32_t to_acc(int32_t v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

// N consecutive elements of T at p, with the streaming hint, widened to A
// in out[0..N). N * sizeof(T) is 2, 4, 8, 16 or 32 bytes, and p is aligned
// to that size (to 16 bytes for 32); 32 bytes are two 16-byte loads.
template <int N, typename T, typename A>
__device__ __forceinline__ void load_cs(const T* __restrict__ p, A* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  T raw[N];
  if constexpr (kBytes == 32) {
    const uint4 lo = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint4 hi = __ldcs(reinterpret_cast<const uint4*>(p) + 1);
    memcpy(raw, &lo, 16);
    memcpy(reinterpret_cast<char*>(raw) + 16, &hi, 16);
  } else if constexpr (kBytes == 16) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(raw, &v, 16);
  } else if constexpr (kBytes == 8) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(raw, &v, 8);
  } else if constexpr (kBytes == 4) {
    const unsigned v = __ldcs(reinterpret_cast<const unsigned*>(p));
    memcpy(raw, &v, 4);
  } else {
    static_assert(kBytes == 2, "load_cs takes 2, 4, 8, 16 or 32 bytes");
    const unsigned short v = __ldcs(reinterpret_cast<const unsigned short*>(p));
    memcpy(raw, &v, 2);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[i] = A(to_acc(raw[i]));
  }
}

// True if p is aligned to `bytes` (a power of two).
__host__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// atomicAdd of an update into one shared-memory value, and into column c
// of the output
template <typename T>
__device__ __forceinline__ void atomic_add(T* p, T u) {
  atomicAdd(p, u);
}
template <typename T>
__device__ __forceinline__ void add_at(T* out, int32_t c, T u) {
  atomicAdd(out + c, u);
}

// An open-addressing table in shared memory that sums one tile's updates by
// column id, so that a column named by many slots of the tile reaches
// global memory once. Capacity is a power of two, at least twice the
// tile's slots, so the table is at most half full. The slot of id c is
// c mod capacity, then the next ones: hashed or vocabulary-ordered ids
// spread over the low bits. Per table slot: the column id (claimed by
// atomicCAS from kEmpty), a flag "named more than once", and a value in
// the update's type T (ell_scatter_add's f64 or f32). Every thread
// of the block goes through four steps, with a barrier between each:
//
//   1. clear();
//   2. h = place(c, owner) for each valid slot: the table slot of id c,
//      claimed by this slot (owner) or by an earlier one (the flag is then
//      set); -1 past kMaxProbes steps, and the caller adds that update
//      straight into the output (a tile whose ids collide, a stride that
//      is a multiple of the capacity, costs what one atomic per slot
//      costs and never stalls);
//   3. add(): an id named once in the tile goes straight to the output
//      with one global atomicAdd; the other slots of a repeated id
//      add into the table's value with shared-memory atomicAdd;
//   4. flush(): the owner of a repeated id adds its own update and the
//      table's value into the output with one global atomicAdd.
//
// So a tile of all-distinct ids pays one shared CAS per slot and its usual
// global atomics, and a column named by many rows of a tile takes one
// global atomic per tile instead of one per slot. The order of the adds
// varies from run to run, and so do a column's last bits: the training
// paths' X^T goes through the column-sorted reduce instead (colsort.cuh).
template <typename T>
struct TileCombiner {
  static constexpr int32_t kEmpty = -1;
  static constexpr int kMaxProbes = 16;

  T* vals;
  int32_t* keys;
  unsigned char* repeated;
  unsigned mask;

  // `smem` (16-byte aligned) holds capacity values of T, capacity int32
  // keys, then capacity one-byte flags
  __device__ __forceinline__ TileCombiner(unsigned char* smem, int capacity)
      : vals(reinterpret_cast<T*>(smem)),
        keys(reinterpret_cast<int32_t*>(smem + (size_t)capacity * sizeof(T))),
        repeated(smem + (size_t)capacity * (sizeof(T) + sizeof(int32_t))),
        mask((unsigned)capacity - 1u) {}

  __host__ __device__ static constexpr size_t bytes(int capacity) {
    return (size_t)capacity * (sizeof(T) + sizeof(int32_t) + 1);
  }

  // the values need no clearing: each owner writes its slot's in place()
  __device__ __forceinline__ void clear() {
    for (unsigned i = threadIdx.x; i <= mask; i += blockDim.x) {
      keys[i] = kEmpty;
    }
    for (unsigned i = threadIdx.x; i <= mask / 4u; i += blockDim.x) {
      reinterpret_cast<uint32_t*>(repeated)[i] = 0u;
    }
  }

  // c must lie in [0, d): the caller drops padding and out-of-range ids
  __device__ __forceinline__ int place(int32_t c, bool& owner) {
    unsigned h = (unsigned)c & mask;
#pragma unroll 1
    for (int p = 0; p < kMaxProbes; ++p) {
      int32_t key = *reinterpret_cast<volatile int32_t*>(keys + h);
      if (key == kEmpty) {
        key = atomicCAS(keys + h, kEmpty, c);
        if (key == kEmpty) {
          owner = true;
          vals[h] = T{};
          return (int)h;
        }
      }
      if (key == c) {
        owner = false;
        repeated[h] = 1;
        return (int)h;
      }
      h = (h + 1u) & mask;
    }
    return -1;
  }

  __device__ __forceinline__ void add(int h, bool owner, int32_t c, T u, T* out) {
    if (!repeated[h]) {
      add_at(out, c, u);
    } else if (!owner) {
      atomic_add(vals + h, u);
    }
  }

  __device__ __forceinline__ void flush(int h, bool owner, int32_t c, T u, T* out) {
    if (owner && repeated[h]) {
      add_at(out, c, vals[h] + u);
    }
  }
};

}  // namespace photon
