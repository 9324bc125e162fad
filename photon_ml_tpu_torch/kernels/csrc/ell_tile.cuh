// Tiles of whole rows of a padded-ELL design, for the kernels that need a
// row's sum: ell_matvec.cu, and the fused objective passes of fused.cu,
// which need it before they can use the row's slots. The granule loads,
// the gathers and the fixed-order row sums.
//
// A tile is a contiguous span of the design, whole rows cut into granules
// of GS slots: GS = 4 when k % 4 == 0 and the bases are aligned for vector
// loads (so a granule never crosses a row), else GS = 1 (k = 1, 5, 17,
// ...). A round of a tile is U granules per thread of a kThreads block,
// held in registers; a row longer than a round spans several. ell_matvec
// holds 4 granules of 4 slots or 8 of 1 per thread; a fused pass 4 slots
// (kRoundSlots = 1024 per round, R = max(1, floor(1024 / k)) rows per
// tile). Each
// thread first issues all the loads of its granules (photon::load_cs:
// 16-byte ids, 32, 16 or 8 bytes of values, under the streaming hint; each
// warp on one contiguous span, so every lane works whatever k is), then
// all their gathers of the (d,) vector through the read-only path, then
// the products: one partial per granule, in slot order, into shared
// memory. After a barrier one thread per row adds its row's partials in
// granule order, from 0. The order of every sum is fixed and depends on
// GS alone, so a row's sum has the same bits from run to run, and in
// ell_matvec and a fused pass alike. Offsets are 64-bit (n*k passes 2^31
// at depth).

#pragma once

#include "ell_common.cuh"

namespace photon {
namespace tile {

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kRoundSlots = kThreads * kSlotsPerThread;

// the fused passes' tiles: whole rows per tile, as many as one round
// holds, at least one; with k = 0 a tile is kRoundSlots rows that have
// only their row terms
__host__ __device__ constexpr int rows_per_tile(int k) {
  return k == 0 ? kRoundSlots : (k >= kRoundSlots ? 1 : kRoundSlots / k);
}

// granules a thread of a fused pass holds in a round, and granules in a
// round
template <int GS>
constexpr int kGranules = kSlotsPerThread / GS;
template <int GS>
constexpr int kRoundGranules = kThreads * kGranules<GS>;

// The thread's granules of the round that starts at granule g0 of a tile
// of `granules` granules (the tile's ids and values start at ids, vals):
// ids into c, values widened to A into v. A granule past the tile reads
// id -1 and value 0. Granule j of the thread is g0 + j * kThreads + tid.
template <int GS, int U, typename V, typename A>
__device__ __forceinline__ void load_round(const int32_t* __restrict__ ids,
                                           const V* __restrict__ vals,
                                           long long g0, long long granules,
                                           int32_t (&c)[U][GS], A (&v)[U][GS]) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const long long g = g0 + j * kThreads + threadIdx.x;
    if (g < granules) {
      load_cs<GS>(ids + g * GS, c[j]);
      load_cs<GS>(vals + g * GS, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < GS; ++e) {
        c[j][e] = -1;
        v[j][e] = A(0);
      }
    }
  }
}

// The gathers t[c] (0 for an id outside [0, d), compared as unsigned) and
// the products: the partial of the thread's granule j, its slots added in
// order, goes to part[j * kThreads + tid].
template <int GS, int U, typename A>
__device__ __forceinline__ void round_partials(const int32_t (&c)[U][GS],
                                               const A (&v)[U][GS],
                                               const A* __restrict__ t, int d,
                                               A* part) {
  A tc[U][GS];
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int e = 0; e < GS; ++e) {
      tc[j][e] = (unsigned)c[j][e] < (unsigned)d ? __ldg(t + c[j][e]) : A(0);
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    A s = v[j][0] * tc[j][0];
#pragma unroll
    for (int e = 1; e < GS; ++e) {
      s += v[j][e] * tc[j][e];
    }
    part[j * kThreads + threadIdx.x] = s;
  }
}

// After a barrier that follows round_partials: each row that meets the
// round of ROUND granules at granule g0 adds its granules' partials to
// row_acc[r], in granule order (kg > 0 granules per row).
template <int ROUND, typename A>
__device__ __forceinline__ void add_row_partials(const A* part, long long g0,
                                                 long long granules, int kg,
                                                 A* row_acc) {
  const long long g_end = min(g0 + ROUND, granules);
  const int r_first = (int)(g0 / kg);
  const int r_last = (int)((g_end - 1) / kg);
  for (int r = r_first + threadIdx.x; r <= r_last; r += kThreads) {
    const long long lo = max((long long)r * kg, g0);
    const long long hi = min((long long)(r + 1) * kg, g_end);
    A s = row_acc[r];
    for (long long g = lo; g < hi; ++g) {
      s += part[g - g0];
    }
    row_acc[r] = s;
  }
}

}  // namespace tile
}  // namespace photon
