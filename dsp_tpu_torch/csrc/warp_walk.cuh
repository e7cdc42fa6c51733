// Pieces shared by the warp walks of csrc/dtw_fused.cu (kernel 4) and
// csrc/spot_subseq.cu (kernel 3): one warp walks a pair in strips of 32
// lanes, each lane owning one vector of the DP's lane side (a query row, a
// stream frame), and at the start of each chunk of 32 steps computes the
// expanded costs of its vector against the next 32 vectors of the other
// side (template frames or rows) into a ring of 64 of them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace walk {

constexpr float BIG = 1e30f;
constexpr int TILE = 32;                // lanes a strip = steps a chunk = vectors a cost block
constexpr int RING = 64;                // cost blocks' vectors a lane keeps: this chunk's and the last
constexpr int QF = 40;                  // features a lane holds in registers at a time
constexpr int G = 8;                    // costs a lane sums side by side
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of staged vectors: whole blocks of QF features, zero filled,
// so the cost loop needs no bound and a row starts on a float4.
__host__ __device__ __forceinline__ int feature_stride(int f_dim) { return round_up(f_dim, QF); }

// Rows first .. first + n - 1 of src ([*, f_dim]) into dst ([n][fs], zero
// past f_dim), taking row min(r, last) for r past last, by the 32 lanes
// `lane` of a warp.  A lane issues the loads of 16 rows before it stores
// them, so its loads' latencies overlap.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int first,
                                           int n, int last, int f_dim, int fs, int lane) {
  constexpr int BATCH = 16;
  for (int f = lane; f < fs; f += 32) {
    for (int r0 = 0; r0 < n; r0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        v[i] = f < f_dim ? __ldg(src + (size_t)min(first + r0 + i, last) * f_dim + f) : 0.f;
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (r0 + i < n) dst[(r0 + i) * fs + f] = v[i];
    }
  }
}

// |x|^2 of a zero-filled row of fs floats (a multiple of 4), in feature
// order.
__device__ __forceinline__ float row_sq(const float* x, int fs) {
  float s = 0.f;
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
  for (int c = 0; c < fs / 4; ++c) {
    const float4 v = x4[c];
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// (|a|^2 + |b|^2) - 2 a.b, rounded as the plain versions (no contraction),
// then sqrtf unless squared.
__device__ __forceinline__ float local_cost(float sqa, float sqb, float cross, int squared) {
  const float sq = fmaxf(__fsub_rn(__fadd_rn(sqa, sqb), __fmul_rn(2.f, cross)), 0.f);
  return squared ? sq : sqrtf(sq);
}

// The ring slot of lane l's cost against other-side vector x.  The XOR
// swizzle keeps a step's reads free of bank conflicts (its 32 lanes read
// vectors x = t0 + s - l: bank l ^ 8 (x & 3), a permutation of the lanes),
// and a cost block's writes too (one vector x, bank l ^ 8 (x & 3)).
__device__ __forceinline__ int tile_at(int x, int l) {
  const int slot = x & (RING - 1);
  return slot * TILE + (l ^ ((slot & 3) << 3));
}

// The lane's costs against other-side vectors x0 .. x0 + n - 1 (n <= 32,
// in groups of G; x0 a multiple of 32), written to the ring.  `v` holds the
// lane's vector (its first QF features; where f_dim > QF the loop loads
// each block of QF from `own`, its row in device memory), `vsq` its |.|^2;
// `other` ([32][fs], other_sq) the other side's vectors from x0 on, read as
// float4 broadcasts: every lane reads the same address.  Each dot product
// runs in feature order.
__device__ __forceinline__ void cost_block(float (&v)[QF], float vsq, const float* __restrict__ own,
                                           int f_dim, const float* __restrict__ other,
                                           const float* __restrict__ other_sq, int x0, int n,
                                           int fs, float* __restrict__ tile, int lane,
                                           int squared) {
  for (int fb = 0; fb < f_dim; fb += QF) {
    if (f_dim > QF) {
#pragma unroll
      for (int f = 0; f < QF; ++f) v[f] = fb + f < f_dim ? own[fb + f] : 0.f;
    }
    const bool last_block = fb + QF >= f_dim;
    for (int g = 0; g < n; g += G) {
      // vectors past n are rows a stage repeated or left: their costs are
      // never used, since a step past the length computes no cell
      float acc[G];
#pragma unroll
      for (int e = 0; e < G; ++e) acc[e] = fb == 0 ? 0.f : tile[tile_at(x0 + g + e, lane)];
      const float4* o4 = reinterpret_cast<const float4*>(other + (size_t)g * fs + fb);
#pragma unroll
      for (int c = 0; c < QF / 4; ++c) {
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const float4 b = o4[e * (fs / 4) + c];
          acc[e] = fmaf(v[4 * c], b.x, acc[e]);
          acc[e] = fmaf(v[4 * c + 1], b.y, acc[e]);
          acc[e] = fmaf(v[4 * c + 2], b.z, acc[e]);
          acc[e] = fmaf(v[4 * c + 3], b.w, acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < G; ++e)
        tile[tile_at(x0 + g + e, lane)] =
            last_block ? local_cost(vsq, other_sq[g + e], acc[e], squared) : acc[e];
    }
  }
}

// The lane's vector in registers (zero past f_dim) where f_dim <= QF, and
// its |.|^2 in feature order either way.
__device__ __forceinline__ float load_own(float (&v)[QF], const float* __restrict__ own,
                                          int f_dim) {
  float sq = 0.f;
  if (f_dim <= QF) {
#pragma unroll
    for (int f = 0; f < QF; ++f) {
      v[f] = f < f_dim ? own[f] : 0.f;
      sq = fmaf(v[f], v[f], sq);
    }
  } else {
    for (int f = 0; f < f_dim; ++f) sq = fmaf(own[f], own[f], sq);
  }
  return sq;
}

}  // namespace walk
