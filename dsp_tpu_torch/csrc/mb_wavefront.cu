// Microbenchmark kernels of the wavefront DTW design, one per Pallas kernel
// of scripts/mb_wavefront.py.  They ask that script's questions on Hopper:
// how fast a minimal-op wavefront DP streams a pre-skewed cost (dp_diet,
// E1), the copy floor under it (dma_fetch, E0), the cost of one dependent
// shift + min + add step (anatomy, E1b, and trivial, the launch baseline),
// and what a batched transpose (E2) and a skew construction (E3) cost.
//
// Replaces, in scripts/mb_wavefront.py:
//   mb_dp_diet    dp_diet / _dp_kernel                (:78)
//   mb_dma_fetch  bench_dma / _dma_kernel             (:125)
//   mb_anatomy    bench_anatomy / _anatomy_kernel     (:194)
//   mb_trivial    bench_anatomy's x * 2 kernel        (:179)
//   mb_transpose  bench_transpose / _tr_kernel        (:216)
//   mb_skew       bench_skew / _skew_kernel           (:256)
// Each computes the function of its Pallas kernel, not its TPU blocking;
// the plain versions are in kernels/mb_wavefront.py.
//
// What bounds them on the H100:
// - dp_diet and dma_fetch: device memory.  Both read every byte of a
//   [P, D, T] f32 cost (6.71 GB at the script's shapes); dp_diet does six
//   operations a cell, far under the fp32 peak.  One warp walks one pair's
//   D diagonals in order with T / 32 cells a lane in registers, reading one
//   diagonal row a step as vector loads (float4 where T % 128 == 0) and
//   prefetching the next row before computing the current one; 12,800
//   warps keep ~64 warps' rows in flight on every SM.  dma_fetch has the
//   same grid, loads and prefetch without the DP, so it is dp_diet's copy
//   floor.
// - anatomy: the latency of its dependent chain.  One warp a row, width/32
//   cells a lane; a roll by one is one __shfl_sync (each lane's last cell
//   to the next lane, lane 31's to lane 0) plus a renaming of registers,
//   and n_rolls rolls are n_rolls dependent shuffles.  clock64() around the
//   step loop gives SM cycles a step with no launch in them.
// - transpose and skew: device memory.  Both go through a 32-wide shared
//   tile so that reads and writes are coalesced.
//
// Every C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a shape it has no instance for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

// CPL consecutive floats at src (CPL * 4 bytes aligned) into v.
template <int CPL>
__device__ __forceinline__ void load_cells(const float* __restrict__ src, float (&v)[CPL]) {
  if constexpr (CPL % 4 == 0) {
    const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < CPL / 4; ++q) {
      const float4 f = __ldg(s + q);
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (CPL % 2 == 0) {
    const float2* s = reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int q = 0; q < CPL / 2; ++q) {
      const float2 f = __ldg(s + q);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) v[c] = __ldg(src + c);
  }
}

// The value of lane - 1's x at every lane, lane 31's at lane 0: with the
// cells of a row laid out lane-major (lane l owns cells l*CPL .. l*CPL +
// CPL - 1), this is the carry of a roll by one with wrap.  One shuffle does
// what __shfl_up_sync plus a __shfl_sync for lane 0's wrap would.
__device__ __forceinline__ float from_left_lane(float x, int lane) {
  return __shfl_sync(FULL, x, (lane + 31) & 31);
}

// E1.  skew [P, D, T], ktarget / la int32 [P] -> out [P]:
//   new_k[i] = skew[p,k,i] + min(prev1[i], prev1[i-1 mod T], prev2[i-1 mod T])
// with prev1 = BIG and prev2 = BIG except prev2[T-1] = 0 (the origin that
// the wrap carries into lane 0 at k = 0), acc = 0 taking new_k at
// k == ktarget[p], and out[p] = acc[la[p] - 1], or 0 if la-1 is outside
// [0, T).  The two mins and the add are exact per cell, so the result has
// the plain version's bits.
template <int CPL>
__global__ void dp_diet_kernel(const float* __restrict__ skew, const int* __restrict__ ktarget,
                               const int* __restrict__ la, float* __restrict__ out,
                               int n_pairs, int d, int t) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n_pairs) return;  // whole warp
  const float* base = skew + (size_t)p * d * t + lane * CPL;
  const int kt = ktarget[p];
  float prev1[CPL], prev2[CPL], acc[CPL], cur[CPL], nxt[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    prev1[c] = BIG;
    prev2[c] = (lane * CPL + c == t - 1) ? 0.f : BIG;
    acc[c] = 0.f;
  }
  load_cells<CPL>(base, cur);
  for (int k = 0; k < d; ++k) {
    // prefetch the next diagonal (the last one again at k = d-1)
    load_cells<CPL>(base + (size_t)min(k + 1, d - 1) * t, nxt);
    const float in1 = from_left_lane(prev1[CPL - 1], lane);
    const float in2 = from_left_lane(prev2[CPL - 1], lane);
    float nw[CPL];
    nw[0] = cur[0] + fminf(prev1[0], fminf(in1, in2));
#pragma unroll
    for (int c = 1; c < CPL; ++c) nw[c] = cur[c] + fminf(prev1[c], fminf(prev1[c - 1], prev2[c - 1]));
    if (k == kt) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] = nw[c];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      prev2[c] = prev1[c];
      prev1[c] = nw[c];
      cur[c] = nxt[c];
    }
  }
  const int row = la[p] - 1;
  const bool inside = row >= 0 && row < t;
  float mine = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (lane * CPL + c == row) mine = acc[c];
  const float r = __shfl_sync(FULL, mine, inside ? row / CPL : 0);
  if (lane == 0) out[p] = inside ? r : 0.f;
}

// E0.  The same warps, rows and prefetch as dp_diet_kernel, every byte of
// skew loaded; out[p] = sum over kb < D/8 of (skew[p, 8kb, 0] + ktarget[p])
// in kb order, as the Pallas kernel's accumulator.  The loads are kept live
// by an XOR of their bits that is stored to sink only if it equals salt.
template <int CPL>
__global__ void dma_fetch_kernel(const float* __restrict__ skew, const int* __restrict__ ktarget,
                                 float* __restrict__ out, unsigned* __restrict__ sink,
                                 unsigned salt, int n_pairs, int d, int t) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n_pairs) return;
  const float* base = skew + (size_t)p * d * t + lane * CPL;
  const float ktf = (float)ktarget[p];
  const int rows = (d / 8) * 8;
  float cur[CPL], nxt[CPL];
  float acc = 0.f;
  unsigned h = 0u;
  load_cells<CPL>(base, cur);
  for (int k = 0; k < d; ++k) {
    load_cells<CPL>(base + (size_t)min(k + 1, d - 1) * t, nxt);
    if ((k & 7) == 0 && k < rows) acc = (acc + cur[0]) + ktf;  // lane 0: skew[p, k, 0]
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      h ^= __float_as_uint(cur[c]);
      cur[c] = nxt[c];
    }
  }
  if (h == salt) sink[0] = h;
  if (lane == 0) out[p] = acc;
}

// E1b.  x [rows, width] -> out: steps times, s = prev1 rolled by one
// NR times, new = min(prev1, s) + prev2 * 0.5, (prev1, prev2) = (new,
// prev1); out = prev1 + prev2.  The product and the sum are rounded apart
// (__fmul_rn, __fadd_rn), as the plain version rounds them.  cycles, if
// not null, gets each row's clock64() count over the step loop.
template <int CPL, int NR>
__global__ void anatomy_kernel(const float* __restrict__ x, float* __restrict__ out,
                               long long* __restrict__ cycles, int rows, int width, int steps) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float prev1[CPL], prev2[CPL];
  load_cells<CPL>(x + (size_t)row * width + lane * CPL, prev1);
#pragma unroll
  for (int c = 0; c < CPL; ++c) prev2[c] = prev1[c];
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    float sh[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) sh[c] = prev1[c];
#pragma unroll
    for (int r = 0; r < NR; ++r) {  // NR dependent shuffles, never one roll by NR
      const float in = from_left_lane(sh[CPL - 1], lane);
#pragma unroll
      for (int c = CPL - 1; c > 0; --c) sh[c] = sh[c - 1];
      sh[0] = in;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const float nw = __fadd_rn(fminf(prev1[c], sh[c]), __fmul_rn(prev2[c], 0.5f));
      prev2[c] = prev1[c];
      prev1[c] = nw;
    }
  }
  const long long t1 = clock64();
  float* o = out + (size_t)row * width + lane * CPL;
#pragma unroll
  for (int c = 0; c < CPL; ++c) o[c] = prev1[c] + prev2[c];
  if (cycles != nullptr && lane == 0) cycles[row] = t1 - t0;
}

// E1b's launch baseline: out = 2x.
__global__ void trivial_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = x[i] * 2.0f;
}

// E2.  x [P, R, C] -> out [P, C, R], one 32 x 32 tile a block through a
// 32 x 33 shared tile (the odd stride keeps the column reads free of bank
// conflicts); blockDim = (32, block_rows), each thread moves 32/block_rows
// cells each way.
__global__ void transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int r, int c, int tiles_r, int tiles_c) {
  __shared__ float tile[32][33];
  size_t b = blockIdx.x;
  const int tc = (int)(b % tiles_c);
  b /= tiles_c;
  const int tr = (int)(b % tiles_r);
  const size_t q = b / tiles_r;
  const float* src = x + q * r * c;
  float* dst = out + q * r * c;
  const int r0 = tr * 32, c0 = tc * 32;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int rr = r0 + i, cc = c0 + tx;
    if (rr < r && cc < c) tile[i][tx] = src[(size_t)rr * c + cc];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int cc = c0 + i, rr = r0 + tx;
    if (cc < c && rr < r) dst[(size_t)cc * r + rr] = tile[tx][i];
  }
}

// E3.  cost [Q, T, U] -> out [Q, D, T], out[q, d, i] = cost[q, i, d - i]
// where 0 <= d - i < U, else BIG.  A block writes the 32 diagonals x 32
// rows tile at (d0, i0); it needs cost rows i0 .. i0+31 at columns
// j0 = d0 - i0 - 31 .. j0 + 62, which it stages into s (BIG outside
// [0, U)) with coalesced row reads, then writes out[q, d0 + a, i0 + l] =
// s[l][a - l + 31] coalesced along l.  The row stride of 64 makes both
// phases conflict-free: staging, lane l writes bank l; writing, lane l
// reads bank (a + 31 - l) mod 32.  Tiles with no cell inside [0, U) skip
// the staging and write BIG.
__global__ void skew_kernel(const float* __restrict__ cost, float* __restrict__ out,
                            int t, int u, int d, int tiles_i, int tiles_d) {
  __shared__ float s[32][64];
  size_t b = blockIdx.x;
  const int ti = (int)(b % tiles_i);
  b /= tiles_i;
  const int td = (int)(b % tiles_d);
  const size_t q = b / tiles_d;
  const float* src = cost + q * t * u;
  float* dst = out + q * d * t;
  const int i0 = ti * 32, d0 = td * 32;
  const int j0 = d0 - i0 - 31;
  const int tx = threadIdx.x;
  const bool any = j0 + 62 >= 0 && j0 < u;  // block-uniform
  if (any) {
    for (int rr = threadIdx.y; rr < 32; rr += blockDim.y) {
      const int i = i0 + rr;
      for (int cc = tx; cc < 63; cc += 32) {
        const int j = j0 + cc;
        s[rr][cc] = (i < t && j >= 0 && j < u) ? src[(size_t)i * u + j] : BIG;
      }
    }
  }
  __syncthreads();
  for (int a = threadIdx.y; a < 32; a += blockDim.y) {
    const int dd = d0 + a, i = i0 + tx;
    if (dd < d && i < t) dst[(size_t)dd * t + i] = any ? s[tx][a - tx + 31] : BIG;
  }
}

}  // namespace

#define MB_CPL_CASES(T, LAUNCH) \
  switch (T) {                  \
    case 32: LAUNCH(1); break;  \
    case 64: LAUNCH(2); break;  \
    case 128: LAUNCH(4); break; \
    case 256: LAUNCH(8); break; \
    case 512: LAUNCH(16); break; \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int mb_dp_diet(const void* skew, const void* ktarget, const void* la, void* out,
                          int n_pairs, int d, int t, int warps, void* stream) {
  const dim3 grid((n_pairs + warps - 1) / warps), block(32 * warps);
#define LAUNCH(CPL)                                                                   \
  dp_diet_kernel<CPL><<<grid, block, 0, (cudaStream_t)stream>>>(                      \
      (const float*)skew, (const int*)ktarget, (const int*)la, (float*)out, n_pairs, d, t)
  MB_CPL_CASES(t, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int mb_dma_fetch(const void* skew, const void* ktarget, void* out, void* sink,
                            unsigned salt, int n_pairs, int d, int t, int warps, void* stream) {
  const dim3 grid((n_pairs + warps - 1) / warps), block(32 * warps);
#define LAUNCH(CPL)                                                                \
  dma_fetch_kernel<CPL><<<grid, block, 0, (cudaStream_t)stream>>>(                 \
      (const float*)skew, (const int*)ktarget, (float*)out, (unsigned*)sink, salt, \
      n_pairs, d, t)
  MB_CPL_CASES(t, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

template <int CPL>
static int anatomy_launch(const void* x, void* out, void* cycles, int rows, int width,
                          int n_rolls, int steps, int warps, cudaStream_t stream) {
  const dim3 grid((rows + warps - 1) / warps), block(32 * warps);
  const float* xi = (const float*)x;
  float* o = (float*)out;
  long long* cyc = (long long*)cycles;
  switch (n_rolls) {
    case 0: anatomy_kernel<CPL, 0><<<grid, block, 0, stream>>>(xi, o, cyc, rows, width, steps); break;
    case 1: anatomy_kernel<CPL, 1><<<grid, block, 0, stream>>>(xi, o, cyc, rows, width, steps); break;
    case 2: anatomy_kernel<CPL, 2><<<grid, block, 0, stream>>>(xi, o, cyc, rows, width, steps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mb_anatomy(const void* x, void* out, void* cycles, int rows, int width,
                          int n_rolls, int steps, int warps, void* stream) {
#define LAUNCH(CPL) \
  return anatomy_launch<CPL>(x, out, cycles, rows, width, n_rolls, steps, warps, (cudaStream_t)stream)
  MB_CPL_CASES(width, LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached: every case returns
}

extern "C" int mb_trivial(const void* x, void* out, int n, void* stream) {
  const int block = 256;
  const int grid = (n + block - 1) / block < 1024 ? (n + block - 1) / block : 1024;
  trivial_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int mb_transpose(const void* x, void* out, int p, int r, int c, int block_rows,
                            void* stream) {
  const int tiles_r = (r + 31) / 32, tiles_c = (c + 31) / 32;
  const dim3 grid((unsigned)((size_t)p * tiles_r * tiles_c)), block(32, block_rows);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, r, c,
                                                             tiles_r, tiles_c);
  return (int)cudaGetLastError();
}

extern "C" int mb_skew(const void* cost, void* out, int q, int t, int u, int d, int block_rows,
                       void* stream) {
  const int tiles_i = (t + 31) / 32, tiles_d = (d + 31) / 32;
  const dim3 grid((unsigned)((size_t)q * tiles_i * tiles_d)), block(32, block_rows);
  skew_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const float*)cost, (float*)out, t, u, d,
                                                        tiles_i, tiles_d);
  return (int)cudaGetLastError();
}
